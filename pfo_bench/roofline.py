"""The least time of a kernel call on one NVIDIA H100 SXM, from the
operations and bytes its inputs need.

Peaks (NVIDIA's data sheet, dense, at the 700 W power limit): 3.35 TB/s
of HBM3, and 495 TFLOP/s of TF32, of which an fp32-accurate product
(3xTF32: three TF32 products for one fp32 one) gets a third.  Every
kernel's operations are held to that one fp32-accurate peak, whatever it
uses inside, so a kernel reads the same work whatever implements it.
Bytes count each input byte once and each output byte once.
"""
from __future__ import annotations

PEAK_BYTES = 3.35e12             # bytes/s
PEAK_TF32 = 495e12               # FLOP/s
PEAK_FP32 = PEAK_TF32 / 3        # fp32-accurate, on the tensor cores


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over the
    fp32-accurate peak, in ms, and which of the two it is."""
    tb = n_bytes / PEAK_BYTES * 1e3
    tf = flops / PEAK_FP32 * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def lsh_hash_work(n: int, d: int, p: int) -> tuple[float, float]:
    """(bytes, flops) of ``ops.lsh_hash``: (n, d) rows against a (d, p)
    projection, packed into n x p/32 int64 keys."""
    return 4.0 * (n * d + d * p) + 8.0 * n * (p // 32), 2.0 * n * d * p


def gather_rank_work(q: int, c: int, d: int, rows: int,
                     valid: int) -> tuple[float, float]:
    """(bytes, flops) of ``ops.gather_rank``: q queries of width d, c
    candidate slots each (int32 slot, bool valid, f32 distance out), of
    which ``valid`` are ranked, naming ``rows`` distinct store rows."""
    return (4.0 * (q * d + rows * d) + q * c * (4 + 1 + 4),
            2.0 * valid * d)
