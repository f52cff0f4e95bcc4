"""CUDA launch of the ``hamming`` kernel (``csrc/hamming.cu``).

Replaces the JAX package's Pallas TPU kernel ``hamming_pallas``
(``src/repro/kernels/hamming.py``): bit differences between packed
compound keys, XOR + ``__popc`` in shared-memory tiles, so the (Q, N, W)
XOR is never built.  The port carries keys as int64 in [0, 2^32) (as
``lsh_hash`` returns them); the kernel reads their 32-bit patterns.
The plain version is :func:`repro_torch.kernels.ref.ref_hamming`;
callers go through :func:`repro_torch.kernels.ops.hamming`.
"""
from __future__ import annotations

import torch

from . import _build

_MAX_WORDS = 48 * 1024 // (4 * (32 + 257))   # both key tiles in 48 KB smem
_MAX_GRID_Y = 65535 * 32                     # 32 query keys a block row


def _as_u32_bits(keys: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) -> int32 tensors with the same 32 bits."""
    if bool(((keys < 0) | (keys > 0xFFFFFFFF)).any()):
        raise ValueError("hamming_cuda takes keys in [0, 2^32)")
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(
        torch.int32).contiguous()


def hamming_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) integer keys in [0, 2^32) on one CUDA device ->
    (Q, N) int32 total bit differences."""
    if not (a.is_cuda and b.device == a.device):
        raise ValueError("hamming_cuda needs a and b on one CUDA device")
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError("hamming_cuda takes int64 keys (values < 2^32)")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"bad shapes a{tuple(a.shape)} b{tuple(b.shape)}")
    nq, w = a.shape
    n = b.shape[0]
    if not 1 <= w <= _MAX_WORDS or nq > _MAX_GRID_Y or n >= 2**31:
        raise ValueError(f"hamming_cuda takes 1 <= W <= {_MAX_WORDS} and "
                         "Q, N within its grid")
    out = torch.empty((nq, n), dtype=torch.int32, device=a.device)
    if nq and n:
        a32, b32 = _as_u32_bits(a), _as_u32_bits(b)
        fn = _build.load("hamming")
        stream = torch.cuda.current_stream(a.device).cuda_stream
        _build.check(fn(a32.data_ptr(), b32.data_ptr(), out.data_ptr(), nq, n,
                        w, stream), "hamming")
        _build.LAUNCHES["hamming"] += 1
    return out
