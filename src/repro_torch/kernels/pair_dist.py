"""CUDA launch of the ``pair_dist`` kernel (``csrc/pair_dist.cu``).

Replaces the JAX package's Pallas TPU kernel ``pair_dist_pallas``
(``src/repro/kernels/pair_dist.py``): the all-pairs squared-L2 matrix
of the brute-force oracle, a 3xTF32 tensor-core product (fp32-accurate)
that sums the norms itself and fuses them into its epilogue, so a call is
one launch and nothing else.  Ragged Q, N and d are masked in the kernel,
not padded.  The output's rows are padded to a multiple of 4 floats, so
the kernel writes only aligned 16-byte runs; the result is the (Q, N)
view of that buffer (contiguous where N % 4 == 0).  The plain version is
:func:`repro_torch.kernels.ref.ref_pair_dist`; callers go through
:func:`repro_torch.kernels.ops.pair_dist_sq`.
"""
from __future__ import annotations

import torch

from . import _build

_TILE = 128                      # queries and items of a block's tile
_MAX_TILES = 2**31 - 1           # the 1-D grid walks every tile


def pair_dist_cuda(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) f32 x (N, d) f32, both contiguous on one CUDA device ->
    (Q, N) f32 ``max(|q|^2 + |x|^2 - 2 q.x, 0)``, with rows ``-(-N // 4)
    * 4`` floats apart."""
    if not (q.is_cuda and x.device == q.device):
        raise ValueError("pair_dist_cuda needs q and x on one CUDA device")
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("pair_dist_cuda takes float32 inputs")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("pair_dist_cuda takes contiguous inputs")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"bad shapes q{tuple(q.shape)} x{tuple(x.shape)}")
    nq, d = q.shape
    n = x.shape[0]
    ld = -(-n // 4) * 4
    if (ld >= 2**31 or d >= 2**31
            or -(-nq // _TILE) * -(-n // _TILE) > _MAX_TILES):
        raise ValueError("pair_dist_cuda: Q or N past the kernel's grid")
    out = torch.empty((nq, ld), dtype=torch.float32, device=q.device)
    if nq and n:
        fn = _build.load("pair_dist")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, n, ld,
                        d, stream), "pair_dist")
        _build.LAUNCHES["pair_dist"] += 1
    return out[:, :n]
