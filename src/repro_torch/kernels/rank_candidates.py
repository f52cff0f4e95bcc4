"""CUDA launch of the ``rank_dots`` kernel (``csrc/rank_dots.cu``).

Replaces the JAX package's Pallas TPU kernel ``rank_dots_pallas``
(``src/repro/kernels/rank_candidates.py``): the inner products of each
query with its own pre-gathered candidate block, streamed a row to a
group of lanes with every load of the row issued before its first
multiply.  The plain version is :func:`repro_torch.kernels.ref.ref_rank_dots`;
callers go through :func:`repro_torch.kernels.ops.rank_dots` (and
``ops.pairwise_rank``, which the comparators use).
"""
from __future__ import annotations

import torch

from . import _build

_MAX_DIM = 12288                 # the widest d the card tests hold
_TILE = 512                      # candidates of one query a block
_MAX_BLOCKS = 2**31 - 1          # the 1-D grid walks every tile


def rank_dots_cuda(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) f32 x (Q, C, d) f32, contiguous on one CUDA device ->
    (Q, C) f32 inner products."""
    if not (q.is_cuda and x.device == q.device):
        raise ValueError("rank_dots_cuda needs q and x on one CUDA device")
    if q.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("rank_dots_cuda takes float32 inputs")
    if not (q.is_contiguous() and x.is_contiguous()):
        raise ValueError("rank_dots_cuda takes contiguous inputs")
    if (q.dim() != 2 or x.dim() != 3 or x.shape[0] != q.shape[0]
            or x.shape[2] != q.shape[1]):
        raise ValueError(f"bad shapes q{tuple(q.shape)} x{tuple(x.shape)}")
    nq, c, d = x.shape
    if d > _MAX_DIM or c >= 2**31 or nq * -(-c // _TILE) > _MAX_BLOCKS:
        raise ValueError(f"rank_dots_cuda takes d <= {_MAX_DIM} and Q, C "
                         "within its grid")
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    if nq and c:
        fn = _build.load("rank_dots")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(fn(q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, c, d,
                        stream), "rank_dots")
        _build.LAUNCHES["rank_dots"] += 1
    return out
