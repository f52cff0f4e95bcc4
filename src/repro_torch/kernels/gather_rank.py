"""CUDA launch of the ``gather_rank`` kernel (``csrc/gather_rank.cu``).

Replaces the JAX package's Pallas TPU kernel ``gather_rank_pallas``
(``src/repro/kernels/gather_rank.py``): candidate vectors are gathered
from the store by slot id inside the kernel and ranked against their
query, so no (Q, C, d) block is materialised.  The plain version is
:func:`repro_torch.kernels.ref.ref_gather_rank`; callers go through
:func:`repro_torch.kernels.ops.gather_rank`, which normalises angular
queries first.
"""
from __future__ import annotations

import torch

from . import _build

_MAX_DIM = 48 * 1024 // 4        # the query row lives in static-size smem


def gather_rank_cuda(q: torch.Tensor, store: torch.Tensor,
                     slots: torch.Tensor, valid: torch.Tensor,
                     angular: bool) -> torch.Tensor:
    """(Q, d) f32, (N, d) f32, (Q, C) int32, (Q, C) bool, all on one CUDA
    device -> (Q, C) f32 distances, +inf where invalid.  Angular queries
    must already be unit-normalised."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (store, slots, valid))):
        raise ValueError("gather_rank_cuda needs all inputs on one CUDA "
                         "device")
    if (q.dtype != torch.float32 or store.dtype != torch.float32
            or slots.dtype != torch.int32 or valid.dtype != torch.bool):
        raise TypeError("gather_rank_cuda takes f32 q/store, int32 slots, "
                        "bool valid")
    if not all(t.is_contiguous() for t in (q, store, slots, valid)):
        raise ValueError("gather_rank_cuda takes contiguous inputs")
    nq, d = q.shape
    n_rows, d2 = store.shape
    if d != d2 or slots.shape != valid.shape or slots.shape[0] != nq:
        raise ValueError("bad shapes")
    if n_rows == 0 or d > _MAX_DIM:
        raise ValueError(f"gather_rank_cuda takes 1..N rows, d <= {_MAX_DIM}")
    c = slots.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=dev)
    if nq and c:
        fn = _build.load("gather_rank")
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(fn(q.data_ptr(), store.data_ptr(), slots.data_ptr(),
                        valid.data_ptr(), out.data_ptr(), nq, n_rows, c, d,
                        int(angular), stream), "gather_rank")
        _build.LAUNCHES["gather_rank"] += 1
    return out
