"""CUDA launches of the ``gather_rank`` and ``gather_rank_staged``
kernels (``csrc/gather_rank.cu``).

They replace the JAX package's Pallas TPU kernels ``gather_rank_pallas``
and ``gather_rank_staged_pallas`` (``src/repro/kernels/gather_rank.py``):
candidate vectors are gathered by slot id inside the kernel and ranked
against their query, so no (Q, C, d) block is materialised.  A block
compacts one query's valid candidates first, then gives each row a group
of lanes that keeps several rows' loads in flight.  The staged kernel
reads slots past the store from the cold tier's staging arena, through
the same per-row code, so both rank a row bit-identically.  The plain
version is :func:`repro_torch.kernels.ref.ref_gather_rank`;
callers go through :func:`repro_torch.kernels.ops.gather_rank`, which
normalises angular queries first.
"""
from __future__ import annotations

import torch

from . import _build

_MAX_DIM = 48 * 1024 // 4        # the query row lives in shared memory


def _check(name: str, q: torch.Tensor, arenas: tuple, slots: torch.Tensor,
           valid: torch.Tensor) -> None:
    """The input checks both kernels share: one CUDA device, f32
    queries and arenas, int32 slots, bool valid, contiguous, matching
    shapes, non-empty arenas, d within the kernel's shared memory."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev
                              for t in (*arenas, slots, valid))):
        raise ValueError(f"{name} needs all inputs on one CUDA device")
    if (q.dtype != torch.float32
            or any(t.dtype != torch.float32 for t in arenas)
            or slots.dtype != torch.int32 or valid.dtype != torch.bool):
        raise TypeError(f"{name} takes f32 q/arenas, int32 slots, bool "
                        "valid")
    if not all(t.is_contiguous() for t in (q, *arenas, slots, valid)):
        raise ValueError(f"{name} takes contiguous inputs")
    nq, d = q.shape
    if (any(t.dim() != 2 or t.shape[1] != d for t in arenas)
            or slots.shape != valid.shape or slots.shape[0] != nq):
        raise ValueError("bad shapes")
    if any(t.shape[0] == 0 for t in arenas) or d > _MAX_DIM:
        raise ValueError(f"{name} takes arenas of >= 1 row, d <= {_MAX_DIM}")
    if any(t.shape[0] >= 2**31 for t in arenas):
        raise ValueError(f"{name} takes arenas of < 2^31 rows")


def gather_rank_cuda(q: torch.Tensor, store: torch.Tensor,
                     slots: torch.Tensor, valid: torch.Tensor,
                     angular: bool) -> torch.Tensor:
    """(Q, d) f32, (N, d) f32, (Q, C) int32, (Q, C) bool, all on one CUDA
    device -> (Q, C) f32 distances, +inf where invalid.  Angular queries
    must already be unit-normalised."""
    _check("gather_rank_cuda", q, (store,), slots, valid)
    nq, d = q.shape
    c = slots.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    if nq and c:
        fn = _build.load("gather_rank")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(fn(q.data_ptr(), store.data_ptr(), slots.data_ptr(),
                        valid.data_ptr(), out.data_ptr(), nq, store.shape[0],
                        c, d, int(angular), stream), "gather_rank")
        _build.LAUNCHES["gather_rank"] += 1
    return out


def gather_rank_staged_cuda(q: torch.Tensor, store: torch.Tensor,
                            staging: torch.Tensor, slots: torch.Tensor,
                            valid: torch.Tensor,
                            angular: bool) -> torch.Tensor:
    """:func:`gather_rank_cuda` over the tiered store: slots ``>= N``
    read row ``clip(slot - N, 0, M - 1)`` of the (M, d) f32 ``staging``
    arena.  -> (Q, C) f32 distances, +inf where invalid."""
    _check("gather_rank_staged_cuda", q, (store, staging), slots, valid)
    nq, d = q.shape
    c = slots.shape[1]
    out = torch.empty((nq, c), dtype=torch.float32, device=q.device)
    if nq and c:
        fn = _build.load("gather_rank_staged")
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(fn(q.data_ptr(), store.data_ptr(), staging.data_ptr(),
                        slots.data_ptr(), valid.data_ptr(), out.data_ptr(),
                        nq, store.shape[0], staging.shape[0], c, d,
                        int(angular), stream), "gather_rank_staged")
        _build.LAUNCHES["gather_rank_staged"] += 1
    return out
