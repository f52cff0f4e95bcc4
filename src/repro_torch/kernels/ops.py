"""Public wrappers around the port's kernels.

Each wrapper chooses by where its tensors lie, and by nothing else: a
CPU tensor goes to the plain version in :mod:`.ref`; a CUDA tensor goes
to the hand-written kernel, or the call raises.  There is no fallback
from a CUDA tensor to the plain version.  Launches are counted in
:data:`LAUNCHES` (see :func:`reset_launches`).
"""
from __future__ import annotations

import torch

from . import ref
from ._build import LAUNCHES
from .gather_rank import gather_rank_cuda, gather_rank_staged_cuda
from .lsh_hash import lsh_hash_cuda

__all__ = ["lsh_hash", "gather_rank", "gather_rank_topk", "LAUNCHES",
           "reset_launches"]


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def lsh_hash(x: torch.Tensor, table_proj: torch.Tensor,
             M: int = 32) -> torch.Tensor:
    """(N, d) -> (N, L) int64 compound keys in [0, 2^32) (L = P // M)."""
    p = table_proj.shape[1]
    if p % M or M != 32:
        raise ValueError("lsh_hash packs 32-bit keys: P % 32 == 0, M == 32")
    if x.device.type == "cpu":
        return ref.ref_lsh_hash(x, table_proj)
    return lsh_hash_cuda(x.float().contiguous(),
                         table_proj.float().contiguous())


def gather_rank(q: torch.Tensor, store: torch.Tensor, slots: torch.Tensor,
                valid: torch.Tensor, metric: str,
                staging: torch.Tensor | None = None) -> torch.Tensor:
    """Fused candidate gather + exact re-rank distances.

    (Q, d), (N, d) store, (Q, C) int slot ids, (Q, C) bool -> (Q, C) f32
    distances, +inf where invalid.  Slots are clipped to the store.
    ``staging`` (M, d) is the cold tier's arena: slots ``>= N`` read row
    ``clip(slot - N, 0, M - 1)`` (the ``gather_rank_staged`` kernel).
    """
    if q.device.type == "cpu":
        return ref.ref_gather_rank(q, store, slots, valid, metric,
                                   staging=staging)
    q = q.float()
    if metric == "angular":
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-9)
    args = (q.contiguous(), store.float().contiguous())
    rest = (slots.to(torch.int32).contiguous(), valid.bool().contiguous())
    if staging is None:
        return gather_rank_cuda(*args, *rest, angular=(metric == "angular"))
    return gather_rank_staged_cuda(*args, staging.float().contiguous(), *rest,
                                   angular=(metric == "angular"))


def gather_rank_topk(q: torch.Tensor, store: torch.Tensor,
                     slots: torch.Tensor, valid: torch.Tensor, k: int,
                     metric: str, staging: torch.Tensor | None = None):
    """Gather by slot id, distance, masked top-k.  Returns (idx (Q, k)
    into the candidate axis, dists (Q, k) with +inf past the valid set).
    The top-k is ``torch.topk``, outside the kernel, as the JAX package
    keeps ``lax.top_k`` outside its Pallas kernel."""
    d = gather_rank(q, store, slots, valid, metric, staging=staging)
    neg, idx = torch.topk(-d, k, dim=1)
    return idx, -neg
