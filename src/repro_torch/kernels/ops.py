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
from .hamming import hamming_cuda
from .lsh_hash import lsh_hash_cuda
from .pair_dist import pair_dist_cuda
from .rank_candidates import rank_dots_cuda

__all__ = ["lsh_hash", "rank_dots", "pair_dist_sq", "hamming", "gather_rank",
           "gather_rank_topk", "pairwise_rank", "brute_force_topk",
           "LAUNCHES", "reset_launches"]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


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


def rank_dots(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (Q, C, d) -> (Q, C) inner products."""
    if q.device.type == "cpu":
        return ref.ref_rank_dots(q, x)
    return rank_dots_cuda(q.float().contiguous(), x.float().contiguous())


def pair_dist_sq(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) squared L2 distances."""
    if q.device.type == "cpu":
        return ref.ref_pair_dist(q, x)
    return pair_dist_cuda(q.float().contiguous(), x.float().contiguous())


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) keys in [0, 2^32) (int64) -> (Q, N) int32 bit
    differences."""
    if a.device.type == "cpu":
        return ref.ref_hamming(a, b)
    return hamming_cuda(a, b)


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
        q = _unit(q)
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


# ----------------------------------------------------------------------
# exact re-rank over materialised candidates, and the brute-force oracle
# ----------------------------------------------------------------------
def pairwise_rank(q: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """Exact re-rank distances: (Q, d), (Q, C, d), (Q, C) -> (Q, C) f32,
    +inf where invalid (through :func:`rank_dots`)."""
    q, cand = q.float(), cand.float()
    if metric == "angular":
        d = 1.0 - rank_dots(_unit(q), _unit(cand))
    else:
        dots = rank_dots(q, cand)
        qs = (q * q).sum(-1)[:, None]
        xs = (cand * cand).sum(-1)
        d = (qs + xs - 2.0 * dots).clamp_min(0.0)
    return torch.where(valid.bool(), d, torch.full_like(d, float("inf")))


def brute_force_topk(q: torch.Tensor, x: torch.Tensor, k: int, metric: str,
                     valid: torch.Tensor | None = None):
    """Oracle kNN over the whole store: (Q, d), (N, d) -> idx, dists
    (Q, k).  Angular distance is ``0.5 * |qn - xn|^2`` of the unit
    vectors (through :func:`pair_dist_sq`); ``valid`` (N,) masks rows.
    The top-k is ``torch.topk``, outside the kernel."""
    q, x = q.float(), x.float()
    if metric == "angular":
        d = 0.5 * pair_dist_sq(_unit(q), _unit(x))
    else:
        d = pair_dist_sq(q, x)
    if valid is not None:
        d = torch.where(valid.bool()[None, :], d,
                        torch.full_like(d, float("inf")))
    neg, idx = torch.topk(-d, k, dim=1)
    return idx, -neg
