"""Dense vector store — the MainTable's Data segment (paper §3.2.1).

A pre-allocated (capacity, d) tensor plus a free-list stack:
allocation pops the stack, reclamation pushes it — O(1) both ways, the
paper's RECLAIMED_LIST with a single size class.  Slots become
MainTable ``leaf_val``s, so the allocation order is exactly the JAX
package's.

The port updates the store in place (the data arena is the largest
tensor of the index); the functions return the updated ``DenseStore``
so call sites read like the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .scatter import masked_put_


class DenseStore(NamedTuple):
    data: torch.Tensor        # f32 (capacity, d)
    free_stack: torch.Tensor  # i32 (capacity,) indices; top grows downward
    free_top: torch.Tensor    # i32 () number of free slots on the stack
    live: torch.Tensor        # bool (capacity,)


def dense_init(capacity: int, dim: int, device=None) -> DenseStore:
    return DenseStore(
        data=torch.zeros((capacity, dim), dtype=torch.float32, device=device),
        free_stack=torch.arange(capacity - 1, -1, -1, dtype=torch.int32,
                                device=device),
        free_top=torch.tensor(capacity, dtype=torch.int32, device=device),
        live=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def dense_alloc(st: DenseStore, vecs: torch.Tensor, mask: torch.Tensor):
    """Allocate a slot per masked row and write. Returns (st, slots, ok).

    slots: (N,) int32, -1 where not allocated (masked out or full).
    """
    want = mask.to(torch.int32)
    rank = torch.cumsum(want, 0, dtype=torch.int32) - want  # 0-based rank
    ok = mask & (rank < st.free_top)
    pos = st.free_top - 1 - rank                             # stack position
    slots = torch.where(ok, st.free_stack[pos.clamp_min(0).long()], -1)
    masked_put_(st.data, (slots,), vecs.to(st.data.dtype), ok)
    masked_put_(st.live, (slots,), True, ok)
    taken = ok.sum(dtype=torch.int32)
    return st._replace(free_top=st.free_top - taken), slots, ok


def dense_free(st: DenseStore, slots: torch.Tensor,
               mask: torch.Tensor) -> DenseStore:
    """Reclaim slots (push back on the free stack).

    Duplicate slots within one batch free once: every row reads the
    pre-update ``live`` bits, so without the first-occurrence mask two
    rows naming the same slot would push it on the free stack twice."""
    cap = st.data.shape[0]
    n = slots.shape[0]
    dev = slots.device
    slots = slots.to(torch.int64)
    # rows that are masked out or slotless get distinct out-of-range keys
    valid = mask & (slots >= 0)
    key = torch.where(valid, slots, cap + torch.arange(n, device=dev))
    s, order = torch.sort(key, stable=True)
    dup_sorted = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                            s[1:] == s[:-1]])
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[order] = ~dup_sorted
    ok = valid & st.live[slots.clamp_min(0)] & first
    want = ok.to(torch.int32)
    rank = torch.cumsum(want, 0, dtype=torch.int32) - want
    masked_put_(st.free_stack, (st.free_top + rank,), slots, ok)
    masked_put_(st.live, (slots,), False, ok)
    return st._replace(free_top=st.free_top + want.sum(dtype=torch.int32))


def dense_read(st: DenseStore, slots: torch.Tensor) -> torch.Tensor:
    """Gather rows; slot -1 reads row 0 (callers mask by validity)."""
    return st.data[slots.to(torch.int64).clamp_min(0)]


def dense_read_tiered(st: DenseStore, staging: torch.Tensor | None,
                      slots: torch.Tensor) -> torch.Tensor:
    """Gather rows across the tiered store: ``slot < capacity`` reads the
    hot arena, ``slot >= capacity`` reads row ``slot - capacity`` of the
    ``staging`` arena; ``staging=None`` is :func:`dense_read`."""
    if staging is None:
        return dense_read(st, slots)
    cap = st.data.shape[0]
    slots = slots.to(torch.int64)
    hot = dense_read(st, slots.clamp_max(cap - 1))
    cold = staging[(slots - cap).clamp(0, staging.shape[0] - 1)]
    return torch.where((slots >= cap)[..., None], cold, hot)
