"""Vector stores: the dense MainTable Data segment and the sparse store.

Dense store — the MainTable's Data segment (paper §3.2.1).

A pre-allocated (capacity, d) tensor plus a free-list stack:
allocation pops the stack, reclamation pushes it — O(1) both ways, the
paper's RECLAIMED_LIST with a single size class.  Slots become
MainTable ``leaf_val``s, so the allocation order is exactly the JAX
package's.

Each slot also records the id it was allocated for (``owner``), and a
free names the ids it frees for: a slot is freed only while it still
belongs to that id.  A sealed copy of an id that was already deleted
still resolves to the id's old slot, which another id may hold by now;
without the owner check a second delete of the id would free that
other id's slot (the JAX package keeps that defect).

Sparse store — size-classed blocks of a fixed nnz granule; a record
chains as many blocks as its nonzeros need, taken from a free list.

The port updates each store's arenas in place (the data arena is the
largest tensor of the index); the functions return the store with its
scalar fields replaced, so call sites read like the JAX package's.
Every walk has the JAX package's fixed trip count and masks, so no
step reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .device import default_device
from .scatter import masked_put_


class DenseStore(NamedTuple):
    data: torch.Tensor        # f32 (capacity, d)
    free_stack: torch.Tensor  # i32 (capacity,) indices; top grows downward
    free_top: torch.Tensor    # i32 () number of free slots on the stack
    live: torch.Tensor        # bool (capacity,)
    # i32 (capacity,) id each slot was allocated for.  None: the store
    # keeps no owners (one converted from the JAX package, which keeps
    # none), and a free is the JAX package's.
    owner: torch.Tensor | None = None


def dense_init(capacity: int, dim: int, device=None) -> DenseStore:
    return DenseStore(
        data=torch.zeros((capacity, dim), dtype=torch.float32, device=device),
        free_stack=torch.arange(capacity - 1, -1, -1, dtype=torch.int32,
                                device=device),
        free_top=torch.tensor(capacity, dtype=torch.int32, device=device),
        live=torch.zeros((capacity,), dtype=torch.bool, device=device),
        owner=torch.full((capacity,), -1, dtype=torch.int32, device=device),
    )


def dense_owned(st: DenseStore, slots: torch.Tensor,
                ids: torch.Tensor | None = None) -> torch.Tensor:
    """(N,) bool: slot is live and, where ``ids`` are given and the store
    keeps owners, still belongs to that id.  Slots must lie in
    [0, capacity)."""
    slots = slots.to(torch.int64)
    live = st.live[slots]
    if ids is None or st.owner is None:
        return live
    return live & (st.owner[slots] == ids.to(torch.int32))


def dense_alloc(st: DenseStore, vecs: torch.Tensor, mask: torch.Tensor,
                ids: torch.Tensor | None = None):
    """Allocate a slot per masked row and write. Returns (st, slots, ok).

    slots: (N,) int32, -1 where not allocated (masked out or full).
    ``ids`` (N,) become the slots' owners where the store keeps them.
    """
    want = mask.to(torch.int32)
    rank = torch.cumsum(want, 0, dtype=torch.int32) - want  # 0-based rank
    ok = mask & (rank < st.free_top)
    pos = st.free_top - 1 - rank                             # stack position
    slots = torch.where(ok, st.free_stack[pos.clamp_min(0).long()], -1)
    masked_put_(st.data, (slots,), vecs.to(st.data.dtype), ok)
    masked_put_(st.live, (slots,), True, ok)
    if st.owner is not None and ids is not None:
        # the allocated rows hold distinct slots: each adds (id - old
        # owner) at its slot and every other row adds 0, so no row races
        # a real write and no fallback index is read back to the host
        # (as masked_put_ reads one)
        at = slots.clamp_min(0).to(torch.int64)
        st.owner.index_put_((at,), torch.where(
            ok, ids.to(torch.int32) - st.owner[at], 0), accumulate=True)
    taken = ok.sum(dtype=torch.int32)
    return st._replace(free_top=st.free_top - taken), slots, ok


def dense_free(st: DenseStore, slots: torch.Tensor, mask: torch.Tensor,
               ids: torch.Tensor | None = None) -> DenseStore:
    """Reclaim slots (push back on the free stack).

    Duplicate slots within one batch free once: every row reads the
    pre-update ``live`` bits, so without the first-occurrence mask two
    rows naming the same slot would push it on the free stack twice.
    With ``ids`` (N,), a row frees its slot only while the slot still
    belongs to its id (:func:`dense_owned`)."""
    cap = st.data.shape[0]
    n = slots.shape[0]
    dev = slots.device
    slots = slots.to(torch.int64)
    # rows that are masked out, slotless or not the slot's owner get
    # distinct out-of-range keys (a stale row must not shadow the owner's)
    valid = mask & (slots >= 0) & dense_owned(st, slots.clamp(0, cap - 1),
                                              ids)
    key = torch.where(valid, slots, cap + torch.arange(n, device=dev))
    s, order = torch.sort(key, stable=True)
    dup_sorted = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                            s[1:] == s[:-1]])
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[order] = ~dup_sorted
    ok = valid & first
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


# ======================================================================
# Sparse size-classed store
# ======================================================================
class SparseStore(NamedTuple):
    """Blocks of fixed nnz granule; records chain blocks as needed."""
    idx: torch.Tensor        # i32 (n_blocks, granule) feature indices, -1 pad
    val: torch.Tensor        # f32 (n_blocks, granule)
    next_blk: torch.Tensor   # i32 (n_blocks,) chain: v>0 -> block v-1; 0 end
    free_head: torch.Tensor  # i32 () head of block free list (v>0 enc)
    n_free: torch.Tensor     # i32 ()


def sparse_init(n_blocks: int, granule: int, device=None) -> SparseStore:
    """An empty store of ``n_blocks`` blocks on ``device`` (None means
    CUDA, and raises without it)."""
    device = default_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    nxt = torch.arange(2, n_blocks + 2, **i32)
    nxt[-1] = 0                              # last block ends the free list
    return SparseStore(
        idx=torch.full((n_blocks, granule), -1, **i32),
        val=torch.zeros((n_blocks, granule), dtype=torch.float32,
                        device=device),
        next_blk=nxt,
        free_head=torch.tensor(1, **i32),
        n_free=torch.tensor(n_blocks, **i32),
    )


def _block(enc: torch.Tensor) -> torch.Tensor:
    """(1,) block index of a v>0-encoded link (block 0 for v <= 0).  A
    (1,) index reads a copy: a 0-d index tensor would read a view and,
    on the card, sync to the host."""
    return (enc - 1).clamp_min(0).to(torch.int64).reshape(1)


def _put(dst: torch.Tensor, row: torch.Tensor, new, cond) -> None:
    """``dst[row] = new`` where ``cond``, in place (``row`` from
    :func:`_block`)."""
    dst[row] = torch.where(cond, new, dst[row])


def sparse_write(st: SparseStore, indices: torch.Tensor,
                 values: torch.Tensor):
    """Write one sparse record (padded (max_nnz,) tensors, -1 index pads).

    Chains ceil(nnz/granule) blocks from the free list.  Returns
    (st, head_slot, ok); head_slot uses the v>0 encoding."""
    granule = st.idx.shape[1]
    max_nnz = indices.shape[0]
    if max_nnz % granule:
        raise ValueError("pad max_nnz to a granule multiple")
    indices = indices.to(st.idx.device, torch.int32)
    values = values.to(st.val.device, torch.float32)
    nnz = (indices >= 0).sum(dtype=torch.int32)
    need = ((nnz + granule - 1) // granule).clamp_min(1)
    zero = torch.zeros((), dtype=torch.int32, device=st.idx.device)
    prev, head, ok = zero, zero, torch.ones_like(zero, dtype=torch.bool)
    free_head, n_free = st.free_head, st.n_free
    for i in range(max_nnz // granule):
        use = need > i
        blk = free_head - 1
        can = use & (free_head > 0)
        b = _block(free_head)
        new_free = torch.where(can, st.next_blk[b][0], free_head)
        _put(st.idx, b, indices[i * granule:(i + 1) * granule], can)
        _put(st.val, b, values[i * granule:(i + 1) * granule], can)
        free_head = new_free
        n_free = n_free - can.to(torch.int32)
        _put(st.next_blk, _block(prev), blk + 1, can & (prev > 0))  # link
        _put(st.next_blk, b, 0, can)         # this block ends the chain
        head = torch.where(can & (head == 0), blk + 1, head)
        prev = torch.where(can, blk + 1, prev)
        ok = ok & (can | ~use)
    return st._replace(free_head=free_head, n_free=n_free), head, ok


def sparse_read(st: SparseStore, head, max_nnz: int):
    """Read a chained record back into padded (max_nnz,) tensors."""
    granule = st.idx.shape[1]
    cur = torch.as_tensor(head, dtype=torch.int32, device=st.idx.device)
    idx = torch.full((max_nnz,), -1, dtype=torch.int32, device=cur.device)
    val = torch.zeros((max_nnz,), dtype=torch.float32, device=cur.device)
    for i in range(max_nnz // granule):
        have = cur > 0
        b = _block(cur)
        idx[i * granule:(i + 1) * granule] = torch.where(have, st.idx[b][0],
                                                         -1)
        val[i * granule:(i + 1) * granule] = torch.where(have, st.val[b][0],
                                                         0.0)
        cur = torch.where(have, st.next_blk[b][0], 0)
    return idx, val


def sparse_free(st: SparseStore, head, max_chain: int) -> SparseStore:
    """Reclaim a record's whole block chain onto the free list."""
    cur = torch.as_tensor(head, dtype=torch.int32, device=st.idx.device)
    free_head, n_free = st.free_head, st.n_free
    for _ in range(max_chain):
        have = cur > 0
        b = _block(cur)
        nxt = st.next_blk[b][0]
        _put(st.next_blk, b, free_head, have)
        _put(st.idx, b, -1, have)
        free_head = torch.where(have, cur, free_head)
        n_free = n_free + have.to(torch.int32)
        cur = torch.where(have, nxt, 0)
    return st._replace(free_head=free_head, n_free=n_free)


def sparse_to_dense(idx: torch.Tensor, val: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Decompress one padded sparse record to a dense (dim,) vector."""
    safe = torch.where(idx >= 0, idx, dim).to(torch.int64)
    out = torch.zeros((dim + 1,), dtype=val.dtype, device=val.device)
    return out.index_add_(0, safe, val)[:dim]
