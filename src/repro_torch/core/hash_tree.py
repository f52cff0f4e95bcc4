"""Adaptive hash tree (paper §5.1), array-encoded, in PyTorch.

A forest of trees lives in stacked tensors (structure of arrays with a
leading tree axis): directory nodes are rows of ``l`` slots whose values
encode a leaf chain or a child node, and leaves are (KEY, ID, VALUE,
NEXT) records.  Inserts consume ``log2(l)`` key bits per level, chain
into a slot, and spread a slot one level down when it holds more than
``t`` leaves — a local rewrite, never an upward rebalance.

Slot encoding:
    0   -> empty
    v>0 -> head of leaf chain at leaf index v-1
    v<0 -> child directory node at node index -v-1

Leaf ``next`` uses the same "v>0 == leaf v-1, 0 == end" encoding and
doubles as the free-list link of reclaimed leaves.

Only the fixed-trip **masked** traversal is ported; the JAX package's
data-dependent "loop" mode exists there as a test double.  Every walk
has a static trip count and masks rows that finished, so no step needs
a host sync:

* the directory descent runs ``max_depth - 1`` steps (a descent can
  never be deeper: spreads require ``depth + 1 < max_depth``);
* the chain-length test runs ``t + 1`` steps, as the reference caps it;
* the spread gathers the chain once, ``t + max_depth - 1`` links deep,
  and relinks it in one vectorised pass.  A chain spreads as soon as an
  insert makes it longer than ``t``, but a spread can move the whole
  chain into one child slot (keys that share the next ``log2(l)`` bits),
  where the next insert makes it one longer again: a chain at depth d
  holds at most ``t + 1 + d`` leaves when it spreads, and only chains
  above the deepest level spread.  A chain refused a spread for want of
  a node never spreads later (nodes return only at a seal);
* a delete finds its target without walking the chain at all (see
  :func:`forest_delete_dispatched`).

The single-writer actor discipline becomes a Python loop over the K
mailbox slots, each step applied to every tree of the forest at once.
The forest is updated in place; functions return it for readability.
Every arena is int64 (the reference's are int32; ``convert`` maps them
back), so indices need no conversion on the hot path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .lsh import key_bits


class TreeConfig(NamedTuple):
    """Static traversal parameters (same fields as the JAX package's)."""
    skip_bits: int      # bits consumed before the tree (m for LSHTables)
    log2_l: int         # bits per level
    l: int              # slots per directory node
    t: int              # spread threshold
    max_depth: int      # directory levels available
    max_nodes: int
    max_leaves: int
    max_candidates: int  # leaves returned per probe
    sibling_probe: bool = False
    traversal: str = "masked"
    max_chain: int = 0

    @property
    def max_chain_eff(self) -> int:
        return self.max_chain or self.max_candidates


class TreeState(NamedTuple):
    """A forest's arenas; every field has a leading (n_trees,) axis."""
    slots: torch.Tensor      # (T, max_nodes, l)
    leaf_key: torch.Tensor   # (T, max_leaves) uint32 values
    leaf_id: torch.Tensor    # (T, max_leaves) vector id; -1 == invalid
    leaf_val: torch.Tensor   # (T, max_leaves) payload (store slot / id)
    leaf_next: torch.Tensor  # (T, max_leaves)
    node_cnt: torch.Tensor   # (T,) allocated directory nodes (>=1: root)
    leaf_cnt: torch.Tensor   # (T,) bump cursor
    free_head: torch.Tensor  # (T,) leaf free-list head (slot encoding)
    n_items: torch.Tensor    # (T,) live leaves
    overflow: torch.Tensor   # (T,) arena-exhaustion events


def check_traversal(cfg: TreeConfig) -> None:
    if cfg.traversal != "masked":
        raise NotImplementedError(
            f"traversal={cfg.traversal!r}: the port runs the masked "
            "traversal only (loop mode is the JAX package's test double)")


def init_forest(cfg: TreeConfig, n_trees: int, device=None) -> TreeState:
    check_traversal(cfg)
    i64 = dict(dtype=torch.int64, device=device)
    leaves = (n_trees, cfg.max_leaves)
    return TreeState(
        slots=torch.zeros((n_trees, cfg.max_nodes, cfg.l), **i64),
        leaf_key=torch.zeros(leaves, **i64),
        leaf_id=torch.full(leaves, -1, **i64),
        leaf_val=torch.zeros(leaves, **i64),
        leaf_next=torch.zeros(leaves, **i64),
        node_cnt=torch.ones((n_trees,), **i64),
        leaf_cnt=torch.zeros((n_trees,), **i64),
        free_head=torch.zeros((n_trees,), **i64),
        n_items=torch.zeros((n_trees,), **i64),
        overflow=torch.zeros((n_trees,), **i64),
    )


def reset_forest_(forest: TreeState) -> TreeState:
    """Return every arena to its initial state, in place (a seal)."""
    for name in ("slots", "leaf_key", "leaf_val", "leaf_next", "leaf_cnt",
                 "free_head", "n_items", "overflow"):
        getattr(forest, name).zero_()
    forest.leaf_id.fill_(-1)
    forest.node_cnt.fill_(1)
    return forest


# ----------------------------------------------------------------------
# fixed-trip (masked) traversal over the stacked arenas
# ----------------------------------------------------------------------
def _descend(forest: TreeState, tids: torch.Tensor, hs: torch.Tensor,
             cfg: TreeConfig):
    """Batched fixed-trip descent: tids/hs (N,) -> (node, depth, sl, v),
    each (N,) int64; v >= 0 is the landing slot's value."""
    sl = key_bits(hs, cfg.skip_bits, cfg.log2_l)
    node = torch.zeros_like(sl)
    depth = torch.zeros_like(sl)
    v = forest.slots[tids, node, sl]
    for d in range(1, cfg.max_depth):
        go = v < 0
        node = torch.where(go, -v - 1, node)
        sl = torch.where(go, key_bits(hs, cfg.skip_bits + d * cfg.log2_l,
                                      cfg.log2_l), sl)
        depth = depth + go.to(torch.int64)
        v = torch.where(go, forest.slots[tids, node, sl], v)
    return node, depth, sl, v


def _chain_slots(forest: TreeState, tids: torch.Tensor, heads: torch.Tensor,
                 max_chain: int) -> torch.Tensor:
    """Batched chain gather: heads (...,) -> leaf indices (..., max_chain),
    -1 pad, newest first.  ``tids`` broadcasts against ``heads``."""
    tids = tids.expand(heads.shape)
    cur = heads
    out = []
    for _ in range(max_chain):
        alive = cur > 0
        leaf = torch.where(alive, cur - 1, 0)
        out.append(torch.where(alive, leaf, -1))
        cur = torch.where(alive, forest.leaf_next[tids, leaf], 0)
    return torch.stack(out, -1)


def forest_query_masked(forest: TreeState, tids: torch.Tensor,
                        hs: torch.Tensor, cfg: TreeConfig):
    """Batched fixed-trip probes: (N,) -> ids/vals (N, max_candidates)
    (-1 pad), counts (N,)."""
    tids = tids.to(torch.int64)
    n = tids.shape[0]
    node, _, sl, v = _descend(forest, tids, hs, cfg)
    mc = cfg.max_chain_eff
    if cfg.sibling_probe:
        ar = torch.arange(cfg.l, device=tids.device)
        sls = sl[:, None] ^ ar[None, :]
        vs = forest.slots[tids[:, None], node[:, None], sls]
        heads = torch.where(vs > 0, vs, 0)
        flat = _chain_slots(forest, tids[:, None], heads, mc).reshape(n, -1)
    else:
        heads = torch.where(v > 0, v, 0)
        flat = _chain_slots(forest, tids, heads, mc)            # (N, mc)
    valid = flat >= 0
    safe = flat.clamp_min(0)
    ftids = tids[:, None].expand(flat.shape)
    ids_all = torch.where(valid, forest.leaf_id[ftids, safe], -1)
    vals_all = torch.where(valid, forest.leaf_val[ftids, safe], -1)
    # stable compaction: valid entries keep their order, packed to the
    # front; entries past max_candidates are dropped
    cap = cfg.max_candidates
    pos = torch.cumsum(valid.to(torch.int64), 1) - 1
    tgt = torch.where(valid & (pos < cap), pos, cap)
    rows = torch.arange(n, device=tids.device)[:, None].expand(flat.shape)
    ids = torch.full((n, cap + 1), -1, dtype=torch.int64, device=tids.device)
    vals = torch.full_like(ids, -1)
    ids[rows, tgt] = ids_all                  # column cap is the discard
    vals[rows, tgt] = vals_all
    cnt = valid.sum(1).clamp_max(cap)
    return ids[:, :cap], vals[:, :cap], cnt


def _lookup_leaf(forest: TreeState, tids: torch.Tensor, hs: torch.Tensor,
                 vids: torch.Tensor, cfg: TreeConfig):
    """Batched fixed-trip exact-id lookup, newest version first: (N,) ->
    (leaf index, found bool), (N,) each; the chain is read
    ``max_chain_eff`` links deep."""
    _, _, _, v = _descend(forest, tids, hs, cfg)
    flat = _chain_slots(forest, tids, torch.where(v > 0, v, 0),
                        cfg.max_chain_eff)                    # (N, mc)
    valid = flat >= 0
    safe = flat.clamp_min(0)
    ftids = tids[:, None].expand(flat.shape)
    hit = valid & (forest.leaf_id[ftids, safe] == vids[:, None])
    first = hit.to(torch.uint8).argmax(1)     # first True == newest version
    return safe.gather(1, first[:, None])[:, 0], hit.any(1)


def forest_lookup_masked(forest: TreeState, tids: torch.Tensor,
                         hs: torch.Tensor, vids: torch.Tensor,
                         cfg: TreeConfig):
    """Batched fixed-trip exact-id lookup, newest version first:
    (N,) -> (val, found bool), (N,) each."""
    tids = tids.to(torch.int64)
    leaf, found = _lookup_leaf(forest, tids, hs, vids, cfg)
    val = torch.where(found, forest.leaf_val[tids, leaf], -1)
    return val, found


def forest_headroom(forest: TreeState):
    """Worst-tree arena cursors: (max leaf_cnt, max node_cnt), 0-d."""
    return forest.leaf_cnt.max(), forest.node_cnt.max()


# ----------------------------------------------------------------------
# write path: one mailbox slot applied to every tree at once
# ----------------------------------------------------------------------
def _put(dst: torch.Tensor, rows: torch.Tensor, cols: tuple,
         values, mask: torch.Tensor) -> None:
    """``dst[rows, *cols] = values`` where ``mask``, one write per tree.

    Rows are distinct trees, so writes never collide; a masked-out row
    writes back its own current value (its column indices must be in
    bounds, which callers ensure by clamping)."""
    idx = (rows, *cols)
    dst[idx] = torch.where(mask, values, dst[idx])


def _spread(f: TreeState, rows: torch.Tensor, head: torch.Tensor,
            node: torch.Tensor, sl: torch.Tensor, depth: torch.Tensor,
            w: torch.Tensor, cfg: TreeConfig) -> None:
    """Step 4 of the insert: spread the chain at ``head`` into a fresh
    directory node where it now holds more than t leaves, unconsumed key
    bits remain and a node can be allocated.

    The reference walks the chain and prepends each leaf to its child
    slot in turn; the result is computed here in one pass: a moved leaf's
    new ``next`` is the latest earlier leaf of the chain with the same
    child slot (0 if none: the node is fresh), and the last leaf of each
    child slot becomes that slot's head."""
    width = max(cfg.t + 1, cfg.t + cfg.max_depth - 1)
    links = [head]
    for _ in range(width - 1):
        cur = links[-1]
        links.append(torch.where(cur > 0,
                                 f.leaf_next[rows, (cur - 1).clamp_min(0)], 0))
    chain = torch.stack(links, 1)                         # (T, W) slot enc.
    alive = chain > 0
    split = (w & (alive.sum(1) > cfg.t) & (depth + 1 < cfg.max_depth)
             & (f.node_cnt < cfg.max_nodes))
    nn = f.node_cnt.clamp_max(cfg.max_nodes - 1)
    f.node_cnt.add_(split.to(torch.int64))

    leaf = (chain - 1).clamp_min(0)
    r2 = rows[:, None]
    child_sl = key_bits(f.leaf_key[r2, leaf],
                        (cfg.skip_bits + (depth + 1) * cfg.log2_l)[:, None],
                        cfg.log2_l)                       # (T, W)
    moved = alive & split[:, None]
    pos = torch.arange(width, device=head.device)
    same = ((child_sl[:, :, None] == child_sl[:, None, :])
            & moved[:, :, None] & moved[:, None, :])      # [T, i, j]
    prev = torch.where(same & (pos[:, None] < pos[None, :]), pos[:, None],
                       -1).amax(1)                        # latest i < j
    new_next = torch.where(prev >= 0, chain.gather(1, prev.clamp_min(0)), 0)
    is_head = moved & ~(same & (pos[:, None] > pos[None, :])).any(1)

    # rows not moved repeat position 0's write (the head, which moves in
    # every splitting tree), so no two writes of a tree disagree
    keep0 = torch.where(split, new_next[:, 0], f.leaf_next[rows, leaf[:, 0]])
    f.leaf_next[r2, torch.where(moved, leaf, leaf[:, :1])] = torch.where(
        moved, new_next, keep0[:, None])
    j = is_head.to(torch.uint8).argmax(1, keepdim=True)   # some head slot
    sl0 = torch.where(split[:, None], child_sl.gather(1, j), 0)
    val0 = torch.where(split[:, None], chain.gather(1, j),
                       f.slots[rows, nn, 0][:, None])
    f.slots[r2, nn[:, None], torch.where(is_head, child_sl, sl0)] = \
        torch.where(is_head, chain, val0)
    _put(f.slots, rows, (node, sl), -(nn + 1), split)


def _tree_insert(forest: TreeState, rows: torch.Tensor, h: torch.Tensor,
                 vid: torch.Tensor, val: torch.Tensor, act: torch.Tensor,
                 cfg: TreeConfig) -> None:
    """Insert one (key, id, value) record into every tree with ``act``
    (paper §5.1 steps 1-4), spreading the bucket when it exceeds t."""
    f = forest
    node, depth, sl, v = _descend(f, rows, h, cfg)

    # pop the free list, else bump the cursor
    use_free = f.free_head > 0
    free_idx = (f.free_head - 1).clamp_min(0)
    ok = use_free | (f.leaf_cnt < cfg.max_leaves)
    w = act & ok                                      # records that land
    f.overflow.add_((act & ~ok).to(torch.int64))      # arena exhausted
    new_leaf = torch.where(use_free, free_idx, f.leaf_cnt).clamp_max(
        cfg.max_leaves - 1)
    new_free = torch.where(use_free, f.leaf_next[rows, free_idx], f.free_head)
    f.free_head.copy_(torch.where(w, new_free, f.free_head))
    f.leaf_cnt.add_((w & ~use_free).to(torch.int64))

    # prepend to the chain (v >= 0: empty slot or chain head)
    _put(f.leaf_key, rows, (new_leaf,), h, w)
    _put(f.leaf_id, rows, (new_leaf,), vid, w)
    _put(f.leaf_val, rows, (new_leaf,), val, w)
    _put(f.leaf_next, rows, (new_leaf,), v, w)
    _put(f.slots, rows, (node, sl), new_leaf + 1, w)
    f.n_items.add_(w.to(torch.int64))
    _spread(f, rows, new_leaf + 1, node, sl, depth, w, cfg)


def forest_insert_dispatched(forest: TreeState, per_tree_h: torch.Tensor,
                             per_tree_id: torch.Tensor,
                             per_tree_val: torch.Tensor,
                             cfg: TreeConfig) -> TreeState:
    """Apply pre-dispatched requests: (T, K) tensors, -1 id == padding.

    Mailbox slot k is applied to every tree before slot k + 1 (the
    actor's serial inbox); trees proceed in parallel."""
    rows = torch.arange(per_tree_id.shape[0], device=per_tree_id.device)
    hs, vids, vals = (a.to(torch.int64).t().contiguous()
                      for a in (per_tree_h, per_tree_id, per_tree_val))
    for k in range(vids.shape[0]):
        _tree_insert(forest, rows, hs[k], vids[k], vals[k], vids[k] >= 0, cfg)
    return forest


def forest_replace_dispatched(forest: TreeState, per_tree_h: torch.Tensor,
                              per_tree_id: torch.Tensor,
                              per_tree_val: torch.Tensor, cfg: TreeConfig):
    """Replace, before a round's inserts, the entries of ids the forest
    already holds (the MainTable, whose key is a function of the id
    alone, so both versions of an id land in one chain): (T, K) mailbox
    tensors as :func:`forest_insert_dispatched` takes them.

    A slot whose id a later slot of its tree's mailbox repeats is
    dropped (the later one wins, as a dict's assignment does); a slot
    whose id the chain it lands on holds, as far as a lookup reads it
    (``max_chain_eff`` links), overwrites that leaf's value, the newest
    version's.  Every slot runs at once, as one batched lookup: no slot
    of a round can find a leaf another slot of the round adds, once the
    repeats are dropped.  Returns (ids, displaced), both (T, K): the ids
    with the dropped and replacing slots set to -1 (what is left to
    insert), and the values the round gives up, -1 where none (a
    replaced leaf's older value, a dropped slot's own)."""
    ids = per_tree_id.to(torch.int64)
    vals = per_tree_val.to(torch.int64)
    n_trees, k = ids.shape
    live = ids >= 0
    later = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                  device=ids.device), diagonal=1)
    repeated = ((ids[:, :, None] == ids[:, None, :]) & later
                & live[:, None, :]).any(2) & live            # (T, K)
    ask = live & ~repeated
    tids = torch.arange(n_trees, device=ids.device)[:, None].expand(
        n_trees, k).reshape(-1)
    leaf, found = _lookup_leaf(forest, tids, per_tree_h.to(torch.int64)
                               .reshape(-1), torch.where(ask, ids, -1)
                               .reshape(-1), cfg)
    found = found & ask.reshape(-1)
    cur = forest.leaf_val[tids, leaf]
    # found leaves are distinct (each holds an id its tree's asking rows
    # name once): each adds (new - old) at its leaf and every other row
    # adds 0 wherever it points, so no write races another
    forest.leaf_val.index_put_((tids, leaf), torch.where(
        found, vals.reshape(-1) - cur, 0), accumulate=True)
    older = torch.where(found, cur, -1)
    found = found.reshape(n_trees, k)
    displaced = torch.where(repeated, vals, older.reshape(n_trees, k))
    return torch.where(found | repeated, -1, ids), displaced


def _chain_order(forest: TreeState) -> torch.Tensor:
    """Each leaf's distance to the end of its chain, (T, max_leaves)
    int64, by pointer jumping (log2(max_leaves) steps).  Within one
    chain, the larger the distance, the nearer the head."""
    nxt = forest.leaf_next - 1                                # -1 == end
    dist = (nxt >= 0).to(torch.int64)
    n_leaves = nxt.shape[1]
    for _ in range(max(1, (n_leaves - 1).bit_length())):
        has = nxt >= 0
        j = nxt.clamp_min(0)
        dist = dist + torch.where(has, dist.gather(1, j), 0)
        nxt = torch.where(has, nxt.gather(1, j), -1)
    return dist


def forest_delete_dispatched(forest: TreeState, per_tree_h: torch.Tensor,
                             per_tree_id: torch.Tensor,
                             cfg: TreeConfig) -> TreeState:
    """Unlink, per mailbox slot, the first record in chain order with the
    slot's id in the chain its key lands on, and push the leaf on the
    free list (the JAX package's ``tree_delete``).

    The chain walk of the reference has no static bound (a chain at the
    deepest level can grow without limit), so the target is found
    without one: a live leaf is in the chain of bucket B exactly when
    its own key lands on B, i.e. shares B's consumed key prefix, and
    chain order is fixed for the whole round by one pointer-jumping pass
    (deletes only remove links, so it never reorders).  Predecessors are
    tracked in a ``prev`` map kept current as links are removed.
    """
    f = forest
    n_trees, n_leaves = f.leaf_id.shape
    dev = f.leaf_id.device
    rows = torch.arange(n_trees, device=dev)
    order = _chain_order(f)
    # prev[t, i] = slot-encoded predecessor of leaf i (0: none / head);
    # column n_leaves is the discard column of unlinked leaves
    nxt = f.leaf_next
    prev = torch.zeros((n_trees, n_leaves + 1), dtype=torch.int64,
                       device=dev)
    src = torch.arange(1, n_leaves + 1, device=dev).expand(n_trees, n_leaves)
    prev.scatter_(1, torch.where(nxt > 0, nxt - 1, n_leaves), src)

    hs, vids = (a.to(torch.int64).t().contiguous()
                for a in (per_tree_h, per_tree_id))
    for h, vid in zip(hs, vids):
        node, depth, sl, v = _descend(f, rows, h, cfg)
        shift = 32 - (cfg.skip_bits + (depth + 1) * cfg.log2_l)
        same_bucket = (f.leaf_key >> shift[:, None]) == (h >> shift)[:, None]
        cand = (same_bucket & (f.leaf_id == vid[:, None])
                & (vid >= 0)[:, None] & (v > 0)[:, None])
        best, target = torch.where(cand, order, -1).max(1)
        found = best >= 0
        tp = prev[rows, target]
        tnext = f.leaf_next[rows, target]
        # head removal repoints the slot; mid removal the predecessor
        _put(f.slots, rows, (node, sl), tnext, found & (tp == 0))
        _put(f.leaf_next, rows, ((tp - 1).clamp_min(0),), tnext,
             found & (tp > 0))
        _put(prev, rows, ((tnext - 1).clamp_min(0),), tp, found & (tnext > 0))
        _put(f.leaf_id, rows, (target,), -1, found)
        _put(f.leaf_next, rows, (target,), f.free_head, found)
        f.free_head.copy_(torch.where(found, target + 1, f.free_head))
        f.n_items.sub_(found.to(torch.int64))
    return forest
