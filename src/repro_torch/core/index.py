"""PFOIndex — the public API of the port.

Layout (paper §3, Fig. 1): one MainTable (id -> vector, murmur-hashed)
plus ``L`` LSHTables (compound key -> id).  Every table is a Partitioned
Hash Forest (§4.1) in pre-allocated device tensors; overflowing forests
*seal* into read-only snapshot segments with Bloom summaries (§3.2.2);
queries union hot + sealed candidates from all L tables, dedupe, fetch
vectors from the MainTable store and exact-rank (§3.1).

Request batches are dispatched into per-tree mailboxes and applied with
tree-level parallelism (§4.2).  Every step returns one packed int32 flag
word on the device; the host reads it once per round (``_read_flags``)
and runs the seal/merge epochs it asks for.  A round adds at most
``capacity`` leaves and nodes per tree, and the host seals whenever the
headroom falls below that bound, so arenas never overflow.

All L LSH tables are stacked into one forest with global tree ids
``table * 2^(C+m) + region``, so one dispatch covers every table.

With ``cold_segments > 0`` a full ring spills its oldest segment to a
host/flash segment store instead of merging (``coldtier.py``); queries
and deletes then also route through the cold tier's Bloom filters and
device segment cache, and rank spilled candidates out of its staging
arena.

This mirrors the JAX package's ``core/index.py`` step for step; the
steps update the state's tensors in place and return the state.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs import Obs
from . import coldtier
from . import snapshots as snap_mod
from .config import PFOConfig
from .device import default_device
from .dispatch import (FLAG_ANY_PENDING, FLAG_COLD_FULL, FLAG_COLD_MISS,
                       FLAG_COLD_SPILL, FLAG_NEED_SEAL, FLAG_SNAPS_FULL,
                       FLAG_STORE_FULL, FLAG_TOMBS_FULL, dispatch_to_trees,
                       gather_mailbox, mailbox_ids, pack_round_flags)
from .hash_tree import (TreeConfig, TreeState, forest_delete_dispatched,
                        forest_headroom, forest_insert_dispatched,
                        forest_lookup_masked, forest_query_masked,
                        forest_replace_dispatched, init_forest,
                        reset_forest_)
from .lsh import main_table_keys, make_projections, region_ids
from .membership import member_sorted
from .scatter import masked_put_
from .store import (DenseStore, dense_alloc, dense_free, dense_init,
                    dense_read_tiered)

INT_MAX = 2**31 - 1


def lsh_tree_config(cfg: PFOConfig) -> TreeConfig:
    return TreeConfig(
        skip_bits=cfg.m, log2_l=cfg.log2_l, l=cfg.l, t=cfg.t,
        max_depth=cfg.max_depth, max_nodes=cfg.max_nodes_per_tree,
        max_leaves=cfg.max_leaves_per_tree,
        max_candidates=cfg.max_candidates_per_probe,
        sibling_probe=cfg.sibling_probe,
        traversal=cfg.traversal, max_chain=cfg.max_chain)


def main_tree_config(cfg: PFOConfig) -> TreeConfig:
    return TreeConfig(
        skip_bits=cfg.main_m, log2_l=cfg.log2_l, l=cfg.l, t=cfg.t,
        max_depth=cfg.main_max_depth, max_nodes=cfg.main_max_nodes_per_tree,
        max_leaves=cfg.main_max_leaves_per_tree,
        max_candidates=cfg.max_candidates_per_probe,
        traversal=cfg.traversal, max_chain=cfg.max_chain)


class PFOState(NamedTuple):
    lsh_forest: TreeState              # leading axis L * 2^(C+m)
    main_forest: TreeState             # leading axis 2^main_m
    store: DenseStore
    lsh_snaps: snap_mod.SnapshotSet    # leading axis L
    main_snaps: snap_mod.SnapshotSet   # no leading axis
    tombstones: torch.Tensor           # i32 (max_tombstones,) -1 pad
    n_tombstones: torch.Tensor         # i32 ()
    stamp: torch.Tensor                # i32 () seal epoch counter
    proj: dict                         # LSH projection params
    # cold-tier routing table + device segment cache; None when the
    # cold tier is off
    cold: coldtier.ColdState | None = None


def _snap_cfg_lsh(cfg: PFOConfig) -> PFOConfig:
    cap = cfg.n_trees * cfg.max_leaves_per_tree
    return PFOConfig(**{**cfg.__dict__, "snapshot_capacity": cap})


def _snap_cfg_main(cfg: PFOConfig) -> PFOConfig:
    cap = cfg.main_n_trees * cfg.main_max_leaves_per_tree
    # MainTable probes are exact (key, id) lookups: always single-probe
    return PFOConfig(**{**cfg.__dict__, "snapshot_capacity": cap,
                        "snap_probes": 1})


def init_state(cfg: PFOConfig, proj: dict) -> PFOState:
    """Fresh state on the device of ``proj`` (the SRP parameters)."""
    dev = proj["table_proj"].device
    i32 = dict(dtype=torch.int32, device=dev)
    return PFOState(
        lsh_forest=init_forest(lsh_tree_config(cfg), cfg.L * cfg.n_trees, dev),
        main_forest=init_forest(main_tree_config(cfg), cfg.main_n_trees, dev),
        store=dense_init(cfg.store_capacity, cfg.dim, dev),
        lsh_snaps=snap_mod.init_snapshots(_snap_cfg_lsh(cfg), cfg.L, dev),
        main_snaps=snap_mod.unbatch(
            snap_mod.init_snapshots(_snap_cfg_main(cfg), 1, dev)),
        tombstones=torch.full((cfg.max_tombstones,), -1, **i32),
        n_tombstones=torch.tensor(0, **i32),
        stamp=torch.tensor(0, **i32),
        proj=proj,
        cold=coldtier.init_cold(cfg, _snap_cfg_lsh(cfg), _snap_cfg_main(cfg),
                                dev),
    )


# ======================================================================
# device pipelines
# ======================================================================
def compute_keys(state: PFOState, vecs: torch.Tensor, cfg: PFOConfig):
    """(N,d) -> compound keys (N,L) and global tree ids (N,L)."""
    h = kops.lsh_hash(vecs, state.proj["table_proj"], cfg.M)     # (N, L)
    region = region_ids(h, state.proj["part_proj"], cfg)
    table_off = torch.arange(cfg.L, device=h.device)[None] * cfg.n_trees
    return h, region + table_off


def _tombs_threshold(cfg: PFOConfig) -> int:
    """Proactive-merge watermark: leave one round of delete headroom."""
    return cfg.max_tombstones - max(1, min(64, cfg.max_tombstones // 4))


def _cold_full_threshold(cfg: PFOConfig) -> int:
    """Routing-table watermark that kicks the background compaction —
    enough headroom left for the spills that land while it runs."""
    return cfg.cold_segments - max(1, cfg.cold_segments // 4)


def _round_flags(state: PFOState, cfg: PFOConfig, main_capacity: int,
                 lsh_capacity: int, any_pending: torch.Tensor,
                 cold_miss: torch.Tensor | None = None) -> torch.Tensor:
    """Device-side maintenance decision for the *next* round, packed:
    worst-tree cursors against the arena sizes decide seal, ring and
    tombstone occupancy decide merge.  With a cold tier, a full ring
    spills (COLD_SPILL) instead of merging, store pressure under
    ``store_low_watermark`` spills too (sealing first when the ring is
    empty), and routing-table occupancy arms the background compaction
    (COLD_FULL)."""
    leaf_head, node_head = forest_headroom(state.lsh_forest)
    mleaf, mnode = forest_headroom(state.main_forest)
    need_seal = (
        (leaf_head + lsh_capacity > cfg.max_leaves_per_tree)
        | (node_head + lsh_capacity > cfg.max_nodes_per_tree)
        | (mleaf + main_capacity > cfg.main_max_leaves_per_tree)
        | (mnode + main_capacity > cfg.main_max_nodes_per_tree)
        | (leaf_head >= int(cfg.seal_threshold * cfg.max_leaves_per_tree)))
    ring_full = state.lsh_snaps.n_snaps.max() >= cfg.max_snapshots - 1
    tombs_full = state.n_tombstones >= _tombs_threshold(cfg)
    if cfg.cold_enabled:
        # capacity relief is a spill, never a merge: SNAPS_FULL stays 0
        cold_spill = ring_full
        store_full = None
        if cfg.store_low_watermark:
            store_low = state.store.free_top < cfg.store_low_watermark
            ring_nonempty = state.main_snaps.n_snaps > 0
            hot_nonempty = state.main_forest.n_items.sum() > 0
            cold_spill = cold_spill | (store_low & ring_nonempty)
            need_seal = need_seal | (store_low & ~ring_nonempty
                                     & hot_nonempty)
            store_full = store_low
        return pack_round_flags(
            any_pending, need_seal, torch.zeros_like(any_pending),
            tombs_full, cold_spill=cold_spill,
            cold_full=state.cold.n_cold >= _cold_full_threshold(cfg),
            cold_miss=cold_miss, store_full=store_full)
    return pack_round_flags(any_pending, need_seal, ring_full, tombs_full)


def round_flags(state: PFOState, cfg: PFOConfig, main_capacity: int,
                lsh_capacity: int) -> torch.Tensor:
    """Standalone flag computation (cold start / capacity change only —
    steady-state rounds get their flags from the step itself)."""
    no = torch.zeros((), dtype=torch.bool, device=state.stamp.device)
    return _round_flags(state, cfg, main_capacity, lsh_capacity, no)


def insert_step(state: PFOState, ids: torch.Tensor, vecs: torch.Tensor,
                slots_in: torch.Tensor, main_active: torch.Tensor,
                lsh_active: torch.Tensor, cfg: PFOConfig, main_capacity: int,
                lsh_capacity: int, flags_main_capacity: int | None = None,
                flags_lsh_capacity: int | None = None):
    """One dispatch round of batched insert.

    ids/vecs: (N,), (N,d).  ``slots_in``: -2 == store slot not yet
    allocated.  ``main_active`` (N,) / ``lsh_active`` (N*L,) mark
    requests still pending, so a retry never double-inserts.
    Returns (state, slots, main_pending, lsh_pending, flags).
    """
    L = cfg.L
    need_alloc = (slots_in == -2) & main_active
    store, new_slots, alloc_ok = dense_alloc(state.store, vecs, need_alloc,
                                            ids)
    slots = torch.where(need_alloc & alloc_ok, new_slots, slots_in)
    have_slot = slots >= 0

    # re-inserting a previously-deleted id revokes its tombstone
    revived = member_sorted(state.tombstones,
                            torch.where(main_active, ids, -1))
    state = state._replace(store=store, tombstones=torch.where(
        revived, -1, state.tombstones))

    # --- MainTable insert --------------------------------------------
    mh, mtree = main_table_keys(ids, cfg)
    m_req = torch.where(main_active & have_slot, mtree, -1)
    mbox, m_ovf = dispatch_to_trees(m_req, cfg.main_n_trees, main_capacity)
    (mh_g, mval_g) = gather_mailbox(mbox, mh, slots)
    mid_g = mailbox_ids(mbox, ids)
    # a live re-insert replaces its id's hot entry; the slot it gives up
    # is freed (through the owner check: a slot another id holds stays)
    left, displaced = forest_replace_dispatched(
        state.main_forest, mh_g, mid_g, mval_g, main_tree_config(cfg))
    forest_insert_dispatched(state.main_forest, mh_g, left, mval_g,
                             main_tree_config(cfg))
    state = state._replace(store=free_displaced(state.store, displaced,
                                                mid_g))

    # --- LSHTables insert ---------------------------------------------
    h, gtrees = compute_keys(state, vecs, cfg)                   # (N, L)
    flat_id = ids.repeat_interleave(L)
    l_req = torch.where(lsh_active & have_slot.repeat_interleave(L),
                        gtrees.reshape(-1), -1)
    lbox, l_ovf = dispatch_to_trees(l_req, L * cfg.n_trees, lsh_capacity)
    (lh_g,) = gather_mailbox(lbox, h.reshape(-1))
    lid_g = mailbox_ids(lbox, flat_id)
    forest_insert_dispatched(state.lsh_forest, lh_g, lid_g, lid_g,
                             lsh_tree_config(cfg))

    main_pending = main_active & (m_ovf | ~have_slot)
    lsh_pending = lsh_active & (l_ovf | ~have_slot.repeat_interleave(L))
    flags = _round_flags(state, cfg, flags_main_capacity or main_capacity,
                         flags_lsh_capacity or lsh_capacity,
                         main_pending.any() | lsh_pending.any())
    return state, slots, main_pending, lsh_pending, flags


def free_displaced(store: DenseStore, displaced: torch.Tensor,
                   mail_ids: torch.Tensor) -> DenseStore:
    """Free the store slots a MainTable insert displaced: (T, K) slots
    (-1 where none) and the ids of their mailbox slots."""
    flat = displaced.reshape(-1)
    return dense_free(store, flat, flat >= 0, mail_ids.reshape(-1))


def seal_step(state: PFOState, cfg: PFOConfig) -> PFOState:
    """Seal every LSH table + the MainTable into snapshot segments and
    reset the hot forests (paper §3.2.2)."""
    stamp = state.stamp + 1
    lf, L = state.lsh_forest, cfg.L
    ids = lf.leaf_id.reshape(L, -1)
    lsh_snaps = snap_mod.seal(state.lsh_snaps, lf.leaf_key.reshape(L, -1),
                              ids, lf.leaf_val.reshape(L, -1), ids >= 0,
                              stamp, _snap_cfg_lsh(cfg))
    mf = state.main_forest
    mids = mf.leaf_id.reshape(1, -1)
    main_snaps = snap_mod.unbatch(snap_mod.seal(
        snap_mod.one(state.main_snaps), mf.leaf_key.reshape(1, -1), mids,
        mf.leaf_val.reshape(1, -1), mids >= 0, stamp, _snap_cfg_main(cfg)))
    reset_forest_(state.lsh_forest)
    reset_forest_(state.main_forest)
    return state._replace(lsh_snaps=lsh_snaps, main_snaps=main_snaps,
                          stamp=stamp)


def merge_step(state: PFOState, cfg: PFOConfig) -> PFOState:
    """Fold every ring into one segment, dropping tombstoned ids, and
    drain the tombstone buffer."""
    tombs = state.tombstones
    lsh_snaps = snap_mod.merge(state.lsh_snaps, _snap_cfg_lsh(cfg), tombs)
    main_snaps = snap_mod.unbatch(snap_mod.merge(
        snap_mod.one(state.main_snaps), _snap_cfg_main(cfg), tombs))
    return state._replace(
        lsh_snaps=lsh_snaps, main_snaps=main_snaps,
        tombstones=torch.full_like(tombs, -1),
        n_tombstones=torch.zeros_like(state.n_tombstones))


def _main_lookup(state: PFOState, ids: torch.Tensor, cfg: PFOConfig):
    """(N,) id -> (slot, found), searching hot forest then sealed tier."""
    mh, mtree = main_table_keys(ids, cfg)
    val, found = forest_lookup_masked(state.main_forest, mtree, mh, ids,
                                      main_tree_config(cfg))
    sval, sfound = snap_mod.lookup_key_run(
        snap_mod.one(state.main_snaps), mh, ids, _snap_cfg_main(cfg))
    slot = torch.where(found, val, torch.where(sfound, sval, -1))
    return slot, found | sfound


def _hot_sealed_candidates(state: PFOState, qvecs: torch.Tensor,
                           cfg: PFOConfig):
    """Hash, probe the hot trees, probe the sealed ring Bloom-first
    (newest first).  Returns (h (Q, L), cand (Q, L*mc + L*S*P*B))."""
    q = qvecs.shape[0]
    h, gtrees = compute_keys(state, qvecs, cfg)                  # (Q, L)
    flat_ids, _, _ = forest_query_masked(state.lsh_forest, gtrees.reshape(-1),
                                         h.reshape(-1), lsh_tree_config(cfg))
    hot = flat_ids.reshape(q, -1)                                # (Q, L*mc)
    sealed, _ = snap_mod.probe(state.lsh_snaps, h.t().contiguous(),
                               _snap_cfg_lsh(cfg))               # (L, Q, ·)
    return h, torch.cat([hot, sealed.permute(1, 0, 2).reshape(q, -1)], 1)


def _dedupe_candidates(cand: torch.Tensor, tombstones: torch.Tensor,
                       cfg: PFOConfig) -> torch.Tensor:
    """Tombstone filter + dedupe + truncate to the ranking budget:
    (Q, C_any) -> (Q, max_candidates_total), -1 pad."""
    q = cand.shape[0]
    dead = member_sorted(cand, tombstones) & (cand >= 0)
    skey = torch.where((cand >= 0) & ~dead, cand, INT_MAX)
    skey = torch.sort(skey, dim=1).values
    dup = torch.cat([torch.zeros((q, 1), dtype=torch.bool, device=cand.device),
                     skey[:, 1:] == skey[:, :-1]], 1)
    uniq = torch.sort(torch.where(dup, INT_MAX, skey), dim=1).values
    uniq = uniq[:, :cfg.max_candidates_total]
    return torch.where(uniq == INT_MAX, -1, uniq)


def _rank_candidates(state: PFOState, qvecs: torch.Tensor, cids: torch.Tensor,
                     slot: torch.Tensor, found: torch.Tensor, cfg: PFOConfig,
                     k: int, staging: torch.Tensor | None = None):
    """Exact re-rank: the gather_rank kernel reads candidate vectors
    straight out of the store by slot id, then a top-k.  ``staging`` is
    the cold tier's payload arena; slots ``>= store_capacity`` read from
    it (the staged kernel)."""
    valid = (cids >= 0) & found & (slot >= 0)
    slots = torch.where(valid, slot, 0)
    idx, top_d = kops.gather_rank_topk(qvecs, state.store.data, slots, valid,
                                       k, cfg.metric, staging=staging)
    top_ids = cids.gather(1, idx)
    return torch.where(torch.isfinite(top_d), top_ids, -1), top_d


def query_step(state: PFOState, qvecs: torch.Tensor, cfg: PFOConfig, k: int):
    """Batched kNN query: (Q,d) -> (ids (Q,k), dists (Q,k)).  Paper §3.1
    read path: hash, union hot + sealed candidates, dedupe, look the ids
    up in the MainTable, exact-rank, top-k."""
    _, cand = _hot_sealed_candidates(state, qvecs, cfg)
    cids = _dedupe_candidates(cand, state.tombstones, cfg)
    slot, found = _main_lookup(state, cids.reshape(-1), cfg)
    return _rank_candidates(state, qvecs, cids, slot.reshape(cids.shape),
                            found.reshape(cids.shape), cfg, k)


def _delete_apply(state: PFOState, ids: torch.Tensor, slot: torch.Tensor,
                  ok: torch.Tensor, cfg: PFOConfig, main_capacity: int,
                  lsh_capacity: int, staging: torch.Tensor | None = None):
    """The delete pipeline after the lookup, shared by both delete
    steps: unlink hot entries, free store slots, append tombstones.
    Returns (state, pending), pending covering mailbox and
    tombstone-buffer overflow rows.

    ``staging`` enables the tiered path: a row resolved to a staging
    slot re-derives its LSH keys from the cold payload arena, and frees
    no store slot (its spill already freed it)."""
    L = cfg.L
    # re-derive LSH keys from the stored vector
    vecs = dense_read_tiered(state.store, staging, torch.where(ok, slot, 0))
    h, gtrees = compute_keys(state, vecs, cfg)
    flat_tree = torch.where(ok.repeat_interleave(L), gtrees.reshape(-1), -1)
    lbox, l_ovf = dispatch_to_trees(flat_tree, L * cfg.n_trees, lsh_capacity)
    (lh_g,) = gather_mailbox(lbox, h.reshape(-1))
    forest_delete_dispatched(state.lsh_forest, lh_g,
                             mailbox_ids(lbox, ids.repeat_interleave(L)),
                             lsh_tree_config(cfg))

    mh, mtree = main_table_keys(ids, cfg)
    mbox, m_ovf = dispatch_to_trees(torch.where(ok, mtree, -1),
                                    cfg.main_n_trees, main_capacity)
    (mh_g,) = gather_mailbox(mbox, mh)
    forest_delete_dispatched(state.main_forest, mh_g, mailbox_ids(mbox, ids),
                             main_tree_config(cfg))

    # a row frees its slot only while the slot is still its id's: a
    # sealed copy of an id deleted before resolves to the id's old slot,
    # which another id may hold by now
    if staging is None:
        store = dense_free(state.store, slot, ok, ids)
    else:
        hot_ok = ok & (slot < cfg.store_capacity)
        store = dense_free(state.store, torch.where(hot_ok, slot, 0), hot_ok,
                           ids)

    # tombstones cover sealed copies; rows that do not fit stay pending
    want = ok.to(torch.int32)
    pos = state.n_tombstones + torch.cumsum(want, 0, dtype=torch.int32) - want
    fits = ok & (pos < cfg.max_tombstones)
    masked_put_(state.tombstones, (pos,), ids, fits)
    n_t = (state.n_tombstones + fits.sum(dtype=torch.int32)).clamp_max(
        cfg.max_tombstones)

    state = state._replace(store=store, n_tombstones=n_t)
    l_row = l_ovf.reshape(-1, L).any(1)
    return state, (ok & (l_row | m_ovf)) | (ok & ~fits)


def delete_step(state: PFOState, ids: torch.Tensor, active: torch.Tensor,
                cfg: PFOConfig, main_capacity: int, lsh_capacity: int,
                flags_main_capacity: int | None = None,
                flags_lsh_capacity: int | None = None):
    """Batched delete: unlink hot entries, free store slots, tombstone
    sealed copies.  Idempotent per round, so per-row retry is safe.
    Returns (state, pending, flags)."""
    slot, found = _main_lookup(state, ids, cfg)
    ok = active & found & (slot >= 0)
    state, pending = _delete_apply(state, ids, slot, ok, cfg, main_capacity,
                                   lsh_capacity)
    flags = _round_flags(state, cfg, flags_main_capacity or main_capacity,
                         flags_lsh_capacity or lsh_capacity, pending.any())
    return state, pending, flags


# ======================================================================
# cold-tier variants (cfg.cold_enabled): the same pipelines plus the cold
# Bloom route / cache probe and the wanted/missing fetch protocol
# ======================================================================
def _staging_arena(state: PFOState, cfg: PFOConfig) -> torch.Tensor | None:
    """The cold MainTable cache's payload pages as one
    (cold_cache_slots * seg_cap, d) arena (a view); staging slot
    ``store_capacity + e*seg_cap + r`` addresses row r of cache entry e."""
    vecs = state.cold.main_cache.vecs
    if vecs is None:
        return None
    return vecs.reshape(-1, vecs.shape[-1])


def _main_lookup_cold(state: PFOState, ids: torch.Tensor, cfg: PFOConfig,
                      active: torch.Tensor | None = None):
    """(N,) id -> (slot, found, unresolved, wanted, missing, probed, fp).

    Hot forest, then the device ring, then the cold cache — newest
    first (every ring segment is younger than every cold segment).  Rows
    resolved by a hotter tier are masked out of the cold route, so a
    stale cold copy of a live id never triggers a fetch.
    ``unresolved`` marks rows whose Bloom route hit a non-resident cold
    segment: the caller fetches (``missing``) and retries them."""
    mh, mtree = main_table_keys(ids, cfg)
    val, found = forest_lookup_masked(state.main_forest, mtree, mh, ids,
                                      main_tree_config(cfg))
    sval, sfound = snap_mod.lookup_key_run(
        snap_mod.one(state.main_snaps), mh, ids, _snap_cfg_main(cfg))
    cold_ids = torch.where(found | sfound, -1, ids)
    if active is not None:
        cold_ids = torch.where(active, cold_ids, -1)
    cval, cfound, row_missing, wanted, missing, probed, fp = \
        coldtier.cold_lookup_main(state.cold, mh, cold_ids,
                                  _snap_cfg_main(cfg))
    # a non-resident matched segment may hold a NEWER copy of the id than
    # any resident one: never resolve a row through the cold cache while
    # part of its route is missing; it retries after the fetch
    cfound = cfound & ~row_missing
    slot = torch.where(found, val, torch.where(
        sfound, sval, torch.where(cfound, cval, -1)))
    found_any = found | sfound | cfound
    unresolved = ~found_any & row_missing
    return slot, found_any, unresolved, wanted, missing, probed, fp


def query_step_cold(state: PFOState, qvecs: torch.Tensor, cfg: PFOConfig,
                    k: int):
    """Batched kNN query over hot + ring + cold tiers.

    :func:`query_step` plus the cold Bloom route: cold candidates come
    from the matched segments resident in the device cache, and the
    (wanted, missing) masks of both tiers come back with the results.
    Candidates that resolve to a *staging* slot rank straight out of
    the cold payload arena (the ``gather_rank_staged`` kernel).
    Returns (ids, dists, wanted_l, missing_l, wanted_m, missing_m,
    info) with info the (10,) cold accounting vector."""
    q = qvecs.shape[0]
    h, cand = _hot_sealed_candidates(state, qvecs, cfg)
    ccand, wanted_l, missing_l, lsh_probed, lsh_fp = \
        coldtier.cold_probe_lsh(state.cold, h, _snap_cfg_lsh(cfg))
    cids = _dedupe_candidates(torch.cat([cand, ccand.to(cand.dtype)], 1),
                              state.tombstones, cfg)
    slot, found, _, wanted_m, missing_m, m_probed, m_fp = \
        _main_lookup_cold(state, cids.reshape(-1), cfg)
    slot, found = slot.reshape(q, -1), found.reshape(q, -1)
    top_ids, top_d = _rank_candidates(state, qvecs, cids, slot, found, cfg,
                                      k, staging=_staging_arena(state, cfg))
    valid = (cids >= 0) & found & (slot >= 0)
    info = coldtier.pack_cold_info(
        wanted_l, missing_l, lsh_probed, lsh_fp, wanted_m, missing_m,
        m_probed, m_fp, (valid & (slot >= cfg.store_capacity)).sum(),
        valid.sum())
    return top_ids, top_d, wanted_l, missing_l, wanted_m, missing_m, info


def delete_step_cold(state: PFOState, ids: torch.Tensor, active: torch.Tensor,
                     cfg: PFOConfig, main_capacity: int, lsh_capacity: int,
                     flags_main_capacity: int | None = None,
                     flags_lsh_capacity: int | None = None):
    """Cold-tier batched delete: :func:`delete_step` with the MainTable
    lookup extended through the cold cache.  A row whose id resolves
    only through a *non-resident* cold segment stays pending, and the
    flag word carries COLD_MISS: the host fetches the returned missing
    segments before the retry round.
    Returns (state, pending, flags, wanted_m, missing_m)."""
    slot, found, unresolved, wanted_m, missing_m, _, _ = \
        _main_lookup_cold(state, ids, cfg, active=active)
    ok = active & found & (slot >= 0)
    state, pending = _delete_apply(state, ids, slot, ok, cfg, main_capacity,
                                   lsh_capacity,
                                   staging=_staging_arena(state, cfg))
    pending = pending | (active & unresolved)
    flags = _round_flags(state, cfg, flags_main_capacity or main_capacity,
                         flags_lsh_capacity or lsh_capacity, pending.any(),
                         cold_miss=missing_m.any())
    return state, pending, flags, wanted_m, missing_m


# ======================================================================
# host orchestrator
# ======================================================================
def _pickup(tensors) -> list[np.ndarray]:
    """Bring device tensors to the host in ONE transfer.  Every value the
    steps return (int32 ids and counts, float32 distances, bools) is
    exact in float64, so they travel packed in one float64 buffer and
    come back as float64 arrays of their own shapes."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def round_capacities(cfg: PFOConfig, n: int) -> tuple[int, int]:
    """(main, lsh) per-tree mailbox capacities of an ``n``-row round:
    twice the even spread over the trees, at least 8.  The distributed
    backend sizes its receive-side mailboxes with the same numbers, so
    its flag word fires epochs at the same rounds."""
    total = cfg.L * cfg.n_trees
    lsh = (n * cfg.L + total - 1) // total
    main = (n + cfg.main_n_trees - 1) // cfg.main_n_trees
    return int(max(8, 2 * main)), int(max(8, 2 * lsh))


class PFOIndex:
    """Host-side orchestrator: owns the device state, runs dispatch rounds and
    seal/merge epochs (the paper's maintenance routines).

    Every step returns a packed int32 flag word and the host performs
    exactly ONE explicit scalar readback per round (:meth:`_read_flags`,
    counted in ``sync_count``).  The flag word is carried across calls,
    so the standalone ``round_flags`` probe only runs on the first round
    after init or after a maintenance epoch, or when a call's dispatch
    capacity grows beyond what the carried word was computed for.

    ``device`` None means CUDA (and raises without it); ``proj`` None
    draws the SRP projections from a ``torch.Generator`` seeded with
    ``seed``.  A JAX index's projections carry over with
    :func:`repro_torch.convert.proj_from_numpy`.  ``cold_dir`` selects
    file backing for the cold tier's segments (mmap'd flash files);
    None keeps them in host RAM.
    """

    MAX_ROUNDS = 64

    def __init__(self, cfg: PFOConfig, seed: int = 0, device=None,
                 proj: dict | None = None, obs: Obs | None = None,
                 cold_dir: str | None = None):
        self.cfg = cfg
        self.device = default_device(device)
        if proj is None:
            proj = make_projections(cfg, torch.Generator().manual_seed(seed),
                                    self.device)
        proj = {k: torch.as_tensor(v, dtype=torch.float32).to(self.device)
                for k, v in proj.items()}
        self.state = init_state(cfg, proj)
        self.n_inserted = 0
        self.rounds_log: list[int] = []
        self.sync_count = 0          # explicit host<->device scalar syncs
        self.maintenance_log: list[str] = []    # "seal" / "merge"
        self._flags: int | None = None
        self._flags_caps = (0, 0)    # (main_cap, lsh_cap) of self._flags
        self.cold: coldtier.ColdManager | None = None
        self._delete_miss = None     # device masks stashed by delete rounds
        if cfg.cold_enabled:
            self.cold = coldtier.ColdManager(
                cfg, _snap_cfg_lsh(cfg), _snap_cfg_main(cfg),
                main_tree_config(cfg), self.device, root=cold_dir,
                on_sync=self._count_sync)
        self.set_obs(obs if obs is not None else Obs())

    def _count_sync(self) -> None:
        self.sync_count += 1

    # -- observability --------------------------------------------------
    def set_obs(self, obs: Obs) -> None:
        """Bind an observability handle; the index's counters mirror into
        gauges lazily at snapshot time, and the cold manager inherits the
        same handle."""
        self.obs = obs
        obs.on_snapshot("index", self._mirror_obs)
        if self.cold is not None:
            self.cold.set_obs(obs)

    def _mirror_obs(self) -> None:
        o = self.obs
        o.gauge("index.readbacks").set(self.sync_count)
        o.gauge("index.items_inserted").set(self.n_inserted)

    def _epoch(self, name: str, fn, *args):
        """Run one maintenance epoch under a span + its latency histogram
        (``index.maint_ms{epoch=...}``)."""
        t0 = time.perf_counter()
        with self.obs.span(name):
            out = fn(*args)
        self.obs.histogram("index.maint_ms", epoch=name).observe(
            (time.perf_counter() - t0) * 1e3)
        return out

    # -- device-resident maintenance -----------------------------------
    def _read_flags(self, flags: torch.Tensor, caps: tuple[int, int]) -> int:
        """THE host<->device sync of a round: one explicit i32 readback."""
        self.sync_count += 1
        f = int(flags.item())
        self._flags, self._flags_caps = f, caps
        return f

    def _ensure_flags(self, mcap: int, lcap: int) -> int:
        """Flags valid for a round at (mcap, lcap), reusing the carried
        word when it was computed for capacities at least this large."""
        if (self._flags is not None and self._flags_caps[0] >= mcap
                and self._flags_caps[1] >= lcap):
            return self._flags
        return self._read_flags(round_flags(self.state, self.cfg, mcap, lcap),
                                (mcap, lcap))

    def _spill(self) -> None:
        """One spill epoch, compacting the cold tier first if it is full."""
        if self.cold.n_cold >= self.cfg.cold_segments:
            self.state = self._epoch("cold_compact", self.cold.compact,
                                     self.state)
            self.maintenance_log.append("cold_compact")
        self.state = self._epoch("spill", self.cold.spill, self.state)
        self.maintenance_log.append("spill")

    def _maintain(self, flags: int) -> None:
        """Run the seal/merge/spill epochs the flag word asks for."""
        if self.cold is not None:
            before = self.cold.counters["compactions"]
            self.state = self.cold.compact_maybe_install(self.state)
            if self.cold.counters["compactions"] != before:
                self.maintenance_log.append("cold_compact")
                self._flags = None
        if flags & FLAG_NEED_SEAL:
            if flags & FLAG_COLD_SPILL:
                # capacity relief with a cold tier: spill, never merge
                self._spill()
            elif flags & FLAG_SNAPS_FULL:
                self.state = self._epoch("merge", merge_step, self.state,
                                         self.cfg)
                self.maintenance_log.append("merge")
            self.state = self._epoch("seal", seal_step, self.state, self.cfg)
            self.maintenance_log.append("seal")
        elif (flags & FLAG_STORE_FULL) and (flags & FLAG_COLD_SPILL):
            # store pressure without arena pressure: spill the oldest ring
            # segment so its payload rows leave the dense store
            self._spill()
        if flags & FLAG_TOMBS_FULL:
            if self.cold is not None:
                self._epoch("merge", self._merge_with_cold)
            else:
                self.state = self._epoch("merge", merge_step, self.state,
                                         self.cfg)
            self.maintenance_log.append("merge")
        if self.cold is not None and flags & FLAG_COLD_FULL:
            self.cold.compact_start_async()
        if flags & (FLAG_NEED_SEAL | FLAG_TOMBS_FULL | FLAG_STORE_FULL):
            self._flags = None       # state changed; carried word is stale

    def _merge_with_cold(self) -> None:
        """Cold-enabled merge epoch: the tombstones drain into a host fold
        over ring + cold segments (dead ids physically dropped from every
        sealed copy), the ring resets, and the device buffer clears in
        the same epoch."""
        self._count_sync()
        tombs = self.state.tombstones.cpu().numpy()
        self.state = self.cold.merge_cold(self.state, tombs)
        self.state = self.state._replace(
            tombstones=torch.full_like(self.state.tombstones, -1),
            n_tombstones=torch.zeros_like(self.state.n_tombstones))

    # -- public API ----------------------------------------------------
    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids).to(self.device, torch.int32)

    def _vecs(self, vecs) -> torch.Tensor:
        return torch.as_tensor(vecs).to(self.device, torch.float32)

    def insert(self, ids, vecs) -> int:
        """Insert a batch; returns the number of dispatch rounds used."""
        ids, vecs = self._ids(ids), self._vecs(vecs)
        n = int(ids.shape[0])
        dev = self.device
        slots = torch.full((n,), -2, dtype=torch.int32, device=dev)
        main_active = torch.ones((n,), dtype=torch.bool, device=dev)
        lsh_active = torch.ones((n * self.cfg.L,), dtype=torch.bool,
                                device=dev)
        mcap, lcap = round_capacities(self.cfg, n)
        t0 = time.perf_counter()
        with self.obs.span("insert", n=n):
            flags = self._ensure_flags(mcap, lcap)
            rounds = 0
            for _ in range(self.MAX_ROUNDS):
                self._maintain(flags)
                self.state, slots, main_active, lsh_active, fw = insert_step(
                    self.state, ids, vecs, slots, main_active, lsh_active,
                    self.cfg, mcap, lcap)
                rounds += 1
                flags = self._read_flags(fw, (mcap, lcap))
                if not flags & FLAG_ANY_PENDING:
                    break
        self.obs.histogram("index.op_ms", op="insert").observe(
            (time.perf_counter() - t0) * 1e3)
        self.n_inserted += n
        self.rounds_log.append(rounds)
        return rounds

    def query(self, qvecs, k: int = 10):
        """kNN of each query row: host numpy (ids (Q,k), dists (Q,k)),
        picked up from the device in one transfer."""
        qvecs = self._vecs(qvecs)
        t0 = time.perf_counter()
        with self.obs.span("query", n=int(qvecs.shape[0]), k=k):
            if self.cold is None:
                ids, dists = _pickup(query_step(self.state, qvecs, self.cfg,
                                                k))
            else:
                ids, dists = self._query_cold(qvecs, k)
        self.obs.histogram("index.op_ms", op="query").observe(
            (time.perf_counter() - t0) * 1e3)
        return ids.astype(np.int32), dists.astype(np.float32)

    def _query_cold(self, qvecs: torch.Tensor, k: int, overlap=None):
        """Cold-tier query loop: probe; on a cold-cache miss fetch the
        Bloom-matched segments and re-probe.  A round that hits no
        non-resident cold segment does exactly ONE device->host pickup:
        results, masks and accounting travel together.  ``overlap`` (a
        stream engine's double-buffer hook) fires right after the first
        dispatch, before its blocking pickup.  Returns host (ids,
        dists)."""
        for attempt in range(self.cfg.cold_fetch_rounds + 1):
            out = query_step_cold(self.state, qvecs, self.cfg, k)
            if attempt == 0 and overlap is not None:
                overlap()            # first dispatch is in flight
            ids, dists, wl, ml, wm, mm, info = _pickup(out)
            wl, ml, wm, mm = (m.astype(bool) for m in (wl, ml, wm, mm))
            self.cold.record_query_round(info)
            if not (ml.any() or mm.any()):
                break
            if attempt == self.cfg.cold_fetch_rounds:
                # fetch budget exhausted with matches still missing: the
                # results lack those segments' candidates — counted
                self.cold.counters["incomplete_query_rounds"] += 1
                break
            before = self.cold.counters["fetches"]
            with self.obs.span("cold_fetch", attempt=attempt):
                self.state = self.cold.fetch(self.state, wl, ml, wm, mm)
            if self.cold.counters["fetches"] == before:
                # every cache slot is wanted by this round: the missing set
                # can never drain (cache undersized for the fan-out)
                self.cold.counters["incomplete_query_rounds"] += 1
                break
        return ids, dists

    def delete(self, ids) -> int:
        ids = self._ids(ids)
        active = torch.ones(ids.shape, dtype=torch.bool, device=self.device)
        n = int(ids.shape[0])
        mcap, lcap = round_capacities(self.cfg, n)
        t0 = time.perf_counter()
        with self.obs.span("delete", n=n):
            flags = self._ensure_flags(mcap, lcap)
            rounds = 0
            for _ in range(self.MAX_ROUNDS):
                self._maintain(flags)
                if self.cold is None:
                    self.state, pending, fw = delete_step(
                        self.state, ids, active, self.cfg, mcap, lcap)
                else:
                    self.state, pending, fw, wm, mm = delete_step_cold(
                        self.state, ids, active, self.cfg, mcap, lcap)
                    self._delete_miss = (wm, mm)
                rounds += 1
                flags = self._read_flags(fw, (mcap, lcap))
                self.fetch_delete_miss(flags)
                if not flags & FLAG_ANY_PENDING:
                    break
                active = pending
        self.obs.histogram("index.op_ms", op="delete").observe(
            (time.perf_counter() - t0) * 1e3)
        return rounds

    def fetch_delete_miss(self, flags: int) -> None:
        """COLD_MISS service: a delete round's MainTable probe matched a
        non-resident cold segment — read the stashed masks (the only
        extra readback, and only on miss rounds) and fetch before the
        retry round.  A miss round where the cache can install nothing
        (every slot is wanted by this very round) could never make
        progress, so it raises: the cache is undersized for the
        workload's per-row Bloom fan-out."""
        if self.cold is None or not flags & FLAG_COLD_MISS \
                or self._delete_miss is None:
            return
        self._count_sync()
        wm, mm = _pickup(self._delete_miss)
        wm, mm = wm.astype(bool), mm.astype(bool)
        self._delete_miss = None
        zeros = np.zeros((self.cfg.L, self.cfg.cold_segments), bool)
        before = self.cold.counters["fetches"]
        with self.obs.span("cold_fetch", path="delete"):
            self.state = self.cold.fetch(self.state, zeros, zeros, wm, mm)
        if mm.any() and self.cold.counters["fetches"] == before:
            raise RuntimeError(
                f"delete cannot resolve: its Bloom route spans "
                f"{int(wm.sum())} cold segments but cold_cache_slots="
                f"{self.cfg.cold_cache_slots} cannot hold them at once; "
                "raise PFOConfig.cold_cache_slots")

    def update(self, ids, vecs) -> None:
        """Online update (paper §5): new version written, old reclaimed."""
        self.delete(ids)
        self.insert(ids, vecs)

    def stats(self) -> dict:
        st = self.state
        out = {
            "items_hot": int(st.main_forest.n_items.sum()),
            "lsh_leaves": int(st.lsh_forest.n_items.sum()),
            "snapshots": int(st.main_snaps.n_snaps),
            "tombstones": int(st.n_tombstones),
            "store_free": int(st.store.free_top),
            "overflow_events": int(st.lsh_forest.overflow.sum()),
            "stamp": int(st.stamp),
        }
        if self.cold is not None:
            out["cold"] = self.cold.stats()
        return out
