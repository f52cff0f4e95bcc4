"""Distributed PFO — the paper's parallel design over ``torch.distributed``.

Placement, as in the JAX package's ``core/distributed.py``:

* **hash trees** (all L tables) shard over ``model`` — contiguous blocks
  of global tree ids per rank, the actor-pool-per-core of §4.2 scaled
  to devices;
* the **MainTable** (id -> slot, vectors) shards over ``model`` by
  murmur owner — every id has exactly one home rank (the single-copy
  invariant of §3.1);
* **queries** split their rows over ``data`` while the state is
  replicated over it, so **updates** enter replicated and every data
  replica applies the identical round.

The JAX package runs one program over a mesh (``shard_map``); the port
runs SPMD, one process per device (``sharding.policy.stream_mesh``):
each rank holds its own shard of the state (a ``PFOState`` whose forests
hold its ``trees_per_shard`` trees, whose store holds
``store_capacity // n_model`` rows, and whose LSH ring is one mixed-table
ring with the table id in ``vals``), and every ``local_fn`` of the
reference is a per-rank function here with explicit collectives on the
mesh's groups.

Query protocol (collectives over ``model``):
  1. each rank hashes its contiguous block of query rows once; (row,
     table) probe requests route to the tree-owner rank, and the key
     blocks travel in the same ``all_to_all``, so every rank holds the
     whole key table for its sealed and cold probes;
  2. the tree owner descends only the trees it owns and probes its local
     sealed ring and cold routing table;
  3. candidate ids route by one ``all_to_all`` to their murmur owner,
     which looks up the vector (hot store, ring, or cold staging arena)
     and exact-ranks it against its query (plain torch: one candidate
     against one query a row, the reference's inline formula);
  4. the (id, row, dist) partials ``all_gather`` over ``model``, and
     every rank keeps the deduped global top-k.

Update protocol: senders partition the batch into contiguous per-rank
blocks (so the per-tree apply order is the batch order), route (h, id)
to tree owners and (id, vec) to murmur owners in ONE ``all_to_all``;
receivers re-dispatch into per-tree mailboxes at single-device
capacity.  Overflow at either hop is *acked back* to the sender in ONE
reverse ``all_to_all`` and re-submitted by the host next round.  Every
round ends in ONE ``all_reduce(MAX)`` that combines the pending masks
and the flag word's headroom terms, so every rank reads the same packed
flag word: one readback a round, and every host decision taken from it
is the same on every rank.  Payloads travel as int32 columns; floats
and uint32 keys ride bit-for-bit (``Tensor.view``), never value-cast,
so ids above 2^24 survive routing.

The port's repairs hold here too: a shard's MainTable ring lookup is
``snapshots.lookup_key_run`` (the reference's ``lookup_exact`` misses
ids past the bucket budget), and ``dense_free`` frees a slot only while
it is still its id's (the reference checks liveness only).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops as kops
from . import coldtier
from . import snapshots as snap_mod
from .config import PFOConfig
from .dispatch import (COLLECTIVES, all_to_all_route, dispatch_to_trees,
                       gather_mailbox, mailbox_ids, owner_of_tree,
                       pack_round_flags)
from .hash_tree import (forest_delete_dispatched, forest_headroom,
                        forest_insert_dispatched, forest_lookup_masked,
                        forest_query_masked, forest_replace_dispatched,
                        init_forest, reset_forest_)
from .index import (INT_MAX, PFOState, _cold_full_threshold, _tombs_threshold,
                    free_displaced,
                    lsh_tree_config, main_tree_config)
from .lsh import main_table_keys, make_projections, region_ids
from .membership import member_sorted
from .scatter import masked_put_
from .store import dense_alloc, dense_free, dense_init, dense_read_tiered

MASK32 = 0xFFFFFFFF


class DistConfig(NamedTuple):
    """The index config and the number of model shards (the mesh, not
    the config, names the groups the shards talk over)."""
    pfo: PFOConfig
    n_model: int = 16

    @property
    def trees_per_shard(self) -> int:
        total = self.pfo.L * self.pfo.n_trees
        if total % self.n_model:
            raise ValueError(f"{total} LSH trees do not split over "
                             f"{self.n_model} model shards")
        return total // self.n_model

    @property
    def main_trees_per_shard(self) -> int:
        if self.pfo.main_n_trees % self.n_model:
            raise ValueError(f"{self.pfo.main_n_trees} MainTable trees do "
                             f"not split over {self.n_model} model shards")
        return self.pfo.main_n_trees // self.n_model


def shard_snap_cfg(dcfg: DistConfig) -> PFOConfig:
    cap = dcfg.trees_per_shard * dcfg.pfo.max_leaves_per_tree
    return PFOConfig(**{**dcfg.pfo.__dict__, "snapshot_capacity": cap})


def shard_main_snap_cfg(dcfg: DistConfig) -> PFOConfig:
    cap = dcfg.main_trees_per_shard * dcfg.pfo.main_max_leaves_per_tree
    # store_capacity shrinks to the shard's dense-store rows, so the cold
    # staging-slot encoding (store_capacity + arena row) starts exactly
    # at the shard's tiered-read boundary
    return PFOConfig(**{**dcfg.pfo.__dict__, "snapshot_capacity": cap,
                        "store_capacity":
                            dcfg.pfo.store_capacity // dcfg.n_model,
                        "store_low_watermark": 0})


def shard_cold_cfg(dcfg: DistConfig) -> PFOConfig:
    """A shard's cold-tier driver config: its cold chain is one
    mixed-table segment sequence (it mirrors the shard's mixed ring,
    table id in ``vals``), so the cold machinery runs with ``L == 1``."""
    return PFOConfig(**{**dcfg.pfo.__dict__, "L": 1})


def dist_fresh_rings(dcfg: DistConfig, mesh):
    """Empty rings for this rank's shard: the mixed LSH ring (a batch of
    one) and the MainTable ring."""
    return (snap_mod.init_snapshots(shard_snap_cfg(dcfg), 1, mesh.device),
            snap_mod.unbatch(snap_mod.init_snapshots(
                shard_main_snap_cfg(dcfg), 1, mesh.device)))


def dist_init_state(dcfg: DistConfig, mesh, proj: dict | None = None,
                    seed: int = 0) -> PFOState:
    """This rank's empty shard of the distributed state.  ``proj`` None
    draws the SRP projections from a CPU generator seeded with ``seed``,
    so every rank draws the same ones."""
    cfg = dcfg.pfo
    dev = mesh.device
    if proj is None:
        proj = make_projections(cfg, torch.Generator().manual_seed(seed))
    proj = {k: torch.as_tensor(np.array(v, np.float32)).to(dev)
            if not torch.is_tensor(v) else v.to(dev, torch.float32)
            for k, v in proj.items()}
    cold = None
    if cfg.cold_enabled:
        if cfg.store_low_watermark:
            # the store watermark needs per-shard free-list flag plumbing
            # the distributed rounds do not have: refuse, never mis-spill
            raise ValueError("store_low_watermark is not supported on the "
                             "distributed backend")
        cold = coldtier.init_cold(shard_cold_cfg(dcfg), shard_snap_cfg(dcfg),
                                  shard_main_snap_cfg(dcfg), dev)
    lsnaps, msnaps = dist_fresh_rings(dcfg, mesh)
    i32 = dict(dtype=torch.int32, device=dev)
    return PFOState(
        lsh_forest=init_forest(lsh_tree_config(cfg), dcfg.trees_per_shard,
                               dev),
        main_forest=init_forest(main_tree_config(cfg),
                                dcfg.main_trees_per_shard, dev),
        store=dense_init(cfg.store_capacity // dcfg.n_model, cfg.dim, dev),
        lsh_snaps=lsnaps, main_snaps=msnaps,
        tombstones=torch.full((cfg.max_tombstones,), -1, **i32),
        n_tombstones=torch.tensor(0, **i32),
        stamp=torch.tensor(0, **i32),
        proj=proj, cold=cold)


# ======================================================================
# collectives and routing (over the mesh's model group)
# ======================================================================
def _i32(x: torch.Tensor) -> torch.Tensor:
    """Integers below 2^32 (uint32 keys held in int64, or ids) as int32
    with the same 32 bits."""
    x = x.to(torch.int64)
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def _bits_f32(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.float32)


def _reduce_max(group, *tensors):
    """ONE ``all_reduce(MAX)`` of several integer or bool tensors (as
    int32); returns each combined, in its own shape, as int32."""
    flat = torch.cat([t.reshape(-1).to(torch.int32) for t in tensors])
    COLLECTIVES["all_reduce"] += 1
    dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def _all_gather(group, size: int, x: torch.Tensor) -> torch.Tensor:
    """ONE ``all_gather`` of a same-shaped tensor: (size, *x.shape)."""
    parts = [torch.empty_like(x) for _ in range(size)]
    COLLECTIVES["all_gather"] += 1
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


class _Route:
    """One routed request set: rows of an int32 ``payload`` bound for
    ``dest`` ranks, packed into (S, capacity) per-destination mailboxes
    (:func:`dispatch_to_trees` with rank == tree).  The ``marker_col``
    column must be id-like: it reads -1 in empty mailbox slots, so a
    receiver tells padding from the payload itself."""

    def __init__(self, payload: torch.Tensor, dest: torch.Tensor, S: int,
                 capacity: int, marker_col: int = 0):
        self.n = dest.shape[0]
        self.mbox, self.send_ovf = dispatch_to_trees(dest, S, capacity)
        (buf,) = gather_mailbox(self.mbox, payload)
        buf[..., marker_col] = torch.where(self.mbox >= 0,
                                           buf[..., marker_col], -1)
        self.buf = buf                                           # (S, K, C)

    def ack(self, back: torch.Tensor) -> torch.Tensor:
        """A receiver-side failure mask sent back (S*K, 1) -> the
        sender's (N,) rows."""
        flat = self.mbox.reshape(-1)
        sent = flat >= 0
        out = torch.zeros(self.n + 1, dtype=torch.bool, device=flat.device)
        out[torch.where(sent, flat, self.n)] = sent & (back.reshape(-1) > 0)
        return out[:self.n]


def _block(n: int, S: int, me: int) -> tuple[int, int]:
    """This rank's contiguous block of ``n`` rows, padded to ``S * per``:
    (start, per).  Blocks, not strides, so the receive-side apply order —
    sender-major, then slot order — is the batch order."""
    per = -(-n // S)
    return me * per, per


def _pad_rows(x: torch.Tensor, rows: int, value=0) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    pad = torch.full((rows - x.shape[0], *x.shape[1:]), value,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _flag_terms(state: PFOState) -> torch.Tensor:
    """This shard's max-combined flag inputs: worst-tree cursors of both
    forests, ring occupancy and cold occupancy."""
    leaf_head, node_head = forest_headroom(state.lsh_forest)
    mleaf, mnode = forest_headroom(state.main_forest)
    n_cold = (state.cold.n_cold if state.cold is not None
              else torch.zeros((), dtype=torch.int32,
                               device=state.stamp.device))
    return torch.stack([t.to(torch.int32) for t in (
        leaf_head, node_head, mleaf, mnode, state.lsh_snaps.n_snaps[0],
        n_cold)])


def _flags_from(terms: torch.Tensor, state: PFOState, dcfg: DistConfig,
                fm: int, fl: int, any_pending: torch.Tensor,
                cold_miss: torch.Tensor | None = None) -> torch.Tensor:
    """The packed flag word from max-combined :func:`_flag_terms`, with
    the thresholds of ``index._round_flags``: a distributed engine seals,
    merges and spills at the same rounds as a single-device one fed the
    same trace."""
    cfg = dcfg.pfo
    leaf_head, node_head, mleaf, mnode, n_snaps, n_cold = terms
    need_seal = (
        (leaf_head + fl > cfg.max_leaves_per_tree)
        | (node_head + fl > cfg.max_nodes_per_tree)
        | (mleaf + fm > cfg.main_max_leaves_per_tree)
        | (mnode + fm > cfg.main_max_nodes_per_tree)
        | (leaf_head >= int(cfg.seal_threshold * cfg.max_leaves_per_tree)))
    snaps_full = n_snaps >= cfg.max_snapshots - 1
    tombs_full = state.n_tombstones >= _tombs_threshold(cfg)
    if cfg.cold_enabled:
        # capacity relief is a spill, never a merge; every shard spills
        # in the same epoch (lockstep rings, max-combined bit)
        return pack_round_flags(
            any_pending, need_seal, torch.zeros_like(any_pending),
            tombs_full, cold_spill=snaps_full,
            cold_full=n_cold >= _cold_full_threshold(cfg),
            cold_miss=cold_miss)
    return pack_round_flags(any_pending, need_seal, snaps_full, tombs_full)


def make_dist_round_flags(dcfg: DistConfig, mesh, flags_main: int,
                          flags_lsh: int):
    """Cold-start flag probe (the first round, or after an epoch; steady
    rounds get their word from the step itself): one ``all_reduce``."""
    def step(state: PFOState) -> torch.Tensor:
        (terms,) = _reduce_max(mesh.model_group, _flag_terms(state))
        no = torch.zeros((), dtype=torch.bool, device=terms.device)
        return _flags_from(terms, state, dcfg, flags_main, flags_lsh, no)
    return step


def _keys_and_trees(state: PFOState, vecs: torch.Tensor, cfg: PFOConfig):
    """(N, d) -> compound keys (N, L) and global tree ids (N, L)."""
    h = kops.lsh_hash(vecs, state.proj["table_proj"], cfg.M)
    region = region_ids(h, state.proj["part_proj"], cfg)
    off = torch.arange(cfg.L, device=h.device)[None] * cfg.n_trees
    return h, region + off


# ======================================================================
# query
# ======================================================================
def _dedup_topk(pid: torch.Tensor, pd: torch.Tensor, k: int):
    """Per row: top-k by distance over (id, dist) partials, each id
    once (every copy of an id carries the same distance: one owner
    ranked it).  (Q, W) -> ids (Q, k) (-1 past the finite ones), dists."""
    q, w = pid.shape
    if w < k:
        pid = _pad_rows(pid.t(), k, -1).t()
        pd = _pad_rows(pd.t(), k, float("inf")).t()
    sid, order = torch.sort(torch.where(pid >= 0, pid, INT_MAX), dim=1,
                            stable=True)
    dup = torch.cat([torch.zeros((q, 1), dtype=torch.bool,
                                 device=pid.device),
                     sid[:, 1:] == sid[:, :-1]], 1)
    sd = torch.where(dup, float("inf"), pd.gather(1, order))
    neg, top = torch.topk(-sd, k, dim=1)
    ids = torch.where(torch.isfinite(neg), sid.gather(1, top), -1)
    return ids, -neg


def _totals(sums: torch.Tensor, cold: bool) -> torch.Tensor:
    """Per-rank query summaries (R, n) combined: counts summed, the
    trailing miss flag (cold tier) max-combined; int32."""
    if not cold:
        return sums.sum(0).to(torch.int32)
    return torch.cat([sums[:, :-1].sum(0).to(torch.int32),
                      sums[:, -1:].amax(0).to(torch.int32)])


def dist_views(state: PFOState):
    """The (table, key) views of a shard's mixed sealed ring and, with a
    cold tier, of its cold segment cache (``snapshots.mixed_view``):
    valid until the ring or the cache changes."""
    r = state.lsh_snaps
    ring = snap_mod.mixed_view(r.keys, r.ids, r.vals)
    if state.cold is None:
        return ring, None
    c = state.cold.lsh_cache
    return ring, snap_mod.mixed_view(c.keys, c.ids, c.vals)


def make_dist_query(dcfg: DistConfig, mesh, k: int,
                    with_drop_count: bool = False):
    """Distributed query: fn(state, qvecs (Q, d)[, views]) -> ids, dists
    (Q, k).  ``views`` are :func:`dist_views` of ``state`` (computed when
    not given; a backend keeps them until the ring or cache changes).

    Every rank passes the whole batch and gets the whole answer: the
    rows split over ``data`` (Q divides by ``n_data``), and the answers
    ``all_gather`` back over it.  ``with_drop_count`` adds a 0-d count
    of candidates dropped by owner-mailbox skew (queries have no retry
    round).  With a cold tier the outputs go on with this shard's
    (C,) wanted/missing masks of both tiers (OR-combined over ``data``,
    so the replicas of a shard fetch alike and their caches stay
    equal), the (10,) cold accounting vector summed over every rank,
    and a 0-d flag: whether any rank's shard missed a segment — the same
    on every rank, so every rank takes the same fetch loop."""
    cfg = dcfg.pfo
    tcfg, mcfg = lsh_tree_config(cfg), main_tree_config(cfg)
    tps, mtps = dcfg.trees_per_shard, dcfg.main_trees_per_shard
    T, MT = cfg.L * cfg.n_trees, cfg.main_n_trees     # global tree counts
    snap_cfg, msnap_cfg = shard_snap_cfg(dcfg), shard_main_snap_cfg(dcfg)
    S, D, L = dcfg.n_model, mesh.n_data, cfg.L
    me, di = mesh.shard, mesh.data_index
    cold = cfg.cold_enabled

    def step(state: PFOState, qvecs: torch.Tensor, views=None):
        Q = qvecs.shape[0]
        if Q % D:
            raise ValueError(f"{Q} query rows do not split over {D} "
                             "data replicas")
        ql = Q // D
        dev = qvecs.device
        qloc = qvecs[di * ql:(di + 1) * ql]
        # --- hash once: each rank hashes only its block of rows --------
        start, per = _block(ql, S, me)
        qblk = _pad_rows(qloc, S * per)[start:start + per]
        hb, gtb = _keys_and_trees(state, qblk, cfg)              # (per, L)

        # --- route (row, table) probes to the tree-owner rank; the key
        # blocks ride the same all_to_all, so every rank gets the key
        # table of all ql rows for its sealed and cold probes
        gflat = gtb.reshape(-1)
        rowb = start + torch.arange(per, device=dev)
        psend = (rowb < ql).repeat_interleave(L)
        ppay = torch.stack([_i32(hb.reshape(-1)),
                            rowb.repeat_interleave(L).to(torch.int32),
                            (gflat % tps).to(torch.int32)], 1)
        # per-owner capacity: 2x the even spread + per-table slack, capped
        # at the sender total (skew past it DROPS probes, counted below)
        kp = min(per * L, 2 * ((per * L) // S) + 2 * L)
        route_p = _Route(ppay, torch.where(psend, owner_of_tree(gflat, T, S),
                                          -1), S, kp, marker_col=1)
        keys_out = _i32(hb.reshape(1, per * L, 1)).expand(S, per * L, 1)
        precv, keys_in = all_to_all_route([route_p.buf, keys_out],
                                           mesh.model_group)
        h = _u32(keys_in.reshape(S * per, L))[:ql]              # (ql, L)
        rq_p = precv[:, 1]
        pvalid = rq_p >= 0
        ids_p, _, _ = forest_query_masked(
            state.lsh_forest, torch.where(pvalid, precv[:, 2], 0),
            _u32(precv[:, 0]), tcfg)
        # regroup the descents by query row (capacity L is exact: a row
        # sends one probe per table)
        rbox, _ = dispatch_to_trees(torch.where(pvalid, rq_p, -1), ql, L)
        (hot_g,) = gather_mailbox(rbox, torch.where(pvalid[:, None], ids_p,
                                                    -1))
        hot = torch.where((rbox >= 0)[:, :, None], hot_g, -1).reshape(ql, -1)

        # --- the shard's mixed sealed ring and cold chain, through their
        # (table, key) views: each table reads its own run of a bucket
        ring_view, cold_view = views if views is not None \
            else dist_views(state)
        sealed = snap_mod.probe_mixed(state.lsh_snaps, ring_view,
                                      h.t().contiguous(), snap_cfg)
        sealed = sealed.permute(1, 0, 2).reshape(ql, -1)
        parts = [hot.to(torch.int64), sealed.to(torch.int64)]
        if cold:
            ccand, wl, ml, lsh_probed, lsh_fp = coldtier.cold_probe_lsh_mixed(
                state.cold, h, snap_cfg, view=cold_view)
            parts.append(ccand.to(torch.int64))
        cand = torch.cat(parts, 1)

        # --- tombstone filter, dedupe, truncate to the per-shard budget --
        dead = member_sorted(cand, state.tombstones.to(torch.int64)) \
            & (cand >= 0)
        skey = torch.sort(torch.where((cand >= 0) & ~dead, cand, INT_MAX),
                          dim=1).values
        dup = torch.cat([torch.zeros((ql, 1), dtype=torch.bool, device=dev),
                         skey[:, 1:] == skey[:, :-1]], 1)
        uniq = torch.sort(torch.where(dup, INT_MAX, skey), dim=1).values
        budget = min(max(cfg.max_candidates_total // S, k), uniq.shape[1])
        cids = uniq[:, :budget]
        cids = torch.where(cids == INT_MAX, -1, cids)

        # --- route candidates to their murmur owners -------------------
        flat_c = cids.reshape(-1).to(torch.int32)
        _, mtree = main_table_keys(flat_c, cfg)
        owner = torch.where(flat_c >= 0, owner_of_tree(mtree, MT, S), -1)
        qidx = torch.arange(ql, device=dev,
                            dtype=torch.int32).repeat_interleave(budget)
        kc = 2 * (flat_c.shape[0] // S) + budget
        route_c = _Route(torch.stack([flat_c, qidx], 1), owner, S, kc)
        (crecv,) = all_to_all_route([route_c.buf], mesh.model_group)
        dropped = (route_c.send_ovf.sum() + route_p.send_ovf.sum()).to(
            torch.int32)
        rid = crecv[:, 0]
        rq = crecv[:, 1].clamp(0, ql - 1).to(torch.int64)

        # --- owner-side lookup (hot forest, ring, cold) + exact rank ----
        rh, rtree = main_table_keys(rid, cfg)
        rlocal = (rtree - me * mtps).clamp(0, mtps - 1)
        slot, found = forest_lookup_masked(state.main_forest, rlocal, rh,
                                           rid, mcfg)
        sval, sfound = snap_mod.lookup_key_run(
            snap_mod.one(state.main_snaps), rh, rid, msnap_cfg)
        slot = torch.where(found, slot, torch.where(sfound, sval, -1))
        staging = None
        if cold:
            cval, cfound, row_missing, wm, mm, m_probed, m_fp = \
                coldtier.cold_lookup_main(
                    state.cold, rh, torch.where(found | sfound, -1, rid),
                    msnap_cfg)
            cfound = cfound & ~row_missing
            slot = torch.where(slot >= 0, slot,
                               torch.where(cfound, cval, -1))
            vecs_arena = state.cold.main_cache.vecs
            staging = vecs_arena.reshape(-1, vecs_arena.shape[-1])
        ok = (rid >= 0) & (slot >= 0)
        vecs = dense_read_tiered(state.store, staging,
                                 torch.where(ok, slot, 0))
        qv = qloc[rq]
        # one candidate against one query a row: the reference's inline
        # formula (the fused rank kernels want per-query candidate blocks)
        if cfg.metric == "angular":
            qn = qv / qv.norm(dim=-1, keepdim=True).clamp_min(1e-9)
            xn = vecs / vecs.norm(dim=-1, keepdim=True).clamp_min(1e-9)
            d = 1.0 - (qn * xn).sum(-1)
        else:
            d = ((qv - vecs) ** 2).sum(-1).clamp_min(0.0)
        d = torch.where(ok, d, float("inf"))

        # --- gather the partials over model, keep the global top-k -----
        summary = [dropped.reshape(1)]
        if cold:
            # OR this shard's masks over its data replicas first, so every
            # replica fetches the same segments and keeps the same cache
            masks = torch.stack([wl, ml, wm, mm]).to(torch.int32)
            if D > 1:
                (masks,) = _reduce_max(mesh.data_group, masks)
            wl, ml, wm, mm = (m.bool() for m in masks)
            info = coldtier.pack_cold_info(
                wl, ml, lsh_probed, lsh_fp, wm, mm, m_probed, m_fp,
                (ok & (slot >= msnap_cfg.store_capacity)).sum(), ok.sum())
            summary += [info, (ml.any() | mm.any()).to(torch.int32)
                        .reshape(1)]
        part = torch.stack([rid, rq.to(torch.int32), _f32_bits(d)], 1)
        allp = _all_gather(mesh.model_group, S,
                           torch.cat([part.reshape(-1)] + summary))
        sums = allp[:, part.numel():]                            # (S, nsum)
        allp = allp[:, :part.numel()].reshape(-1, 3)
        pid, pq = allp[:, 0], allp[:, 1]
        pd = _bits_f32(allp[:, 2])
        pd = torch.where(torch.isfinite(pd) & (pid >= 0), pd, float("inf"))
        # every (row, shard) pair adds at most ``budget`` partials, so a
        # (ql, S*budget) table by row is exact
        pbox, _ = dispatch_to_trees(
            torch.where(torch.isfinite(pd), pq, -1), ql, S * budget)
        (pd_g,) = gather_mailbox(pbox, pd)
        out_ids, out_d = _dedup_topk(mailbox_ids(pbox, pid),
                                     torch.where(pbox >= 0, pd_g,
                                                 float("inf")), k)
        tot = _totals(sums, cold)
        if D > 1:
            res = torch.cat([out_ids.to(torch.int32).reshape(-1),
                             _f32_bits(out_d).reshape(-1), tot])
            allr = _all_gather(mesh.data_group, D, res)
            n_ans = ql * k
            out_ids = allr[:, :n_ans].reshape(Q, k)
            out_d = _bits_f32(allr[:, n_ans:2 * n_ans]).reshape(Q, k)
            tot = _totals(allr[:, 2 * n_ans:], cold)
        out = (out_ids.to(torch.int32), out_d.to(torch.float32))
        if with_drop_count:
            out = out + (tot[0],)
        if cold:
            out = out + (wl, ml, wm, mm, tot[1:11], tot[11])
        return out

    return step


# ======================================================================
# insert (stream round)
# ======================================================================
def make_dist_insert_round(dcfg: DistConfig, mesh, *, route_main: int,
                           tree_main: int, route_lsh: int, tree_lsh: int,
                           flags_main: int, flags_lsh: int):
    """Distributed insert round:
    fn(state, ids, vecs, main_active, lsh_active) ->
        (state, main_pending, lsh_pending, flags)

    ids/vecs enter replicated; this rank sends its contiguous block of
    rows.  ``route_*`` size the per-destination send mailboxes,
    ``tree_*`` the receive-side per-tree mailboxes (single-device
    capacities), ``flags_*`` the capacities the next round's headroom is
    checked against.  Pending keeps MainTable rows and LSH entries apart,
    so a retry never inserts twice what already landed.  Collectives: one
    ``all_to_all`` out, one back (the acks), one ``all_reduce``."""
    cfg = dcfg.pfo
    tcfg, mcfg = lsh_tree_config(cfg), main_tree_config(cfg)
    tps, mtps = dcfg.trees_per_shard, dcfg.main_trees_per_shard
    T, MT = cfg.L * cfg.n_trees, cfg.main_n_trees     # global tree counts
    S, L, me = dcfg.n_model, cfg.L, mesh.shard

    def step(state: PFOState, ids, vecs, main_active, lsh_active):
        n = ids.shape[0]
        start, per = _block(n, S, me)
        # re-inserting a previously deleted id revokes its tombstone
        # (computed alike on every rank: the batch is replicated)
        revived = member_sorted(state.tombstones,
                                torch.where(main_active, ids, -1))
        state = state._replace(tombstones=torch.where(
            revived, -1, state.tombstones))
        ids_b = _pad_rows(ids, S * per, -1)[start:start + per]
        vecs_b = _pad_rows(vecs, S * per)[start:start + per]
        ma_b = _pad_rows(main_active, S * per, False)[start:start + per]
        la_b = _pad_rows(lsh_active.reshape(n, L), S * per,
                         False)[start:start + per].reshape(-1)
        h, gtree = _keys_and_trees(state, vecs_b, cfg)            # (per, L)

        # --- MainTable rows -> murmur owners; LSH entries -> tree owners
        _, mtree = main_table_keys(ids_b, cfg)
        route_m = _Route(
            torch.cat([ids_b.to(torch.int32)[:, None], _f32_bits(vecs_b)],
                      1),
            torch.where(ma_b, owner_of_tree(mtree, MT, S), -1), S, route_main)
        gflat = gtree.reshape(-1)
        route_l = _Route(
            torch.stack([_i32(h.reshape(-1)),
                         ids_b.to(torch.int32).repeat_interleave(L),
                         (gflat % tps).to(torch.int32)], 1),
            torch.where(la_b, owner_of_tree(gflat, T, S), -1), S, route_lsh,
            marker_col=1)
        mrecv, lrecv = all_to_all_route([route_m.buf, route_l.buf],
                                        mesh.model_group)

        rids = mrecv[:, 0]
        store, slots, alloc_ok = dense_alloc(
            state.store, _bits_f32(mrecv[:, 1:]), rids >= 0, rids)
        rh, rtree = main_table_keys(rids, cfg)
        mbox, m_recv_ovf = dispatch_to_trees(
            torch.where((rids >= 0) & alloc_ok, rtree % mtps, -1), mtps,
            tree_main)
        mh_g, mval_g = gather_mailbox(mbox, rh, slots)
        mid_g = mailbox_ids(mbox, rids)
        # a live re-insert replaces its id's hot entry and frees the
        # older slot (index.insert_step's repair)
        left, displaced = forest_replace_dispatched(
            state.main_forest, mh_g, mid_g, mval_g, mcfg)
        forest_insert_dispatched(state.main_forest, mh_g, left, mval_g, mcfg)
        store = free_displaced(store, displaced, mid_g)
        # rows whose local dispatch overflowed stored no reference to
        # their slot: reclaim it, so the retry cannot leak the store
        store = dense_free(store, slots, (rids >= 0) & alloc_ok & m_recv_ovf,
                           rids)
        m_fail = (rids >= 0) & (~alloc_ok | m_recv_ovf)

        rid = lrecv[:, 1]
        lbox, l_recv_ovf = dispatch_to_trees(
            torch.where(rid >= 0, lrecv[:, 2], -1), tps, tree_lsh)
        (lh_g,) = gather_mailbox(lbox, _u32(lrecv[:, 0]))
        lid_g = mailbox_ids(lbox, rid)
        forest_insert_dispatched(state.lsh_forest, lh_g, lid_g, lid_g, tcfg)
        l_fail = (rid >= 0) & l_recv_ovf

        mback, lback = all_to_all_route([
            m_fail.to(torch.int32).reshape(S, -1, 1),
            l_fail.to(torch.int32).reshape(S, -1, 1)], mesh.model_group)
        mp = torch.zeros(S * per, dtype=torch.bool, device=ids.device)
        lp = torch.zeros(S * per * L, dtype=torch.bool, device=ids.device)
        mp[start:start + per] = ma_b & (route_m.send_ovf | route_m.ack(mback))
        lp[start * L:(start + per) * L] = la_b & (route_l.send_ovf
                                                  | route_l.ack(lback))
        state = state._replace(store=store)
        mp, lp, terms = _reduce_max(mesh.model_group, mp, lp,
                                    _flag_terms(state))
        main_pending = mp[:n].bool() & main_active
        lsh_pending = lp[:n * L].bool() & lsh_active
        flags = _flags_from(terms, state, dcfg, flags_main, flags_lsh,
                            main_pending.any() | lsh_pending.any())
        return state, main_pending, lsh_pending, flags

    return step


def make_dist_insert(dcfg: DistConfig, mesh, capacity: int):
    """Batch insert: fn(state, ids, vecs, active) -> (state, pending), the
    stream round with every mailbox sized to ``capacity``."""
    L = dcfg.pfo.L
    step = make_dist_insert_round(
        dcfg, mesh, route_main=capacity, tree_main=capacity,
        route_lsh=capacity, tree_lsh=capacity,
        flags_main=capacity, flags_lsh=capacity)

    def run(state, ids, vecs, active):
        state, mp, lp, _ = step(state, ids, vecs, active,
                                active.repeat_interleave(L))
        return state, mp | lp.reshape(-1, L).any(1)

    return run


# ======================================================================
# delete (stream round)
# ======================================================================
def make_dist_delete_round(dcfg: DistConfig, mesh, *, tree_main: int,
                           route_lsh: int, tree_lsh: int, flags_main: int,
                           flags_lsh: int):
    """Distributed delete round: fn(state, ids, active) -> (state,
    pending, flags), and with a cold tier also this shard's (C,)
    wanted/missing MainTable masks.

    Every murmur owner resolves the ids it owns (hot forest, ring by key
    run, cold cache), unlinks the hot MainTable entry, frees the store
    slot while it is still the id's, re-derives the LSH keys from the
    stored vector and routes the (h, id) unlinks to tree owners.
    Tombstones stay replicated: the per-row success mask is max-combined,
    so every rank appends the same ids in the same order (overflow stays
    pending until a merge drains the buffer).  A row resolving only
    through a non-resident cold segment stays pending and the word
    carries COLD_MISS."""
    cfg = dcfg.pfo
    tcfg, mcfg = lsh_tree_config(cfg), main_tree_config(cfg)
    tps, mtps = dcfg.trees_per_shard, dcfg.main_trees_per_shard
    T, MT = cfg.L * cfg.n_trees, cfg.main_n_trees     # global tree counts
    msnap_cfg = shard_main_snap_cfg(dcfg)
    S, L, me = dcfg.n_model, cfg.L, mesh.shard
    cold = cfg.cold_enabled

    def step(state: PFOState, ids, active):
        n = ids.shape[0]
        mh, mtree = main_table_keys(ids, cfg)
        own = active & (owner_of_tree(mtree, MT, S) == me)
        ltree = torch.where(own, mtree % mtps, 0)
        slot, found = forest_lookup_masked(state.main_forest, ltree, mh, ids,
                                           mcfg)
        sval, sfound = snap_mod.lookup_key_run(
            snap_mod.one(state.main_snaps), mh, ids, msnap_cfg)
        slot = torch.where(found, slot, torch.where(sfound, sval, -1))
        staging = None
        unresolved = torch.zeros_like(own)
        hit = found | sfound
        if cold:
            cval, cfound, row_missing, wm, mm, _, _ = coldtier.cold_lookup_main(
                state.cold, mh, torch.where(own & ~hit, ids, -1), msnap_cfg)
            cfound = cfound & ~row_missing
            slot = torch.where(slot >= 0, slot,
                               torch.where(cfound, cval, -1))
            unresolved = own & ~(hit | cfound) & row_missing
            hit = hit | cfound
            arena = state.cold.main_cache.vecs
            staging = arena.reshape(-1, arena.shape[-1])
        ok = own & hit & (slot >= 0)
        vecs = dense_read_tiered(state.store, staging,
                                 torch.where(ok, slot, 0))

        # re-derive the LSH keys from the stored vector (owner side)
        h, gtree = _keys_and_trees(state, vecs, cfg)
        gflat = gtree.reshape(-1)
        lsend = ok.repeat_interleave(L)
        route_l = _Route(
            torch.stack([_i32(h.reshape(-1)),
                         ids.to(torch.int32).repeat_interleave(L),
                         (gflat % tps).to(torch.int32)], 1),
            torch.where(lsend, owner_of_tree(gflat, T, S), -1), S, route_lsh,
            marker_col=1)
        (lrecv,) = all_to_all_route([route_l.buf], mesh.model_group)
        rid = lrecv[:, 1]
        lbox, l_recv_ovf = dispatch_to_trees(
            torch.where(rid >= 0, lrecv[:, 2], -1), tps, tree_lsh)
        (lh_g,) = gather_mailbox(lbox, _u32(lrecv[:, 0]))
        forest_delete_dispatched(state.lsh_forest, lh_g,
                                 mailbox_ids(lbox, rid), tcfg)

        # hot MainTable unlink + store reclaim, owner-local
        mbox, m_ovf = dispatch_to_trees(torch.where(ok, ltree, -1), mtps,
                                        tree_main)
        (mh_g,) = gather_mailbox(mbox, mh)
        forest_delete_dispatched(state.main_forest, mh_g,
                                 mailbox_ids(mbox, ids), mcfg)
        # a row frees its slot only while the slot is still its id's;
        # staging-slot rows were freed when their segment spilled
        free = ok & (slot < msnap_cfg.store_capacity) if cold else ok
        store = dense_free(state.store, torch.where(free, slot, 0), free, ids)

        (lback,) = all_to_all_route([
            ((rid >= 0) & l_recv_ovf).to(torch.int32).reshape(S, -1, 1)],
            mesh.model_group)
        l_ent = lsend & (route_l.send_ovf | route_l.ack(lback))
        state = state._replace(store=store)
        cold_miss = (mm.any() if cold
                     else torch.zeros((), dtype=torch.bool, device=ids.device))
        ok_all, l_row, m_row, unresolved, cold_miss, terms = _reduce_max(
            mesh.model_group, ok, l_ent.reshape(n, L).any(1), ok & m_ovf,
            unresolved, cold_miss, _flag_terms(state))
        ok_all = ok_all.bool()

        # tombstones (replicated; the same append on every rank)
        want = ok_all.to(torch.int32)
        pos = state.n_tombstones + torch.cumsum(want, 0,
                                                dtype=torch.int32) - want
        fits = ok_all & (pos < cfg.max_tombstones)
        masked_put_(state.tombstones, (pos,), ids, fits)
        n_t = (state.n_tombstones + fits.sum(dtype=torch.int32)).clamp_max(
            cfg.max_tombstones)
        state = state._replace(n_tombstones=n_t)
        pending = ((ok_all & (l_row.bool() | m_row.bool())) | (ok_all & ~fits)
                   | unresolved.bool())
        flags = _flags_from(terms, state, dcfg, flags_main, flags_lsh,
                            pending.any(),
                            cold_miss=cold_miss.bool() if cold else None)
        if cold:
            return state, pending, flags, wm, mm
        return state, pending, flags

    return step


# ======================================================================
# maintenance epochs (shard-local; no collectives)
# ======================================================================
def make_dist_seal(dcfg: DistConfig, mesh):
    """Distributed seal: every rank seals its own trees into its own
    rings and resets its hot forests.  LSH leaf vals are redundant
    (val == id), so the mixed ring stores the table id there."""
    cfg = dcfg.pfo
    snap_cfg, msnap_cfg = shard_snap_cfg(dcfg), shard_main_snap_cfg(dcfg)
    tps = dcfg.trees_per_shard

    def step(state: PFOState) -> PFOState:
        stamp = state.stamp + 1
        lf, mf = state.lsh_forest, state.main_forest
        table = (mesh.shard * tps + torch.arange(tps, device=stamp.device)) \
            // cfg.n_trees
        ids = lf.leaf_id.reshape(1, -1)
        lsnap = snap_mod.seal(
            state.lsh_snaps, lf.leaf_key.reshape(1, -1), ids,
            table[:, None].expand(lf.leaf_id.shape).reshape(1, -1),
            ids >= 0, stamp, snap_cfg)
        mids = mf.leaf_id.reshape(1, -1)
        msnap = snap_mod.unbatch(snap_mod.seal(
            snap_mod.one(state.main_snaps), mf.leaf_key.reshape(1, -1), mids,
            mf.leaf_val.reshape(1, -1), mids >= 0, stamp, msnap_cfg))
        reset_forest_(lf)
        reset_forest_(mf)
        return state._replace(lsh_snaps=lsnap, main_snaps=msnap, stamp=stamp)

    return step


def _newest_of_group(table, ids, stamps, keys, valid) -> torch.Tensor:
    """Among ``valid`` entries, the one a single device's table-wide fold
    keeps for each (table, id): the newest stamp, then the smallest key
    (equal stamps share a segment, which is key-sorted).  (N,) masks."""
    t = torch.where(valid, table.to(torch.int64), INT_MAX)
    i = torch.where(valid, ids.to(torch.int64), INT_MAX)
    # stable sorts chained from the least significant key: (table, id,
    # stamp desc, key)
    order = torch.sort(keys, stable=True).indices
    for col in (-stamps.to(torch.int64), i, t):
        order = order[torch.sort(col[order], stable=True).indices]
    st, si = t[order], i[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=t.device),
                       (st[1:] != st[:-1]) | (si[1:] != si[:-1])])
    win = torch.zeros_like(valid)
    win[order] = first & valid[order]
    return win


def agree_fold(mesh, table, ids, stamps, keys, valid,
               n_max: int | None = None) -> torch.Tensor:
    """This shard's LSH entries that survive a fold cluster-wide: an
    entry loses to a newer one of the same (table, id) on another shard,
    as one device's table-wide fold drops it (a re-inserted or updated
    id's trees can sit on different shards).  (N,) tensors on the mesh's
    device, keys as unsigned 32-bit values; ``n_max`` the longest N of
    any shard (None: every shard passes the same N).  One
    ``all_gather`` over ``model``; one shard needs none."""
    S = mesh.n_model
    if S == 1:
        return valid
    n = ids.shape[0]
    rows = torch.stack([_i32(table), _i32(ids), stamps.to(torch.int32),
                        _i32(keys), valid.to(torch.int32)], 1)
    rows = _pad_rows(rows, n if n_max is None else n_max)
    allr = _all_gather(mesh.model_group, S, rows).reshape(-1, 5)
    win = _newest_of_group(allr[:, 0], allr[:, 1], allr[:, 2],
                           _u32(allr[:, 3]), allr[:, 4] > 0)
    return win.reshape(S, -1)[mesh.shard, :n]


def host_fold_filter(mesh):
    """:func:`agree_fold` for a shard's host-side cold folds
    (``ColdManager.fold_filter``): numpy in, numpy out; one
    ``all_reduce`` for the longest entry list, one ``all_gather``."""
    def keep(keys, ids, vals, stamps, live):
        dev = mesh.device
        n = torch.tensor([ids.shape[0]], dtype=torch.int32, device=dev)
        (n_max,) = _reduce_max(mesh.model_group, n)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

        win = agree_fold(mesh, t(vals), t(ids), t(stamps), t(keys),
                         torch.as_tensor(live).to(dev),
                         n_max=int(n_max.item()))
        return win.cpu().numpy()
    return keep


def make_dist_merge(dcfg: DistConfig, mesh):
    """Distributed merge: ring compaction with the replicated tombstone
    buffer (the mixed ring keeps one entry per (table, id), and an entry
    that a newer one on another shard supersedes goes, as one device's
    table-wide merge drops it: :func:`agree_fold`), then the buffer
    drains."""
    snap_cfg, msnap_cfg = shard_snap_cfg(dcfg), shard_main_snap_cfg(dcfg)

    def step(state: PFOState) -> PFOState:
        tombs = state.tombstones
        r = state.lsh_snaps
        drop = None
        if mesh.n_model > 1:
            _, S, cap = r.ids.shape
            valid = (r.ids >= 0) & ~member_sorted(r.ids, tombs)
            stamps = r.stamps[:, :, None].expand(1, S, cap)
            drop = valid & ~agree_fold(
                mesh, r.vals.reshape(-1), r.ids.reshape(-1),
                stamps.reshape(-1), r.keys.reshape(-1),
                valid.reshape(-1)).reshape(valid.shape)
        return state._replace(
            lsh_snaps=snap_mod.merge(r, snap_cfg, tombs, group_by_val=True,
                                     drop=drop),
            main_snaps=snap_mod.unbatch(snap_mod.merge(
                snap_mod.one(state.main_snaps), msnap_cfg, tombs)),
            tombstones=torch.full_like(tombs, -1),
            n_tombstones=torch.zeros_like(state.n_tombstones))

    return step


def shard_cold_manager(dcfg: DistConfig, mesh, root: str | None = None,
                       on_sync=None) -> coldtier.ColdManager:
    """This rank's cold manager: one mixed-table chain, its spill and
    ring drain reading the shard's local MainTable trees, its folds
    agreed with the other shards (:func:`host_fold_filter`)."""
    return coldtier.ColdManager(
        shard_cold_cfg(dcfg), shard_snap_cfg(dcfg), shard_main_snap_cfg(dcfg),
        main_tree_config(dcfg.pfo), mesh.device, root=root, on_sync=on_sync,
        mixed_lsh=True, tree_mod=dcfg.main_trees_per_shard,
        fold_filter=None if mesh.n_model == 1 else host_fold_filter(mesh))


# ----------------------------------------------------------------------
# observability (collective: every rank calls it at snapshot time)
# ----------------------------------------------------------------------
def shard_occupancy(state: PFOState, mesh) -> dict:
    """Per-shard occupancy over the model group: hot items, LSH leaves,
    free store slots, and the load imbalance (max / mean hot items).
    One ``all_gather``; called from ``stats()`` / snapshots only, never
    inside a round."""
    mine = torch.stack([state.main_forest.n_items.sum(),
                        state.lsh_forest.n_items.sum(),
                        state.store.free_top.to(torch.int64)]).to(torch.int64)
    occ = _all_gather(mesh.model_group, mesh.n_model, mine).cpu().numpy()
    items = occ[:, 0]
    return {
        "items_per_shard": items.tolist(),
        "lsh_per_shard": occ[:, 1].tolist(),
        "store_free_per_shard": occ[:, 2].tolist(),
        "imbalance": float(items.max() / max(float(np.mean(items)), 1.0)),
    }
