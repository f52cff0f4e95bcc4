"""Cold tier — host/flash-resident sealed segments with device-side
Bloom routing and an on-device LRU segment cache (paper §3.2.2's
"scale the system capacity by using flash memory"), in PyTorch.

The hierarchy this module completes:

  hot forests (HBM)  →  sealed snapshot ring (HBM, ``snapshots.py``)
                     →  **cold segment store (host RAM / flash files)**

When the device snapshot ring fills past ``max_snapshots - 1`` (or the
dense store's free list falls below ``store_low_watermark``) the
*oldest* sealed segment of every LSH table (and of the MainTable)
spills verbatim to a host :class:`repro_torch.storage.SegmentStore`.
A spilled MainTable segment carries its **vector payloads** with it
(one f32 row per entry, gathered out of the dense store) and frees the
store slots of every entry it takes sole custody of, so the dense
arena only holds the hot + ring working set.  What stays on the device
is a compact **routing table** per tier (Bloom filters, seal stamps,
entry counts) and a small **segment cache**; the MainTable cache's
payload pages form the **staging arena** cold candidates are ranked
from (``ColdCache.vecs``, addressed as slot ``store_capacity + e*cap +
r`` by the ``gather_rank_staged`` kernel).

A query round probes every filter in one shot; only segments whose
filter matched and that are not resident trigger a fetch.  The
wanted/missing masks ride in the round's one result pickup, so a round
that hits no non-resident cold segment costs no extra transfer.
Fetches copy host pages into pinned buffers and issue every transfer
non-blocking, straight into its cache slot on the current stream (the
stream the queries run on), before the re-probe is dispatched.

Background compaction (superseded-duplicate folding of cold segments)
runs on a worker thread over the immutable segment files and touches
numpy only; the driver thread installs the result between rounds.
Tombstone application runs synchronously inside the merge epoch
(:meth:`ColdManager.merge_cold`).

A distributed shard runs the same machinery over one *mixed-table*
chain (``mixed_lsh``: every LSH table the shard owns in one segment
sequence, the table id in ``vals``; :func:`cold_probe_lsh_mixed`), and
a checkpoint records the segment layout (:meth:`ColdManager.manifest`)
and re-adopts it (:meth:`ColdManager.adopt_manifest`).

This mirrors the JAX package's ``core/coldtier.py``.  Uint32 keys and
Bloom words ride in int64, as everywhere in the port.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..storage import SegmentStore
from . import bloom as bloom_mod
from . import snapshots as snap_mod
from .config import PFOConfig
from .hash_tree import TreeConfig, forest_lookup_masked
from .lsh import main_table_keys
from .membership import member_sorted
from .snapshots import INT_MAX, PAD_KEY
from .store import DenseStore, dense_free, dense_owned


# ======================================================================
# device-resident structures
# ======================================================================
class ColdRouting(NamedTuple):
    """What stays on the device for spilled segments: Bloom + metadata."""
    blooms: torch.Tensor   # u32 as i64 (..., C, W) packed filters
    stamps: torch.Tensor   # i32 (..., C) seal stamps
    counts: torch.Tensor   # i32 (..., C) live entries


class ColdCache(NamedTuple):
    """Device-side LRU segment cache (fetched cold segment payloads)."""
    keys: torch.Tensor     # u32 as i64 (E, cap) sorted per segment
    ids: torch.Tensor      # i32 (E, cap)
    vals: torch.Tensor     # i32 (E, cap)
    stamps: torch.Tensor   # i32 (E,)
    tables: torch.Tensor   # i32 (E,) owning LSH table (0 for main); -1 empty
    segs: torch.Tensor     # i32 (E,) cold segment index; -1 empty
    # vector payload pages (MainTable cache only): f32 (E, cap, d), row r
    # holding segment entry r's vector — the staging arena.  None for the
    # LSH cache, whose vals are ids, not vectors.
    vecs: torch.Tensor | None = None


class ColdState(NamedTuple):
    lsh_route: ColdRouting    # stacked (L, C, ...)
    main_route: ColdRouting   # (C, ...)
    lsh_cache: ColdCache
    main_cache: ColdCache
    n_cold: torch.Tensor      # i32 () cold segments per tier instance


def _empty_cache(cfg: PFOConfig, cap: int, device, dim: int | None = None
                 ) -> ColdCache:
    E = cfg.cold_cache_slots
    i32 = dict(dtype=torch.int32, device=device)
    return ColdCache(
        keys=torch.full((E, cap), PAD_KEY, dtype=torch.int64, device=device),
        ids=torch.full((E, cap), -1, **i32),
        vals=torch.zeros((E, cap), **i32),
        stamps=torch.zeros((E,), **i32),
        tables=torch.full((E,), -1, **i32),
        segs=torch.full((E,), -1, **i32),
        vecs=None if dim is None else torch.zeros(
            (E, cap, dim), dtype=torch.float32, device=device),
    )


def _routing(blooms, stamps, counts, device) -> ColdRouting:
    return ColdRouting(
        blooms=torch.as_tensor(np.asarray(blooms, np.int64)).to(device),
        stamps=torch.as_tensor(np.asarray(stamps, np.int32)).to(device),
        counts=torch.as_tensor(np.asarray(counts, np.int32)).to(device))


def init_cold(cfg: PFOConfig, lsh_cfg: PFOConfig, main_cfg: PFOConfig,
              device=None) -> ColdState | None:
    """Empty cold tier on ``device`` (None when disabled)."""
    if not cfg.cold_enabled:
        return None
    C, L, E = cfg.cold_segments, cfg.L, cfg.cold_cache_slots
    # staging slots store_capacity + e*cap + r travel as int32
    top = cfg.store_capacity + E * main_cfg.snapshot_capacity - 1
    if top >= 2**31:
        raise ValueError(
            f"staging slot encoding overflows int32: store_capacity + "
            f"cold_cache_slots * main segment cap = {top + 1} > 2^31")
    Wl = lsh_cfg.bloom_bits_eff // 32
    Wm = main_cfg.bloom_bits_eff // 32
    return ColdState(
        lsh_route=_routing(np.zeros((L, C, Wl)), np.zeros((L, C)),
                           np.zeros((L, C)), device),
        main_route=_routing(np.zeros((C, Wm)), np.zeros((C,)),
                            np.zeros((C,)), device),
        lsh_cache=_empty_cache(cfg, lsh_cfg.snapshot_capacity, device),
        main_cache=_empty_cache(cfg, main_cfg.snapshot_capacity, device,
                                dim=cfg.dim),
        n_cold=torch.tensor(0, dtype=torch.int32, device=device),
    )


# ======================================================================
# device-side probes (called inside the query/delete steps)
# ======================================================================
def _residency(cache: ColdCache, tables: torch.Tensor, C: int):
    """Per owning table (T,): (slot_ok (T, E), slot_seg (T, E), resident
    (T, C)) — which cache slots hold which of the table's cold segments.
    ``slot_seg`` parks slots that are not the table's at index C."""
    slot_ok = ((cache.tables[None, :] == tables[:, None])
               & (cache.segs >= 0)[None, :])
    slot_seg = torch.where(slot_ok, cache.segs.to(torch.int64)[None, :], C)
    resident = torch.zeros((tables.shape[0], C + 1), dtype=torch.bool,
                           device=slot_ok.device)
    resident.scatter_(1, slot_seg, True)
    return slot_ok, slot_seg, resident[:, :C]


def _seg_any(slot_seg: torch.Tensor, any_: torch.Tensor, C: int):
    """(T, E) per-slot flags scattered to (T, C) per cold segment (the
    parked index C takes what no segment owns and is dropped)."""
    out = torch.zeros((slot_seg.shape[0], C + 1), dtype=torch.bool,
                      device=slot_seg.device)
    out.scatter_(1, slot_seg, any_)
    return out[:, :C]


def cold_probe_lsh(cold: ColdState, hs: torch.Tensor, lsh_cfg: PFOConfig):
    """Cold-tier LSH candidates for a query batch.

    hs: (Q, L) compound keys.  Probes every cold segment's Bloom filter
    (multi-probe prefixes included) and gathers bucket spans from the
    segments resident in the cache.  Returns
    (cand (Q, L*P*E*B), wanted (L, C), missing (L, C), probed, fp) with
    probed/fp i32 scalars for the Bloom accounting.
    """
    q, L = hs.shape
    C = cold.lsh_route.stamps.shape[1]
    cache = cold.lsh_cache
    E = cache.keys.shape[0]
    dev = hs.device
    pfx = snap_mod.probe_prefixes(hs.t(), lsh_cfg).reshape(L, -1)  # (L, QP)
    qp = pfx.shape[1]
    hit = bloom_mod.contains_multi(cold.lsh_route.blooms, pfx,
                                   lsh_cfg.bloom_hashes_eff)       # (L, C, QP)
    act = (torch.arange(C, device=dev) < cold.n_cold)[None, :, None] & hit
    wanted = act.any(2)                                            # (L, C)
    slot_ok, slot_seg, resident = _residency(
        cache, torch.arange(L, device=dev), C)
    missing = wanted & ~resident
    seg_c = cache.segs.to(torch.int64).clamp(0, C - 1)
    act_slot = slot_ok[:, :, None] & act[:, seg_c]                 # (L, E, QP)
    # the cache is shared by every table (slots are table-tagged), so one
    # span gather covers all tables: (E, L*QP) probes
    cids, _, _, matched = snap_mod.span_gather(
        cache.keys, cache.ids, cache.vals,
        act_slot.permute(1, 0, 2).reshape(E, L * qp),
        pfx.reshape(1, L * qp).expand(E, L * qp).contiguous(), lsh_cfg)
    probed = wanted & resident
    fp = probed & ~_seg_any(slot_seg, matched.reshape(E, L, qp).any(2).t(), C)
    P = lsh_cfg.snap_probes
    cand = cids.reshape(E, L, q, P, -1).permute(2, 1, 3, 0, 4).reshape(q, -1)
    return (cand, wanted, missing, probed.sum(dtype=torch.int32),
            fp.sum(dtype=torch.int32))


def cold_probe_lsh_mixed(cold: ColdState, hs: torch.Tensor,
                         lsh_cfg: PFOConfig, view=None):
    """Cold-tier LSH candidates against a *mixed-table* segment chain —
    a distributed shard's tier, where one chain holds entries of every
    LSH table the shard owns (table id in ``vals``, as in the shard's
    sealed ring).

    ``cold.lsh_route`` is (1, C, W): every table's probe prefixes test
    the same C filters and spans gather from the same cache slots (table
    tag 0).  Without ``view`` the spans are the cached segments' own, as
    the JAX package reads them, and cross-table prefix collisions drop
    out by ``val == table``; with the cache's ``snapshots.mixed_view``
    each table reads its own run of a bucket.  Returns (cand
    (Q, L*P*E*B), wanted (C,), missing (C,), probed, fp)."""
    q, L = hs.shape
    C = cold.lsh_route.stamps.shape[1]
    cache = cold.lsh_cache
    E = cache.keys.shape[0]
    dev = hs.device
    pfx = snap_mod.probe_prefixes(hs.t(), lsh_cfg).reshape(1, -1)  # (1, LQP)
    lqp = pfx.shape[1]
    hit = bloom_mod.contains_multi(cold.lsh_route.blooms, pfx,
                                   lsh_cfg.bloom_hashes_eff)[0]    # (C, LQP)
    act = (torch.arange(C, device=dev) < cold.n_cold)[:, None] & hit
    wanted = act.any(1)
    slot_ok, slot_seg, resident = _residency(
        cache, torch.zeros(1, dtype=torch.int32, device=dev), C)
    missing = wanted & ~resident[0]
    act_slot = slot_ok[0][:, None] & act[cache.segs.to(torch.int64)
                                         .clamp(0, C - 1)]        # (E, LQP)
    if view is None:
        cids, cvals, _, matched = snap_mod.span_gather(
            cache.keys, cache.ids, cache.vals, act_slot,
            pfx.expand(E, lqp).contiguous(), lsh_cfg)              # (E, LQP, B)
        table = torch.arange(L, device=dev).repeat_interleave(lqp // L)
        cids = torch.where(cvals == table[None, :, None], cids, -1)
    else:
        cp = snap_mod.table_prefixes(hs.t(), lsh_cfg).reshape(1, -1)
        cids, _, _, matched = snap_mod.span_gather(
            *view, act_slot, cp.expand(E, lqp).contiguous(), lsh_cfg)
    probed = wanted & resident[0]
    fp = probed & ~_seg_any(slot_seg, matched.any(1)[None], C)[0]
    P = lsh_cfg.snap_probes
    cand = cids.reshape(E, L, q, P, -1).permute(2, 1, 3, 0, 4).reshape(q, -1)
    return (cand, wanted, missing, probed.sum(dtype=torch.int32),
            fp.sum(dtype=torch.int32))


def cold_lookup_main(cold: ColdState, mh: torch.Tensor, vids: torch.Tensor,
                     main_cfg: PFOConfig):
    """Exact (key, id) lookup in the cold MainTable cache.

    mh/vids: (N,) murmur keys and ids (-1 == padding).  Returns
    (slot, found, row_missing, wanted (C,), missing (C,), probed, fp):
    ``slot`` is a **staging-arena slot** ``store_capacity + e*cap + r``
    (the entry's dense-store slot was freed when its segment spilled);
    ``row_missing`` marks rows whose Bloom route hit a non-resident
    segment — such a row must retry after a fetch.

    The JAX package gathers each row's whole bucket span (the first
    ``snap_budget_per_probe`` entries of its prefix) from every slot and
    matches the id; an (E, N, budget) block that reaches gigabytes at a
    real query batch.  Here the span is never gathered: the murmur key
    is a bijection of the id, so the first entry whose key equals the
    row's key is the first copy of the id, and it is in the reference's
    span exactly when it lies within ``budget`` of the span's start.
    The one id whose key is the pad key finds its first real (id >= 0)
    pad-keyed entry instead.  Newest stamp wins; equal stamps take the
    lowest slot, as the reference's first-maximum does.
    """
    C = cold.main_route.stamps.shape[0]
    cache = cold.main_cache
    E, cap = cache.keys.shape
    n = mh.shape[0]
    dev = mh.device
    shift = 32 - main_cfg.snap_prefix_bits
    budget = main_cfg.snap_budget_per_probe
    mh = mh.to(torch.int64)
    vids = vids.to(torch.int64)
    pfx = mh >> shift
    hit = bloom_mod.contains_multi(cold.main_route.blooms[None], pfx[None],
                                   main_cfg.bloom_hashes_eff)[0]   # (C, N)
    act = ((torch.arange(C, device=dev) < cold.n_cold)[:, None] & hit
           & (vids >= 0)[None, :])
    wanted = act.any(1)
    slot_ok, slot_seg, resident = _residency(
        cache, torch.zeros(1, dtype=torch.int32, device=dev), C)
    slot_ok, slot_seg, resident = slot_ok[0], slot_seg[0], resident[0]
    missing = wanted & ~resident
    act_slot = slot_ok[:, None] & act[cache.segs.to(torch.int64)
                                      .clamp(0, C - 1)]             # (E, N)

    def search(x):
        return torch.searchsorted(cache.keys, x.expand(E, n).contiguous())

    lo = search((pfx << shift)[None])
    hi = search(((pfx + 1) << shift)[None])
    pad_real = (cache.keys == PAD_KEY) & (cache.ids >= 0)           # (E, cap)
    first_pad = torch.where(pad_real.any(1),
                            pad_real.to(torch.uint8).argmax(1), cap)
    pos = torch.where(mh[None] == PAD_KEY, first_pad[:, None],
                      search(mh[None]))                             # (E, N)
    safe = pos.clamp_max(cap - 1)
    is_vid = (act_slot & (pos < cap) & (pos < hi) & (pos < lo + budget)
              & (cache.ids.gather(1, safe) == vids[None])
              & (cache.keys.gather(1, safe) == mh[None]))
    stamp_sc = torch.where(is_vid, cache.stamps[:, None], -1)       # (E, N)
    best = stamp_sc.argmax(0)                   # newest stamp, lowest slot
    found = stamp_sc.max(0).values >= 0
    row = best * cap + pos.gather(0, best[None])[0]
    val = torch.where(found, main_cfg.store_capacity + row, -1)
    row_missing = (act & missing[:, None]).any(0)
    probed = wanted & resident
    matched = act_slot & (hi > lo)
    fp = probed & ~_seg_any(slot_seg[None], matched.any(1)[None], C)[0]
    return (val, found, row_missing, wanted, missing,
            probed.sum(dtype=torch.int32), fp.sum(dtype=torch.int32))


def pack_cold_info(lsh_wanted, lsh_missing, lsh_probed, lsh_fp,
                   main_wanted, main_missing, main_probed, main_fp,
                   staged_ranked, ranked_total) -> torch.Tensor:
    """Round accounting vector (i32 (10,)): rides in the result pickup.
    ``staged_ranked``/``ranked_total`` count candidates ranked out of
    the staging arena vs. all ranked candidates."""
    def c(x):
        return x.sum(dtype=torch.int32) if x.dtype == torch.bool \
            else x.to(torch.int32)
    return torch.stack([c(lsh_wanted), c(lsh_missing), c(lsh_probed),
                        c(lsh_fp), c(main_wanted), c(main_missing),
                        c(main_probed), c(main_fp), c(staged_ranked),
                        c(ranked_total)])


# ======================================================================
# maintenance helpers (host-called, epoch-time)
# ======================================================================
def _put_column(dst: torch.Tensor, dim: int, col: torch.Tensor,
                new: torch.Tensor, fits: torch.Tensor) -> None:
    """``dst.select(dim, col) = new`` in place where ``fits``; a column
    past the end (``fits`` False) writes nothing, as XLA drops it."""
    at = col.clamp_max(dst.shape[dim] - 1).reshape(1).to(torch.int64)
    old = dst.index_select(dim, at)
    dst.index_copy_(dim, at, torch.where(fits, new.unsqueeze(dim).to(
        dst.dtype), old))


def spill_device(lsh_snaps: snap_mod.SnapshotSet,
                 main_snaps: snap_mod.SnapshotSet, cold: ColdState,
                 store: DenseStore, main_forest, tombs: torch.Tensor,
                 lsh_cfg: PFOConfig, main_cfg: PFOConfig,
                 main_tcfg: TreeConfig, tree_mod: int | None = None):
    """Pop the oldest ring segment of every tier; route its metadata into
    the cold routing table (in place); gather the popped MainTable
    segment's vector payloads out of the dense store and free the store
    slots of every entry the segment takes sole custody of.  Returns
    (lsh', main', cold', store', popped_lsh, popped_main).

    "Sole custody" (the ``cur`` mask): the entry's id has no newer copy
    in the hot MainTable forest or the remaining ring, no pending
    tombstone, and its slot is still live and still the id's.  Only
    those entries get a real payload row and a freed slot; stale entries
    keep a zero payload (they are never ranked, and their slots were
    freed by the delete or update that superseded them).

    ``tree_mod``: a distributed shard's hot MainTable forest holds only
    its ``tree_mod`` local trees, so the global murmur tree id reduces
    modulo it (a shard's ring holds only ids the shard owns)."""
    lsh2, pl = snap_mod.pop_oldest(lsh_snaps, lsh_cfg)
    main2, pm = snap_mod.pop_oldest(snap_mod.one(main_snaps), main_cfg)
    main2 = snap_mod.unbatch(main2)
    pm = {k: v[0] for k, v in pm.items()}
    ids, vals = pm["ids"], pm["vals"]
    n_store = store.data.shape[0]
    mh, mtree = main_table_keys(ids, main_cfg)
    if tree_mod is not None:
        mtree = mtree % tree_mod
    _, hot_found = forest_lookup_masked(main_forest, mtree, mh, ids,
                                        main_tcfg)
    in_ring = member_sorted(ids, main2.ids)
    dead = member_sorted(ids, tombs)
    safe = vals.to(torch.int64).clamp(0, n_store - 1)
    live = dense_owned(store, safe, ids) & (vals >= 0)
    cur = (ids >= 0) & ~hot_found & ~in_ring & ~dead & live
    pm["payload"] = torch.where(cur[:, None], store.data[safe], 0.0)
    pm["cur"] = cur
    store2 = dense_free(store, vals, cur)
    nc = cold.n_cold
    fits = nc < cold.main_route.stamps.shape[0]
    lr, mr = cold.lsh_route, cold.main_route
    _put_column(lr.blooms, 1, nc, pl["bloom"], fits)
    _put_column(lr.stamps, 1, nc, pl["stamp"], fits)
    _put_column(lr.counts, 1, nc, pl["count"], fits)
    _put_column(mr.blooms, 0, nc, pm["bloom"], fits)
    _put_column(mr.stamps, 0, nc, pm["stamp"], fits)
    _put_column(mr.counts, 0, nc, pm["count"], fits)
    return lsh2, main2, cold._replace(n_cold=nc + 1), store2, pl, pm


def cache_install(cache: ColdCache, slot: int, keys, ids, vals, stamp: int,
                  table: int, seg: int, vecs=None) -> ColdCache:
    """Load one fetched segment into cache slot ``slot``, in place, on
    the current stream (so rounds queued after it on that stream see
    it).  ``keys/ids/vals`` (cap,) and ``vecs`` (cap, d) are host
    tensors (pinned when the cache is on a GPU, then the copies are
    non-blocking) or device tensors; ``vecs`` loads the segment's
    payload page into the staging arena (MainTable cache only)."""
    cache.keys[slot].copy_(keys, non_blocking=True)
    cache.ids[slot].copy_(ids, non_blocking=True)
    cache.vals[slot].copy_(vals, non_blocking=True)
    if vecs is not None:
        cache.vecs[slot].copy_(vecs, non_blocking=True)
    cache.stamps[slot] = stamp
    cache.tables[slot] = table
    cache.segs[slot] = seg
    return cache


def ring_payload_drain(main_snaps: snap_mod.SnapshotSet, store: DenseStore,
                       main_forest, tombs: torch.Tensor, main_cfg: PFOConfig,
                       main_tcfg: TreeConfig, tree_mod: int | None = None):
    """Device half of the cold merge's ring drain: gather the vector
    payload of every ring entry the ring holds the current version of,
    and free those store slots.  Returns (payloads (S, cap, d),
    cur (S, cap), store').

    ``cur`` is :func:`spill_device`'s sole-custody mask with one more
    clause: only the *newest ring copy* of an id qualifies (the stale
    copies' slots were freed, and maybe re-owned, at delete time).  The
    newest copy per id comes from an (id asc, stamp desc) order: two
    stable sorts, the secondary key first, as the JAX package's
    ``lexsort`` orders them.  ``tree_mod`` as in :func:`spill_device`."""
    S, cap = main_snaps.ids.shape
    ids = main_snaps.ids.reshape(-1)
    vals = main_snaps.vals.reshape(-1)
    stamps = main_snaps.stamps[:, None].expand(S, cap).reshape(-1)
    valid = ids >= 0
    ikey = torch.where(valid, ids, INT_MAX)
    order = torch.sort(-stamps, stable=True).indices
    order = order[torch.sort(ikey[order], stable=True).indices]
    sid = ikey[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                       sid[1:] != sid[:-1]])
    newest = torch.zeros_like(valid)
    newest[order] = first & (sid < INT_MAX)
    mh, mtree = main_table_keys(ids, main_cfg)
    if tree_mod is not None:
        mtree = mtree % tree_mod
    _, hot_found = forest_lookup_masked(main_forest, mtree, mh, ids,
                                        main_tcfg)
    dead = member_sorted(ids, tombs)
    n_store = store.data.shape[0]
    safe = vals.to(torch.int64).clamp(0, n_store - 1)
    live = dense_owned(store, safe, ids) & (vals >= 0)
    cur = valid & newest & ~hot_found & ~dead & live
    payload = torch.where(cur[:, None], store.data[safe], 0.0)
    store2 = dense_free(store, vals, cur)
    return payload.reshape(S, cap, -1), cur.reshape(S, cap), store2


# ======================================================================
# host-side Bloom build (numpy twin of core.bloom — parity-tested)
# ======================================================================
_GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


def _np_fmix32(x: np.ndarray, seed: int) -> np.ndarray:
    h = (x ^ ((seed * _GOLDEN) & _M32)) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return h


def np_bloom_build(keys: np.ndarray, n_hashes: int, bloom_bits: int,
                   mask: np.ndarray | None = None) -> np.ndarray:
    """Pure-numpy twin of ``bloom.build`` — bit-identical filters, so
    the background compaction thread never touches torch."""
    seeds = np.arange(1, n_hashes + 1, dtype=np.uint64)
    x = (keys.astype(np.uint64)[..., None] + seeds * _GOLDEN) & _M32
    pos = (_np_fmix32(x, seed=7) % bloom_bits).astype(np.int64)
    if mask is not None:
        pos = pos[mask]
    bits = np.zeros((bloom_bits,), bool)
    bits[pos.reshape(-1)] = True
    words = bits.reshape(-1, 32).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    return (words * weights).sum(axis=1, dtype=np.uint32)


def _np_prefix(keys: np.ndarray, bits: int) -> np.ndarray:
    return (keys.astype(np.uint32) >> np.uint32(32 - bits))


# ======================================================================
# host orchestration
# ======================================================================
class _FoldResult(NamedTuple):
    """Output of a (possibly background) cold compaction fold."""
    gen: int                       # cold-store generation it was computed at
    lsh_segments: list             # per table: list of segment dicts
    main_segments: list


def _fold_entries(keys, ids, vals, stamps, dead: np.ndarray, cap: int,
                  prefix_bits: int, bloom_hashes: int, bloom_bits: int,
                  payloads=None, group_by_val: bool = False):
    """Fold concatenated segment entries: drop dead/padding, keep the
    newest stamp per id, re-sort bucket-major, chunk into cap-sized
    write-once segments with fresh Bloom filters.  Pure numpy.
    ``payloads`` (n, d) rows travel with their entries (MainTable
    tier), so tombstoned/superseded vectors are physically dropped in
    the same pass that drops their index entries.  ``group_by_val``
    keeps the newest entry per (id, val) instead of per id: a mixed-table
    chain (``val`` == the owning LSH table) holds an id once per table,
    as ``snapshots.merge(group_by_val=True)`` keeps it."""
    live = ids >= 0
    if dead.size:
        live &= ~np.isin(ids, dead)
    k = np.asarray(keys, np.uint32)[live]
    i = np.asarray(ids, np.int32)[live]
    v = np.asarray(vals, np.int32)[live]
    s = np.asarray(stamps, np.int32)[live]
    p = None if payloads is None \
        else np.asarray(payloads, np.float32)[live]
    if i.size:
        if group_by_val:
            order = np.lexsort((-s, v, i))     # (id, val) asc, stamp desc
            same = ((i[order][1:] == i[order][:-1])
                    & (v[order][1:] == v[order][:-1]))
            first = np.concatenate([[True], ~same])
        else:
            order = np.lexsort((-s, i))        # id asc, stamp desc
            first = np.concatenate([[True], i[order][1:] != i[order][:-1]])
        keep = np.sort(order[first])
        k, i, v, s = k[keep], i[keep], v[keep], s[keep]
        ko = np.argsort(k, kind="stable")
        k, i, v, s = k[ko], i[ko], v[ko], s[ko]
        if p is not None:
            p = p[keep][ko]
    out = []
    for lo in range(0, len(i), cap):
        ck, ci, cv, cs = (a[lo:lo + cap] for a in (k, i, v, s))
        n = len(ci)
        pk = np.full((cap,), PAD_KEY, np.uint32)
        pi = np.full((cap,), -1, np.int32)
        pv = np.zeros((cap,), np.int32)
        pk[:n], pi[:n], pv[:n] = ck, ci, cv
        bloom = np_bloom_build(_np_prefix(pk, prefix_bits), bloom_hashes,
                               bloom_bits, mask=pi >= 0)
        seg = {"keys": pk, "ids": pi, "vals": pv, "count": n,
               "stamp": int(cs.max()) if n else 0, "bloom": bloom}
        if p is not None:
            pp = np.zeros((cap, p.shape[1]), np.float32)
            pp[:n] = p[lo:lo + cap]
            seg["payload"] = pp
        out.append(seg)
    return out


def _numpy(t: torch.Tensor, u32: bool = False) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if u32 else a


class ColdManager:
    """Host half of the cold tier, owned by :class:`PFOIndex`.

    Tracks the segment-store layout (cold index -> gid per tier), the
    cache LRU bookkeeping mirroring the device tags, and the cold
    counters surfaced by ``stats()``.  All state mutations happen
    between device rounds on the driver thread; the background
    compaction worker only *computes* fold results from immutable
    segment files (numpy only), and the driver installs them.
    """

    def __init__(self, cfg: PFOConfig, lsh_cfg: PFOConfig,
                 main_cfg: PFOConfig, main_tcfg: TreeConfig, device,
                 root: str | None = None, on_sync=None,
                 mixed_lsh: bool = False, tree_mod: int | None = None,
                 fold_filter=None):
        """``mixed_lsh``: the LSH tier is one mixed-table chain (``val`` ==
        owning table — a distributed shard's layout, driven with
        ``cfg.L == 1``), so folds keep one entry per (id, table).
        ``tree_mod``: the shard's local MainTable tree count
        (:func:`spill_device`).  ``fold_filter(keys, ids, vals, stamps,
        live) -> keep``: the LSH entries a fold may keep, agreed with the
        other shards (a collective, so every shard folds in the same
        epoch, synchronously; ``distributed.shard_cold_manager``)."""
        self.cfg, self.lsh_cfg, self.main_cfg = cfg, lsh_cfg, main_cfg
        self.main_tcfg = main_tcfg
        self.mixed_lsh = mixed_lsh
        self.tree_mod = tree_mod
        self.fold_filter = fold_filter
        self.device = torch.device(device)
        self.store = SegmentStore(root)
        self.lsh_gids: list[list[int]] = [[] for _ in range(cfg.L)]
        self.main_gids: list[int] = []
        E = cfg.cold_cache_slots
        self._lsh_tags: list = [None] * E       # (table, cold idx) per slot
        self._main_tags: list = [None] * E
        self._lsh_use = [0] * E
        self._main_use = [0] * E
        self._tick = 0
        self._gen = 0                 # bumps on every cold-layout mutation
        self._futile_gen = -1         # layout gen a fold failed to shrink
        self._on_sync = on_sync or (lambda: None)
        self._worker: threading.Thread | None = None
        self._worker_out: _FoldResult | None = None
        self._lock = threading.Lock()
        from ..obs import NULL_OBS
        self.obs = NULL_OBS          # rebound by PFOIndex.set_obs
        self.counters = {
            "spills": 0, "fetches": 0, "fetch_rounds": 0,
            "query_rounds": 0, "incomplete_query_rounds": 0,
            "compactions": 0, "cold_merges": 0,
            "lsh_wanted": 0, "lsh_missing": 0, "lsh_probed": 0,
            "lsh_fp": 0, "main_wanted": 0, "main_missing": 0,
            "main_probed": 0, "main_fp": 0,
            "staged_ranked": 0, "ranked_total": 0,
            "vec_fetch_bytes": 0, "vec_evictions": 0,
        }

    # -- observability --------------------------------------------------
    def set_obs(self, obs) -> None:
        """Bind an observability handle; cold stats mirror into
        ``cold.*`` gauges lazily at snapshot time."""
        self.obs = obs
        obs.on_snapshot("cold", self._mirror_obs)

    def _mirror_obs(self) -> None:
        g = self.obs.gauge
        s = self.stats()
        g("cold.segments").set(s["cold_segments"])
        g("cold.spills").set(s["segments_spilled"])
        g("cold.fetches").set(s["fetches"])
        g("cold.fetch_rounds").set(s["fetch_rounds"])
        g("cold.fetches_per_query_round").set(s["fetches_per_query_round"])
        g("cold.incomplete_query_rounds").set(s["incomplete_query_rounds"])
        g("cold.cache_hit_rate").set(s["cache_hit_rate"])
        g("cold.bloom_fp_rate").set(s["bloom_fp_rate"])
        g("cold.compactions").set(s["compactions"])
        g("cold.merges").set(s["cold_merges"])
        g("cold.store_bytes_written").set(s["store_bytes_written"])
        g("cold.vec_staging_hit_rate").set(s["vec_staging_hit_rate"])
        g("cold.vec_fetch_bytes").set(s["vec_fetch_bytes"])
        g("cold.vec_evictions").set(s["vec_evictions"])
        g("cold.vec_resident_pages").set(s["vec_resident_pages"])

    @property
    def n_cold(self) -> int:
        return len(self.main_gids)

    def record_query_round(self, info: np.ndarray) -> None:
        """Accumulate one round's (10,) cold-info vector."""
        self.counters["query_rounds"] += 1
        for j, key in enumerate(("lsh_wanted", "lsh_missing", "lsh_probed",
                                 "lsh_fp", "main_wanted", "main_missing",
                                 "main_probed", "main_fp",
                                 "staged_ranked", "ranked_total")):
            self.counters[key] += int(info[j])

    def stats(self) -> dict:
        c = self.counters
        wanted = c["lsh_wanted"] + c["main_wanted"]
        missing = c["lsh_missing"] + c["main_missing"]
        probed = c["lsh_probed"] + c["main_probed"]
        fp = c["lsh_fp"] + c["main_fp"]
        qr = max(c["query_rounds"], 1)
        return {
            "cold_segments": self.n_cold,
            "segments_spilled": c["spills"],
            "fetches": c["fetches"],
            "fetch_rounds": c["fetch_rounds"],
            "fetches_per_query_round": round(c["fetches"] / qr, 4),
            "incomplete_query_rounds": c["incomplete_query_rounds"],
            "cache_hit_rate": round(1.0 - missing / wanted, 4)
            if wanted else 1.0,
            "bloom_probed": probed,
            "bloom_false_positives": fp,
            "bloom_fp_rate": round(fp / probed, 4) if probed else 0.0,
            "compactions": c["compactions"],
            "cold_merges": c["cold_merges"],
            "store_bytes_written": self.store.bytes_written,
            "backing": "files" if self.store.root else "ram",
            "staged_ranked": c["staged_ranked"],
            "ranked_total": c["ranked_total"],
            "vec_staging_hit_rate": round(
                c["staged_ranked"] / c["ranked_total"], 4)
            if c["ranked_total"] else 0.0,
            "vec_fetch_bytes": c["vec_fetch_bytes"],
            "vec_evictions": c["vec_evictions"],
            "vec_resident_pages": sum(
                1 for t in self._main_tags if t is not None),
        }

    # -- spill ----------------------------------------------------------
    def _check_room(self) -> None:
        """A spill into a full routing table would write past it and the
        segment's ids would vanish from queries: refuse loudly."""
        if self.n_cold >= self.cfg.cold_segments:
            raise RuntimeError(
                f"cold routing table full ({self.n_cold}/"
                f"{self.cfg.cold_segments} segments) and compaction "
                "cannot shrink it; raise PFOConfig.cold_segments or the "
                "snapshot capacities")

    def spill(self, state):
        """One spill epoch: oldest ring segment of every tier -> host."""
        self._check_room()            # before the device pop changes state
        lsh2, main2, cold2, store2, pl, pm = spill_device(
            state.lsh_snaps, state.main_snaps, state.cold, state.store,
            state.main_forest, state.tombstones,
            self.lsh_cfg, self.main_cfg, self.main_tcfg, self.tree_mod)
        self._on_sync()
        self.adopt_spill(
            {k: _numpy(v, u32=k == "keys") for k, v in pl.items()},
            {k: _numpy(v, u32=k == "keys") for k, v in pm.items()})
        return state._replace(lsh_snaps=lsh2, main_snaps=main2,
                              cold=cold2, store=store2)

    def adopt_spill(self, pl_h: dict, pm_h: dict) -> None:
        """Persist one spill epoch's popped segments (host bookkeeping
        only; the device pop already ran).  ``pl_h`` arrays carry a
        leading table axis (``cfg.L``), ``pm_h`` arrays are flat — the
        layout :func:`spill_device` pops."""
        self._check_room()
        for l in range(self.cfg.L):
            self.lsh_gids[l].append(
                self.store.put(pl_h["keys"][l], pl_h["ids"][l],
                               pl_h["vals"][l], pl_h["count"][l],
                               pl_h["stamp"][l]))
        self.main_gids.append(
            self.store.put(pm_h["keys"], pm_h["ids"], pm_h["vals"],
                           pm_h["count"], pm_h["stamp"],
                           payload=pm_h["payload"]))
        self._gen += 1
        self.counters["spills"] += 1

    # -- fetch ----------------------------------------------------------
    def _pick_slot(self, tags: list, use: list, needed: set) -> int | None:
        """Free slot first, else the LRU slot not needed this round."""
        for e, tag in enumerate(tags):
            if tag is None:
                return e
        cands = [e for e, tag in enumerate(tags) if tag not in needed]
        if not cands:
            return None                        # cache thrash guard
        return min(cands, key=lambda e: use[e])

    def _host(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A host copy of ``a`` (possibly a read-only mmap view) in a
        fresh tensor — pinned when the cache lives on a GPU, so the copy
        to the device can be non-blocking."""
        t = torch.empty(a.shape, dtype=dtype,
                        pin_memory=self.device.type == "cuda")
        t.numpy()[...] = a
        return t

    def fetch(self, state, wanted_l, missing_l, wanted_m, missing_m):
        """Load Bloom-matched, non-resident segments into the cache.

        wanted/missing are the round's host (numpy bool) masks —
        (L, C) for the LSH tier, (C,) for the MainTable tier.  Evicts
        LRU slots, never one wanted by this round.
        """
        return state._replace(cold=self.fetch_cold(
            state.cold, wanted_l, missing_l, wanted_m, missing_m))

    def fetch_cold(self, cold: ColdState, wanted_l, missing_l,
                   wanted_m, missing_m) -> ColdState:
        """:meth:`fetch` against a bare cold state: every page is read
        into a host buffer first, then every transfer is issued."""
        self._tick += 1
        # LRU touch for segments this round actually used
        for e, tag in enumerate(self._lsh_tags):
            if tag is not None and wanted_l[tag[0], tag[1]]:
                self._lsh_use[e] = self._tick
        for e, tag in enumerate(self._main_tags):
            if tag is not None and wanted_m[tag[1]]:
                self._main_use[e] = self._tick

        needed_l = {(int(l), int(c)) for l, c in zip(*np.nonzero(wanted_l))}
        needed_m = {(0, int(c)) for c in np.nonzero(wanted_m)[0]}
        plan = []            # (cache, slot, stamp, table, seg, host pages)
        for l, c in zip(*np.nonzero(missing_l)):
            slot = self._pick_slot(self._lsh_tags, self._lsh_use, needed_l)
            if slot is None:
                break
            gid = self.lsh_gids[int(l)][int(c)]
            k, i, v = self.store.get(gid)
            self._lsh_tags[slot] = (int(l), int(c))
            self._lsh_use[slot] = self._tick
            plan.append((cold.lsh_cache, slot, self.store.meta(gid)["stamp"],
                         int(l), int(c), self._host(k, torch.int64),
                         self._host(i, torch.int32),
                         self._host(v, torch.int32), None))
        for c in np.nonzero(missing_m)[0]:
            slot = self._pick_slot(self._main_tags, self._main_use,
                                   needed_m)
            if slot is None:
                break
            gid = self.main_gids[int(c)]
            k, i, v = self.store.get(gid)
            p = self.store.get_payload(gid)
            if self._main_tags[slot] is not None:
                self.counters["vec_evictions"] += 1
            self._main_tags[slot] = (0, int(c))
            self._main_use[slot] = self._tick
            self.counters["vec_fetch_bytes"] += int(p.nbytes)
            plan.append((cold.main_cache, slot,
                         self.store.meta(gid)["stamp"], 0, int(c),
                         self._host(k, torch.int64),
                         self._host(i, torch.int32),
                         self._host(v, torch.int32),
                         self._host(p, torch.float32)))
        for cache, slot, stamp, table, seg, k, i, v, p in plan:
            cache_install(cache, slot, k, i, v, stamp, table, seg, vecs=p)
            self.counters["fetches"] += 1
        if plan:
            self.counters["fetch_rounds"] += 1
        return cold

    # -- compaction / merge --------------------------------------------
    def _collect(self, gids: list[int], with_payload: bool = False):
        """Concatenate a gid list's entries (keys, ids, vals, stamps
        [, payloads])."""
        ks, is_, vs, ss, ps = [], [], [], [], []
        for gid in gids:
            k, i, v = self.store.get(gid)
            meta = self.store.meta(gid)
            ks.append(np.asarray(k))
            is_.append(np.asarray(i))
            vs.append(np.asarray(v))
            ss.append(np.full(k.shape, meta["stamp"], np.int32))
            if with_payload:
                ps.append(np.asarray(self.store.get_payload(gid)))
        if not ks:
            z = np.zeros((0,), np.int32)
            base = (z.astype(np.uint32), z, z, z)
            return base + (np.zeros((0, self.cfg.dim), np.float32),) \
                if with_payload else base
        base = (np.concatenate(ks), np.concatenate(is_),
                np.concatenate(vs), np.concatenate(ss))
        return base + (np.concatenate(ps),) if with_payload else base

    def _fold_all(self, dead: np.ndarray,
                  ring_extra=None, ring_extra_main=None) -> _FoldResult:
        """Fold cold segments (plus optional drained ring segments) into
        fresh write-once segments.  Reads immutable inputs only."""
        gen = self._gen
        lsh_out = []
        for l in range(self.cfg.L):
            k, i, v, s = self._collect(self.lsh_gids[l])
            if ring_extra is not None:
                k, i, v, s = (np.concatenate([a, b]) for a, b in
                              zip((k, i, v, s), ring_extra[l]))
            if self.fold_filter is not None:
                live = i >= 0
                if dead.size:
                    live &= ~np.isin(i, dead)
                i = np.where(self.fold_filter(k, i, v, s, live), i, -1)
            lsh_out.append(_fold_entries(
                k, i, v, s, dead, self.lsh_cfg.snapshot_capacity,
                self.lsh_cfg.snap_prefix_bits,
                self.lsh_cfg.bloom_hashes_eff,
                self.lsh_cfg.bloom_bits_eff, group_by_val=self.mixed_lsh))
        k, i, v, s, p = self._collect(self.main_gids, with_payload=True)
        if ring_extra_main is not None:
            k, i, v, s, p = (np.concatenate([a, b]) for a, b in
                             zip((k, i, v, s, p), ring_extra_main))
        main_out = _fold_entries(
            k, i, v, s, dead, self.main_cfg.snapshot_capacity,
            self.main_cfg.snap_prefix_bits,
            self.main_cfg.bloom_hashes_eff, self.main_cfg.bloom_bits_eff,
            payloads=p)
        return _FoldResult(gen, lsh_out, main_out)

    def _install_fold(self, state, fold: _FoldResult,
                      mark_futile: bool = False):
        """Swap the cold layout to a fold result: rewrite the gid lists,
        rebuild the device routing table, flush the cache.
        ``mark_futile``: this was a *shrink* attempt (compaction) — if
        it did not shrink, arm the backoff."""
        routing = self.install_layout(fold, mark_futile=mark_futile)
        return state._replace(cold=self.routed_cold_state(routing))

    def install_layout(self, fold: _FoldResult, mark_futile: bool = False):
        """Host half of the fold install: rewrite the gid lists and build
        the fresh routing arrays.  Returns the numpy routing tuple
        ``(lb, ls, lc, mb, ms, mc, n_cold)``."""
        cfg = self.cfg
        n_cold = max([len(s) for s in fold.lsh_segments]
                     + [len(fold.main_segments)])
        if n_cold > cfg.cold_segments:
            raise RuntimeError(
                f"cold tier overflow: compaction still needs {n_cold} "
                f"segments but cold_segments={cfg.cold_segments}; raise "
                "PFOConfig.cold_segments (or snapshot capacities)")
        old_n_cold = self.n_cold
        old_gids = [g for row in self.lsh_gids for g in row] + \
            list(self.main_gids)
        Wl = self.lsh_cfg.bloom_bits_eff // 32
        Wm = self.main_cfg.bloom_bits_eff // 32
        C = cfg.cold_segments
        lb = np.zeros((cfg.L, C, Wl), np.uint32)
        ls = np.zeros((cfg.L, C), np.int32)
        lc = np.zeros((cfg.L, C), np.int32)
        mb = np.zeros((C, Wm), np.uint32)
        ms = np.zeros((C,), np.int32)
        mc = np.zeros((C,), np.int32)
        self.lsh_gids = [[] for _ in range(cfg.L)]
        for l, segs in enumerate(fold.lsh_segments):
            for c, seg in enumerate(segs):
                self.lsh_gids[l].append(self.store.put(
                    seg["keys"], seg["ids"], seg["vals"], seg["count"],
                    seg["stamp"]))
                lb[l, c], ls[l, c], lc[l, c] = (seg["bloom"], seg["stamp"],
                                                seg["count"])
            # lockstep padding: empty trailing segments (bloom 0 never hits)
            while len(self.lsh_gids[l]) < n_cold:
                self.lsh_gids[l].append(self._put_empty(self.lsh_cfg))
        self.main_gids = []
        for c, seg in enumerate(fold.main_segments):
            self.main_gids.append(self.store.put(
                seg["keys"], seg["ids"], seg["vals"], seg["count"],
                seg["stamp"], payload=seg["payload"]))
            mb[c], ms[c], mc[c] = seg["bloom"], seg["stamp"], seg["count"]
        while len(self.main_gids) < n_cold:
            self.main_gids.append(self._put_empty(self.main_cfg,
                                                  dim=self.cfg.dim))
        for gid in old_gids:
            self.store.delete(gid)
        self._gen += 1
        if mark_futile and old_n_cold and n_cold >= old_n_cold:
            # the fold did not shrink the layout: back off until a
            # spill/merge moves it
            self._futile_gen = self._gen
        E = cfg.cold_cache_slots
        self._lsh_tags = [None] * E
        self._main_tags = [None] * E
        return lb, ls, lc, mb, ms, mc, n_cold

    def routed_cold_state(self, routing) -> ColdState:
        """Fresh device cold state for an installed layout (routing
        tables from :meth:`install_layout`, empty caches)."""
        lb, ls, lc, mb, ms, mc, n_cold = routing
        dev = self.device
        return ColdState(
            lsh_route=_routing(lb, ls, lc, dev),
            main_route=_routing(mb, ms, mc, dev),
            lsh_cache=_empty_cache(self.cfg, self.lsh_cfg.snapshot_capacity,
                                   dev),
            main_cache=_empty_cache(self.cfg,
                                    self.main_cfg.snapshot_capacity, dev,
                                    dim=self.cfg.dim),
            n_cold=torch.tensor(n_cold, dtype=torch.int32, device=dev))

    def _put_empty(self, tier_cfg: PFOConfig, dim: int | None = None) -> int:
        cap = tier_cfg.snapshot_capacity
        return self.store.put(np.full((cap,), PAD_KEY, np.uint32),
                              np.full((cap,), -1, np.int32),
                              np.zeros((cap,), np.int32), 0, 0,
                              payload=None if dim is None
                              else np.zeros((cap, dim), np.float32))

    def compact(self, state):
        """Synchronous cold-only compaction (no tombstones, no ring)."""
        self._discard_worker()
        with self.obs.span("compaction", mode="sync"):
            state = self._install_fold(
                state, self._fold_all(np.zeros((0,), np.int32)),
                mark_futile=True)
        self.counters["compactions"] += 1
        return state

    # -- background compaction -----------------------------------------
    def compact_start_async(self) -> bool:
        """Kick the worker if idle; returns whether a fold is running.
        No-ops while the layout generation is one a previous fold
        already failed to shrink."""
        if self.fold_filter is not None:
            raise RuntimeError("a fold filter is a collective: fold "
                               "synchronously (compact)")
        if self._gen == self._futile_gen:
            return False
        if self._worker is not None and self._worker.is_alive():
            return True
        if self._worker_out is not None:
            return True                        # result awaiting install

        def run():
            # numpy only: the worker never touches torch or the device
            with self.obs.span("compaction", mode="background"):
                out = self._fold_all(np.zeros((0,), np.int32))
            with self._lock:
                self._worker_out = out

        self._worker = threading.Thread(target=run, daemon=True)
        self._worker.start()
        return True

    def compact_maybe_install(self, state):
        """Install a finished background fold if the cold layout has not
        moved since it was computed (else discard — it is stale)."""
        with self._lock:
            out, self._worker_out = self._worker_out, None
        if out is None:
            return state
        if out.gen != self._gen:
            return state                       # raced a spill/merge: drop
        state = self._install_fold(state, out, mark_futile=True)
        self.counters["compactions"] += 1
        return state

    def _discard_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            self._worker.join()
        with self._lock:
            self._worker_out = None

    # -- merge epoch (tombstone drain) ---------------------------------
    def merge_cold(self, state, tombs: np.ndarray):
        """The cold-enabled merge epoch: drain the whole device ring to
        host, fold ring + cold segments with the drained tombstones
        (dead ids physically dropped everywhere sealed), reset the ring.
        Synchronous: the device tombstone buffer resets in the same
        epoch."""
        with self.obs.span("cold_merge"):
            return self._merge_cold_impl(state, tombs)

    def _merge_cold_impl(self, state, tombs: np.ndarray):
        self._discard_worker()
        dev = self.device
        drain_p, _, store2 = ring_payload_drain(
            state.main_snaps, state.store, state.main_forest,
            torch.as_tensor(np.asarray(tombs, np.int32)).to(dev),
            self.main_cfg, self.main_tcfg, self.tree_mod)
        state = state._replace(store=store2)
        self._on_sync()
        ls = {k: _numpy(v, u32=k in ("keys", "blooms"))
              for k, v in state.lsh_snaps._asdict().items()}
        ms = {k: _numpy(v, u32=k in ("keys", "blooms"))
              for k, v in state.main_snaps._asdict().items()}
        ring_pay = _numpy(drain_p)
        n_ring = int(np.max(ls["n_snaps"]))
        ring_l = []
        for l in range(self.cfg.L):
            segs = [(ls["keys"][l][s], ls["ids"][l][s], ls["vals"][l][s],
                     np.full(ls["keys"][l][s].shape, ls["stamps"][l][s],
                             np.int32)) for s in range(n_ring)]
            ring_l.append(tuple(
                np.concatenate([seg[j] for seg in segs]) if segs
                else np.zeros((0,), np.int32) for j in range(4)))
        n_ring_m = int(ms["n_snaps"])
        segs = [(ms["keys"][s], ms["ids"][s], ms["vals"][s],
                 np.full(ms["keys"][s].shape, ms["stamps"][s], np.int32),
                 ring_pay[s]) for s in range(n_ring_m)]
        ring_m = tuple(
            np.concatenate([seg[j] for seg in segs]) if segs
            else (np.zeros((0, self.cfg.dim), np.float32) if j == 4
                  else np.zeros((0,), np.int32)) for j in range(5))

        dead = np.asarray(tombs)
        dead = dead[dead >= 0]
        fold = self._fold_all(dead, ring_extra=ring_l,
                              ring_extra_main=ring_m)
        state = state._replace(
            lsh_snaps=snap_mod.init_snapshots(self.lsh_cfg, self.cfg.L, dev),
            main_snaps=snap_mod.unbatch(
                snap_mod.init_snapshots(self.main_cfg, 1, dev)))
        state = self._install_fold(state, fold)
        self.counters["cold_merges"] += 1
        return state

    # -- checkpoint manifest -------------------------------------------
    def manifest(self) -> dict:
        """JSON-serializable cold layout: segment metadata by tier (each
        entry its gid, count, stamp and payload width) and the
        counters."""
        def entry(gid):
            return {"gid": gid, **self.store.meta(gid)}
        return {
            "lsh": [[entry(g) for g in row] for row in self.lsh_gids],
            "main": [entry(g) for g in self.main_gids],
            "counters": dict(self.counters),
        }

    def adopt_manifest(self, man: dict, src_paths: dict) -> None:
        """Rebuild the gid lists from a checkpoint manifest, importing
        every segment into this manager's store in manifest order (so a
        restored routing table's column c is still segment c);
        ``src_paths`` maps a manifest gid to its segment file."""
        self.lsh_gids = [[self.store.import_file(src_paths[e["gid"]], e)
                          for e in row] for row in man["lsh"]]
        self.main_gids = [self.store.import_file(src_paths[e["gid"]], e)
                          for e in man["main"]]
        self.counters.update(man.get("counters", {}))
        self._gen += 1
