"""Streaming request engine — the paper's online serving loop (§4.2).

Paper terminology -> this module:

* **actors / mailboxes** — every hash tree is an actor whose mailbox is
  one row of the dense ``(T, K)`` dispatch buffer (``core.dispatch``).
  The engine is the layer *in front* of dispatch: the global request
  stream that the paper's router thread drains.
* **rounds** — one step applies one micro-batch; mailbox overflow is
  re-submitted next round (the actor's bounded inbox).  Steady-state
  rounds stay on the device: the only host<->device traffic of an
  update round is ONE packed i32 flag word (pending/seal/merge signals,
  ``core.dispatch.pack_round_flags``) read back per round, and a query
  round's one result pickup (``core.index._pickup``).
* **maintenance epochs** — seal (hot tier -> sealed snapshots), merge
  (compaction + tombstone drain) and, with a cold tier
  (``PFOConfig.cold_segments > 0``), *spill* (oldest ring segment ->
  host segment store) run between rounds as explicit engine events,
  exactly when the flag word asks, never via ad-hoc device readbacks.
  Query rounds against a cold-tier index carry their cold
  wanted/missing masks inside the round's single result pickup: a
  round that touches only cache-resident segments costs zero extra
  transfers, a miss round fetches and re-probes
  (``core.coldtier``); delete rounds signal misses via the
  ``FLAG_COLD_MISS`` bit and the ``after_flags`` backend hook.

Backend interface
-----------------
The bucket/ordering/flag-word machinery is device-topology agnostic:
:class:`StreamEngine` drives a backend that owns the device state and
the steps.  Two backends implement the contract:

* :class:`LocalBackend` wraps a single-device
  :class:`~repro_torch.core.index.PFOIndex`;
* :class:`DistBackend` holds one rank's shard of a distributed state and
  drives the ``core.distributed`` rounds on ``torch.distributed`` (trees
  and MainTable over ``model``, query rows over ``data``).  Every rank
  runs the same engine on the same request stream, which replicates the
  updates over ``data``; each round's flag word is max-combined over the
  ranks, so every host decision is taken alike everywhere.
  :class:`DistStreamEngine` is the one-line assembly of engine +
  distributed backend.

The engine takes any object with an ``insert_round`` method as its
backend.

A backend supplies: its ``device``, per-bucket dispatch capacities, one
insert/delete round per bucket returning the packed flag word, a query
step, forced/flagged seal + merge epochs, and the carried-flag
bookkeeping (``ensure_flags`` / ``read_flags`` — ``sync_count`` counts
every explicit scalar readback, asserted one-per-round in tests).  The
engine never touches device state directly, so both topologies share
the window/strict semantics below, and the distributed engine answers
every trace as the single-device one does
(``tests/test_torch_dist.py``).

Double-buffered rounds: while the device executes micro-batch ``t``,
the host packs micro-batch ``t+1`` (the ``overlap`` hook fires between
the round's dispatch and its flag-word readback), so host batch
building hides under device execution; results block only at pickup
(``StreamConfig.async_rounds``).  A batch is packed into pinned host
tensors on a CUDA index and copied with ``non_blocking=True``, so the
copy of batch t+1 queues behind batch t instead of waiting for it.

Multi-client ingestion
----------------------
:meth:`StreamEngine.client` opens a :class:`StreamClient` with its own
**ticket space**: tickets are ``(client_id << 40) | seq``
(``core.dispatch.client_ticket``), so K independent submitters never
coordinate on ticket allocation.  At flush time the per-client queues
merge into ONE round via ``core.dispatch.merge_client_queues`` — fair
round-robin across clients, FIFO *within* each client (the router
thread of §4.2).  The ordering contract below then applies to the
merged round: per-client submission order is always respected;
cross-client order is the deterministic round-robin interleave.

Request-grain accounting + deadlines
------------------------------------
Every ticket is stamped with the host wall-clock at enqueue (the
fourth element of the ``(ticket, kind, payload, t_enq)`` queue tuple),
and when its micro-batch completes the engine decomposes the request's
end-to-end latency into three host-clock phases::

    req.e2e_ms{kind=}  =  req.queue_wait_ms   (enqueue -> flush start)
                        + req.batch_wait_ms   (flush start -> its
                                               batch's dispatch)
                        + req.service_ms      (dispatch -> its batch's
                                               result pickup/flag ack)

All four are plain host histograms — the accounting adds ZERO device
readbacks to a round.  Clients opened with ``client(deadline_ms=...)``
join that bound's **deadline class**: completions feed
``slo.requests`` / ``slo.violations`` counters and snapshot-time
burn-rate gauges (``repro_torch.obs.slo``), and a ``window``-mode flush
reorders its *query* half earliest-deadline-first (``slo.edf_order`` —
safe because every query in the window probes the same post-update
state), so deadline-critical requests form the window's first
micro-batch buckets.  The update half and ``strict`` mode are never
reordered.

The engine coalesces an *interleaved* stream of query / insert /
delete / update requests into fixed-shape micro-batches.  Batch shapes
are drawn from a small set of power-of-two **size buckets** and the
dispatch capacities for every bucket are precomputed, so the shapes
the steps see are bounded by ``len(buckets)`` per operation and cannot
grow with traffic.  Ragged tails are padded with inactive rows
(``active=False`` masks), which the steps already treat as no-ops.

Consistency (``StreamConfig.ordering``):

* ``"window"`` (default) — the paper's round semantics: every flush is
  one epoch; the window's updates apply first, then ALL of the
  window's queries probe the post-update state.  A query therefore
  sees every update submitted before it (read-your-writes) and
  possibly updates submitted later in the same window (bounded
  staleness in the *fresh* direction).  Within the update half, ops
  coalesce **by kind** (one delete batch, one update pair, one insert
  batch) because a dispatch round's cost is set by mailbox capacity,
  not row count; whenever an id is touched by two conflicting ops the
  epoch splits at that point, so per-id semantics always match the
  sequential order.  This is what lets a randomly interleaved stream
  collapse into a handful of micro-batches per window.
* ``"strict"`` — exact submission order: only runs of consecutive
  same-kind requests batch together, and an engine-fed index answers
  bit-identically to per-request ``PFOIndex`` calls — asserted in
  ``tests/test_torch_stream.py``.

Either way updates never reorder relative to each other, so the final
index state always equals the sequential one.

This mirrors the JAX package's ``serving/stream.py``: the same names,
semantics, counters and ``stats()`` keys.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import torch

from ..core import distributed as dist_mod
from ..core.dispatch import (FLAG_ANY_PENDING, FLAG_COLD_FULL, FLAG_COLD_MISS,
                             FLAG_COLD_SPILL, FLAG_NAMES, FLAG_NEED_SEAL,
                             FLAG_SNAPS_FULL, FLAG_TOMBS_FULL, client_ticket,
                             merge_client_queues, ticket_client)
from ..core.index import (PFOIndex, _pickup, delete_step, delete_step_cold,
                          insert_step, merge_step, query_step,
                          query_step_cold, round_capacities, round_flags,
                          seal_step)
from ..kernels import _build
from ..obs import Obs
from ..obs import report as obs_report
from ..obs import slo as obs_slo

QUERY, INSERT, DELETE, UPDATE = "query", "insert", "delete", "update"


def _pow2_buckets(lo: int, hi: int) -> tuple[int, ...]:
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


#: legacy query cap applied when the index runs the "loop" traversal
#: (the JAX package's while-loop walks penalize large query batches;
#: the port runs the masked traversal only, so it keeps the cap as
#: configuration)
LOOP_QUERY_MAX_BATCH = 16


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    max_batch: int = 256          # largest update micro-batch (power of two)
    min_batch: int = 8            # smallest size bucket (power of two)
    # Query chunk cap.  ``None`` (default) lets the engine decide from
    # the index's traversal mode: the fixed-trip masked traversal runs
    # query rows in lockstep over identical trip counts, so big query
    # buckets amortize and queries follow ``max_batch``; the legacy
    # "loop" traversal serializes to the slowest chain walk, so queries
    # stay capped at LOOP_QUERY_MAX_BATCH.
    query_max_batch: int | None = None
    default_k: int = 10           # top-k for queries submitted without k
    ordering: str = "window"      # "window" (round epochs) | "strict"
    # results already returned by flush() are retained for result()
    # lookups up to this many tickets, then evicted oldest-first —
    # bounds engine memory in a long-running serving loop.
    max_retained_results: int = 4096
    # double-buffered rounds: pack micro-batch t+1 on the host while
    # the device executes micro-batch t (see module docstring)
    async_rounds: bool = True

    def __post_init__(self):
        qmb = (self.max_batch if self.query_max_batch is None
               else self.query_max_batch)
        for v in (self.max_batch, self.min_batch, qmb):
            assert v & (v - 1) == 0, "buckets must be powers of two"
        assert self.min_batch <= self.max_batch
        assert self.min_batch <= qmb, \
            "query_max_batch below min_batch would dispatch off-bucket " \
            "shapes warmup never ran"
        assert self.ordering in ("window", "strict")

    @property
    def buckets(self) -> tuple[int, ...]:
        return _pow2_buckets(self.min_batch, self.max_batch)

    def query_cap(self, traversal: str) -> int:
        """Resolved query chunk cap for an index's traversal mode."""
        if self.query_max_batch is not None:
            return min(self.query_max_batch, self.max_batch)
        if traversal == "masked":
            return self.max_batch
        return min(max(LOOP_QUERY_MAX_BATCH, self.min_batch),
                   self.max_batch)


# ======================================================================
# the backend — the device contract the engine drives
# ======================================================================
class LocalBackend:
    """Single-device backend: a :class:`PFOIndex` and the ``core.index``
    steps, on the index's own device."""

    #: the kernels a stream's rounds launch on the card (the cold tier's
    #: query rounds add ``gather_rank_staged``)
    KERNELS = ("lsh_hash", "gather_rank")

    def __init__(self, index: PFOIndex):
        self.index = index
        self.cfg = index.cfg
        self.device = index.device
        self._cap_cache: dict[int, tuple[int, int]] = {}
        self._flags_caps = (0, 0)

    # -- observability --------------------------------------------------
    @property
    def obs(self) -> Obs:
        return self.index.obs

    def set_obs(self, obs: Obs) -> None:
        self.index.set_obs(obs)

    # -- capacities / flags --------------------------------------------
    def capacities(self, bucket: int) -> tuple[int, int]:
        """(main_capacity, lsh_capacity) for a bucket size."""
        if bucket not in self._cap_cache:
            self._cap_cache[bucket] = round_capacities(self.cfg, bucket)
        return self._cap_cache[bucket]

    def set_flags_caps(self, fm: int, fl: int) -> None:
        self._flags_caps = (fm, fl)

    @property
    def sync_count(self) -> int:
        return self.index.sync_count

    @property
    def maintenance_log(self) -> list:
        return self.index.maintenance_log

    def ensure_flags(self) -> int:
        fm, fl = self._flags_caps
        return self.index._ensure_flags(fm, fl)

    def read_flags(self, fw) -> int:
        return self.index._read_flags(fw, self._flags_caps)

    def maintain(self, flags: int) -> None:
        self.index._maintain(flags)

    # -- rounds ---------------------------------------------------------
    def query_rows(self, qvecs, k: int, overlap=None):
        """One query round.  ``overlap`` (the engine's double-buffer
        hook) is invoked after the first device dispatch and before any
        blocking pickup, so host packing of batch t+1 hides under
        batch t's device execution on both the cold and non-cold
        paths."""
        if self.index.cold is not None:
            # cold fetch loop: masks ride in the round's single pickup;
            # returns host arrays
            return self.index._query_cold(qvecs, k, overlap=overlap)
        out = query_step(self.index.state, qvecs, self.cfg, k)
        if overlap is not None:
            overlap()                 # dispatch in flight; pickup later
        return out

    def insert_begin(self, bucket: int):
        return torch.full((bucket,), -2, dtype=torch.int32,
                          device=self.device)       # slots: unallocated

    def insert_round(self, ids, vecs, carry, main_active, lsh_active,
                     bucket: int):
        mcap, lcap = self.capacities(bucket)
        fm, fl = self._flags_caps
        st, slots, ma, la, fw = insert_step(
            self.index.state, ids, vecs, carry, main_active, lsh_active,
            self.cfg, mcap, lcap, fm, fl)
        self.index.state = st
        return slots, ma, la, fw

    def delete_round(self, ids, active, bucket: int):
        mcap, lcap = self.capacities(bucket)
        fm, fl = self._flags_caps
        if self.index.cold is not None:
            st, pending, fw, wm, mm = delete_step_cold(
                self.index.state, ids, active, self.cfg, mcap, lcap,
                fm, fl)
            self.index.state = st
            self.index._delete_miss = (wm, mm)
            return pending, fw
        st, pending, fw = delete_step(self.index.state, ids, active,
                                      self.cfg, mcap, lcap, fm, fl)
        self.index.state = st
        return pending, fw

    def after_flags(self, flags: int) -> None:
        """Post-readback hook: service a delete round's COLD_MISS (fetch
        the missing cold segments before the retry round)."""
        self.index.fetch_delete_miss(flags)

    def cold_stats(self) -> dict | None:
        return self.index.cold.stats() if self.index.cold else None

    def count_insert(self, n: int) -> None:
        self.index.n_inserted += n

    @property
    def n_inserted(self) -> int:
        return self.index.n_inserted

    # -- epochs ---------------------------------------------------------
    def force_seal(self) -> None:
        self.index.state = seal_step(self.index.state, self.cfg)
        self.index._flags = None

    def force_merge(self) -> None:
        """A merge epoch now; with a cold tier the cold merge, as the
        flag word's TOMBS_FULL runs it (a device merge would drain the
        tombstones that hide deleted ids' spilled copies)."""
        if self.index.cold is not None:
            self.index._merge_with_cold()
        else:
            self.index.state = merge_step(self.index.state, self.cfg)
        self.index._flags = None

    # -- warmup ---------------------------------------------------------
    def warmup(self, buckets, qcap: int, default_k: int) -> None:
        """Build and load every kernel library the rounds launch, then
        run one all-inactive insert, delete and query round per bucket.
        The steps update the state's arenas in place, and an inactive
        round changes none of them: the state stays bit-identical (the
        returned one is dropped, as the JAX package drops it).  Seal,
        merge and spill launch no kernel of their own, so they need no
        warm-up (and a scratch state would hold a second full state on
        the card)."""
        idx, cfg, dev = self.index, self.cfg, self.device
        fm, fl = self._flags_caps
        cold = idx.cold is not None
        if dev.type == "cuda":
            names = self.KERNELS + (("gather_rank_staged",) if cold else ())
            _build.build(names)
            for name in names:
                _build.load(name)
        for b in buckets:
            mcap, lcap = self.capacities(b)
            ids = torch.zeros((b,), dtype=torch.int32, device=dev)
            vecs = torch.zeros((b, cfg.dim), dtype=torch.float32, device=dev)
            off = torch.zeros((b,), dtype=torch.bool, device=dev)
            insert_step(idx.state, ids, vecs, self.insert_begin(b), off,
                        torch.zeros((b * cfg.L,), dtype=torch.bool,
                                    device=dev), cfg, mcap, lcap, fm, fl)
            (delete_step_cold if cold else delete_step)(
                idx.state, ids, off, cfg, mcap, lcap, fm, fl)
            if b <= qcap:
                # the raw step, not query_rows: the cold fetch loop
                # would count warmup rounds into the cold manager
                (query_step_cold if cold else query_step)(
                    idx.state, vecs, cfg, default_k)
        round_flags(idx.state, cfg, fm, fl)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class DistBackend:
    """One rank's backend of the distributed engine: its shard of a
    distributed ``PFOState`` and the ``core.distributed`` rounds, on the
    mesh's device.

    Round variants are memoized per bucket (static mailbox capacities
    derive from the bucket) and the query per k, so the set of step
    shapes is bounded by the bucket table, never by traffic.  The flag
    word's thresholds use the same worst-case-bucket capacities as
    :class:`LocalBackend`, so epochs fire at the same rounds as on one
    device.  Host decisions that depend on one shard's host state (a
    full cold chain before a spill, a compaction, a fetch that made no
    progress) are agreed over the ranks with one ``all_reduce``, at
    epoch or miss time only.  ``stats()`` and ``cold_stats()`` are
    collectives: every rank calls them.
    """

    #: the kernels a stream's rounds launch on the card (its rank reads
    #: candidates with the inline formula, not ``gather_rank``)
    KERNELS = ("lsh_hash",)

    def __init__(self, dcfg, mesh, seed: int = 0,
                 cold_dir: str | None = None, proj: dict | None = None):
        self.dcfg, self.mesh, self.cfg = dcfg, mesh, dcfg.pfo
        self.device = mesh.device
        self.state = dist_mod.dist_init_state(dcfg, mesh, proj=proj,
                                              seed=seed)
        self.sync_count = 0
        self.maintenance_log: list[str] = []
        self.n_inserted = 0
        self.obs = Obs()
        self.obs.on_snapshot("dist", self._mirror_obs)
        # query candidates dropped by owner-mailbox skew (queries have no
        # retry round), accumulated on the device, read by stats() only
        self._query_drops = torch.zeros((), dtype=torch.int64,
                                        device=self.device)
        self._flags: int | None = None
        self._flags_caps = (0, 0)
        self._flags_fn = None
        self._ins: dict[int, Any] = {}
        self._del: dict[int, Any] = {}
        self._qry: dict[int, Any] = {}
        self._views = None           # (ring, cache key, views) of the probes
        self._seal_fn = dist_mod.make_dist_seal(dcfg, mesh)
        self._merge_fn = dist_mod.make_dist_merge(dcfg, mesh)
        # this rank's shard of the cold tier: one mixed-table chain under
        # cold_dir/shard<k> (a data replica other than 0 keeps its own)
        self.cold_mgr = None
        self._delete_miss = None
        if self.cfg.cold_enabled:
            root = None
            if cold_dir is not None:
                name = f"shard{mesh.shard}" + (
                    f".data{mesh.data_index}" if mesh.data_index else "")
                root = os.path.join(cold_dir, name)
            self.cold_mgr = dist_mod.shard_cold_manager(
                dcfg, mesh, root=root, on_sync=self._count_sync)

    def _count_sync(self) -> None:
        self.sync_count += 1

    def _agree_any(self, flag: bool) -> bool:
        """A host flag OR-combined over every rank (one ``all_reduce`` and
        one readback; epoch and miss service only)."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        (t,) = dist_mod._reduce_max(self.mesh.world_group, t)
        self._count_sync()
        return bool(t.item())

    # -- capacities / flags --------------------------------------------
    def capacities(self, bucket: int) -> tuple[int, int]:
        """Receive-side per-tree capacities: the single-device ones
        (``round_capacities``), so the per-tree mailbox scan stays as
        short as on one device."""
        return round_capacities(self.cfg, bucket)

    def route_capacities(self, bucket: int) -> tuple[int, int]:
        """Per-destination send mailboxes: ~2x the even spread; skew
        overflows surface as pending and retry."""
        S = self.dcfg.n_model
        rmain = int(max(8, 2 * -(-bucket // (S * S))))
        rlsh = int(max(8, 2 * -(-bucket * self.cfg.L // (S * S))))
        return rmain, rlsh

    def set_flags_caps(self, fm: int, fl: int) -> None:
        self._flags_caps = (fm, fl)
        self._flags_fn = dist_mod.make_dist_round_flags(self.dcfg, self.mesh,
                                                        fm, fl)

    def ensure_flags(self) -> int:
        if self._flags is not None:
            return self._flags
        return self.read_flags(self._flags_fn(self.state))

    def read_flags(self, fw) -> int:
        """THE readback of a round: one i32 word, the same on every rank."""
        self.sync_count += 1
        self._flags = int(fw.item())
        return self._flags

    # -- observability --------------------------------------------------
    def set_obs(self, obs: Obs) -> None:
        """Bind an observability handle; the shards' counters aggregate
        at snapshot time (``dist.*`` gauges; a collective)."""
        self.obs = obs
        obs.on_snapshot("dist", self._mirror_obs)

    def _mirror_obs(self) -> None:
        g = self.obs.gauge
        g("index.readbacks").set(self.sync_count)
        g("dist.shards").set(self.dcfg.n_model)
        g("dist.query_candidate_drops").set(int(self._query_drops.item()))
        occ = dist_mod.shard_occupancy(self.state, self.mesh)
        g("dist.shard_imbalance").set(occ["imbalance"])
        for s, v in enumerate(occ["items_per_shard"]):
            g("dist.items_hot", shard=s).set(v)
        if self.cold_mgr is not None:
            cs = self.cold_stats()
            for key in ("cold_segments", "fetches", "cache_hit_rate",
                        "vec_staging_hit_rate"):
                g(f"cold.{key}").set(cs[key])
            g("cold.spills").set(cs["segments_spilled"])
            g("cold.merges").set(cs["cold_merges"])

    def _epoch(self, name: str, fn, *args):
        t0 = time.perf_counter()
        with self.obs.span(name):
            out = fn(*args)
        self.obs.histogram("index.maint_ms", epoch=name).observe(
            (time.perf_counter() - t0) * 1e3)
        return out

    def maintain(self, flags: int) -> None:
        if flags & FLAG_NEED_SEAL:
            if self.cold_mgr is not None and flags & FLAG_COLD_SPILL:
                # capacity relief with a cold tier: spill, never merge
                # (lockstep rings: every shard spills this epoch)
                self._epoch("spill", self._spill)
                self.maintenance_log.append("spill")
            elif flags & FLAG_SNAPS_FULL:
                self.state = self._epoch("merge", self._merge_fn, self.state)
                self.maintenance_log.append("merge")
            self.state = self._epoch("seal", self._seal_fn, self.state)
            self.maintenance_log.append("seal")
        if flags & FLAG_TOMBS_FULL:
            if self.cold_mgr is not None:
                self._epoch("merge", self._merge_with_cold)
            else:
                self.state = self._epoch("merge", self._merge_fn, self.state)
            self.maintenance_log.append("merge")
        if self.cold_mgr is not None and flags & FLAG_COLD_FULL:
            self._compact()
        if flags & (FLAG_NEED_SEAL | FLAG_TOMBS_FULL):
            self._flags = None       # state changed; carried word stale

    # -- cold epochs (shard-local host halves) --------------------------
    def _spill(self) -> None:
        """Distributed spill epoch: every rank pops its shard's oldest
        ring segments and persists them through its own manager."""
        if self._agree_any(self.cold_mgr.n_cold >= self.cfg.cold_segments):
            self._compact(only_full=True)
        self.state = self.cold_mgr.spill(self.state)
        self._flags = None

    def _merge_with_cold(self) -> None:
        """Distributed cold merge: every rank drains its shard's ring,
        folds ring + cold chain with the replicated tombstones (host
        numpy, shard-local), installs the layout and resets its rings;
        the tombstone buffer drains alike everywhere."""
        self._count_sync()
        tombs = self.state.tombstones.cpu().numpy()
        self.state = self.cold_mgr.merge_cold(self.state, tombs)
        self.state = self.state._replace(
            tombstones=torch.full_like(self.state.tombstones, -1),
            n_tombstones=torch.zeros_like(self.state.n_tombstones))

    def _compact(self, only_full: bool = False) -> None:
        """Synchronous cold compaction of every shard at once, when any
        shard wants one: ``only_full``, a shard whose routing table is
        full (the pre-spill guard), else a shard not in futile backoff.
        Every shard folds, since a fold's survivors are agreed over the
        shards (``distributed.host_fold_filter``)."""
        mgr = self.cold_mgr
        fold = (mgr.n_cold >= self.cfg.cold_segments if only_full
                else mgr._gen != mgr._futile_gen)
        if not self._agree_any(fold):
            return
        self.state = mgr.compact(self.state)
        self.maintenance_log.append("cold_compact")
        self._flags = None

    # -- rounds ---------------------------------------------------------
    def _insert_fn(self, bucket: int):
        if bucket not in self._ins:
            tm, tl = self.capacities(bucket)
            rm, rl = self.route_capacities(bucket)
            fm, fl = self._flags_caps
            self._ins[bucket] = dist_mod.make_dist_insert_round(
                self.dcfg, self.mesh, route_main=rm, tree_main=tm,
                route_lsh=rl, tree_lsh=tl, flags_main=fm, flags_lsh=fl)
        return self._ins[bucket]

    def _delete_fn(self, bucket: int):
        if bucket not in self._del:
            tm, tl = self.capacities(bucket)
            _, rl = self.route_capacities(bucket)
            fm, fl = self._flags_caps
            self._del[bucket] = dist_mod.make_dist_delete_round(
                self.dcfg, self.mesh, tree_main=tm, route_lsh=rl,
                tree_lsh=tl, flags_main=fm, flags_lsh=fl)
        return self._del[bucket]

    def _query_fn(self, k: int):
        if k not in self._qry:
            self._qry[k] = dist_mod.make_dist_query(
                self.dcfg, self.mesh, k, with_drop_count=True)
        return self._qry[k]

    def _probe_views(self):
        """The (table, key) views of this shard's mixed ring and cold
        cache, rebuilt only after an epoch replaced the ring or a fetch
        or an install changed the cache."""
        st = self.state
        fetches = (None if self.cold_mgr is None
                   else self.cold_mgr.counters["fetches"])
        v = self._views
        if v is None or v[0] is not st.lsh_snaps or v[1] is not st.cold \
                or v[2] != fetches:
            self._views = v = (st.lsh_snaps, st.cold, fetches,
                               dist_mod.dist_views(st))
        return v[3]

    def query_rows(self, qvecs, k: int, overlap=None):
        fn = self._query_fn(k)
        if self.cold_mgr is None:
            ids, dists, dropped = fn(self.state, qvecs, self._probe_views())
            self._query_drops += dropped               # stays on the device
            if overlap is not None:
                overlap()             # dispatch in flight; pickup later
            return ids, dists
        # cold fetch loop (``PFOIndex._query_cold``): the masks and the
        # every-rank miss flag ride the round's one pickup, so every rank
        # takes the same number of attempts
        mgr = self.cold_mgr
        for attempt in range(self.cfg.cold_fetch_rounds + 1):
            out = fn(self.state, qvecs, self._probe_views())
            if attempt == 0 and overlap is not None:
                overlap()            # first dispatch is in flight
            ids, dists, dropped, wl, ml, wm, mm, info, miss = _pickup(out)
            self._query_drops += int(dropped)
            mgr.record_query_round(info)
            if not miss:
                break
            if attempt == self.cfg.cold_fetch_rounds:
                mgr.counters["incomplete_query_rounds"] += 1
                break
            before = mgr.counters["fetches"]
            with self.obs.span("cold_fetch", attempt=attempt):
                self.state = self.state._replace(cold=mgr.fetch_cold(
                    self.state.cold, wl.astype(bool)[None],
                    ml.astype(bool)[None], wm.astype(bool), mm.astype(bool)))
            if not self._agree_any(mgr.counters["fetches"] != before):
                # every cache slot is wanted by this round on every
                # missing shard: the miss set can never drain
                mgr.counters["incomplete_query_rounds"] += 1
                break
        return ids, dists

    def insert_begin(self, bucket: int):
        return None                       # slots live at the owner shard

    def insert_round(self, ids, vecs, carry, main_active, lsh_active,
                     bucket: int):
        self.state, ma, la, fw = self._insert_fn(bucket)(
            self.state, ids, vecs, main_active, lsh_active)
        return carry, ma, la, fw

    def delete_round(self, ids, active, bucket: int):
        out = self._delete_fn(bucket)(self.state, ids, active)
        self.state, pending, fw = out[:3]
        if self.cold_mgr is not None:
            self._delete_miss = out[3:]
        return pending, fw

    def after_flags(self, flags: int) -> None:
        """COLD_MISS service: a delete round's MainTable probe matched a
        non-resident cold segment on some shard — every rank reads its
        stashed masks (the only extra readback, and only on miss rounds)
        and fetches into its own cache before the retry round."""
        if self.cold_mgr is None or not flags & FLAG_COLD_MISS \
                or self._delete_miss is None:
            return
        self._count_sync()
        wm, mm = (m.astype(bool) for m in _pickup(self._delete_miss))
        self._delete_miss = None
        mgr = self.cold_mgr
        zeros = np.zeros((1, self.cfg.cold_segments), bool)
        before = mgr.counters["fetches"]
        with self.obs.span("cold_fetch", path="delete"):
            self.state = self.state._replace(cold=mgr.fetch_cold(
                self.state.cold, zeros, zeros, wm, mm))
        if self._agree_any(bool(mm.any())
                           and mgr.counters["fetches"] == before):
            raise RuntimeError(
                "delete cannot resolve: its Bloom route spans more cold "
                f"segments than cold_cache_slots={self.cfg.cold_cache_slots}"
                " can hold at once; raise PFOConfig.cold_cache_slots")

    def cold_stats(self) -> dict | None:
        """The cluster's cold stats (a collective).  Query accounting is
        recorded on every rank as the cluster total already; structural
        counters (spills, fetches, segments, bytes) sum over shards."""
        if self.cold_mgr is None:
            return None
        out = self.cold_mgr.stats()
        keys = ("cold_segments", "segments_spilled", "fetches",
                "fetch_rounds", "compactions", "cold_merges",
                "store_bytes_written", "vec_fetch_bytes", "vec_evictions",
                "vec_resident_pages")
        mine = torch.tensor([out[k2] for k2 in keys], dtype=torch.int64,
                            device=self.device)
        tot = dist_mod._all_gather(self.mesh.model_group, self.dcfg.n_model,
                                   mine).sum(0).tolist()
        out.update(zip(keys, tot))
        qr = max(self.cold_mgr.counters["query_rounds"], 1)
        out["fetches_per_query_round"] = round(out["fetches"] / qr, 4)
        out["shards"] = self.dcfg.n_model
        return out

    def count_insert(self, n: int) -> None:
        self.n_inserted += n

    # -- epochs ---------------------------------------------------------
    def force_seal(self) -> None:
        self.state = self._seal_fn(self.state)
        self._flags = None

    def force_merge(self) -> None:
        """A merge epoch now; with a cold tier the cold merge, as the
        flag word's TOMBS_FULL runs it (a ring merge would drain the
        tombstones that hide deleted ids' spilled copies)."""
        if self.cold_mgr is not None:
            self._merge_with_cold()
        else:
            self.state = self._merge_fn(self.state)
        self._flags = None

    # -- warmup ---------------------------------------------------------
    def warmup(self, buckets, qcap: int, default_k: int) -> None:
        """Build and load the kernels the rounds launch, then run one
        all-inactive insert, delete and query round per bucket on every
        rank (their collectives included).  An inactive round changes no
        arena: the state stays bit-identical (the returned one is
        dropped)."""
        cfg, dev = self.cfg, self.device
        if dev.type == "cuda":
            _build.build(self.KERNELS)
            for name in self.KERNELS:
                _build.load(name)
        for b in buckets:
            ids = torch.zeros((b,), dtype=torch.int32, device=dev)
            vecs = torch.zeros((b, cfg.dim), dtype=torch.float32, device=dev)
            off = torch.zeros((b,), dtype=torch.bool, device=dev)
            self._insert_fn(b)(self.state, ids, vecs, off,
                               torch.zeros((b * cfg.L,), dtype=torch.bool,
                                           device=dev))
            self._delete_fn(b)(self.state, ids, off)
            if b <= qcap:
                # the raw program, not query_rows: the cold fetch loop
                # would count warmup rounds into the manager
                self._query_fn(default_k)(self.state, vecs,
                                          self._probe_views())
        self._flags_fn(self.state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def stats(self) -> dict:
        """Occupancy over every shard (a collective)."""
        st = self.state
        mine = torch.stack([
            st.main_forest.n_items.sum(), st.lsh_forest.n_items.sum(),
            st.store.free_top.to(torch.int64),
            st.lsh_forest.overflow.sum()]).to(torch.int64)
        tot = dist_mod._all_gather(self.mesh.model_group, self.dcfg.n_model,
                                   mine).sum(0).tolist()
        return {
            "items_hot": tot[0],
            "lsh_leaves": tot[1],
            "snapshots": int(st.main_snaps.n_snaps),
            "tombstones": int(st.n_tombstones),
            "store_free": tot[2],
            "overflow_events": tot[3],
            "query_candidate_drops": int(self._query_drops.item()),
            "stamp": int(st.stamp),
        }


# ======================================================================
# multi-client handles (per-client ticket spaces — module docstring)
# ======================================================================
class StreamClient:
    """A submitter handle with its own FIFO queue and ticket space.

    ``deadline_ms`` (set via :meth:`StreamEngine.client`) places every
    request this client submits in that deadline class — see the
    request-grain accounting section of the module docstring."""

    def __init__(self, engine: "StreamEngine", cid: int,
                 deadline_ms: float | None = None):
        self._engine = engine
        self.cid = cid
        self.deadline_ms = deadline_ms
        self._buf: list[tuple[int, str, Any, float]] = []
        self._seq = 0

    def _enqueue(self, kind: str, payload,
                 t_arrival: float | None = None) -> int:
        t = client_ticket(self.cid, self._seq)
        self._seq += 1
        # the enqueue stamp rides the queue tuple (host wall-clock):
        # request-grain latency accounting starts here.  ``t_arrival``
        # (a time.perf_counter() value) backdates the stamp to when the
        # request actually arrived — an upstream front-end stamps at
        # socket receive so queue_wait covers its backlog too, and an
        # open-loop driver stamps its Poisson arrival clock.
        self._buf.append((t, kind, payload,
                          time.perf_counter() if t_arrival is None
                          else t_arrival))
        self._engine.n_requests += 1
        return t

    def query(self, vec, k: int | None = None,
              t_arrival: float | None = None) -> int:
        e = self._engine
        vec = np.asarray(vec, np.float32).reshape(e._dim)
        return self._enqueue(QUERY, (vec, int(k or e.scfg.default_k)),
                             t_arrival)

    def insert(self, vid: int, vec,
               t_arrival: float | None = None) -> int:
        vec = np.asarray(vec, np.float32).reshape(self._engine._dim)
        return self._enqueue(INSERT, (int(vid), vec), t_arrival)

    def delete(self, vid: int, t_arrival: float | None = None) -> int:
        return self._enqueue(DELETE, int(vid), t_arrival)

    def update(self, vid: int, vec,
               t_arrival: float | None = None) -> int:
        vec = np.asarray(vec, np.float32).reshape(self._engine._dim)
        return self._enqueue(UPDATE, (int(vid), vec), t_arrival)

    def pending(self) -> int:
        return len(self._buf)

    def result(self, ticket: int):
        return self._engine.result(ticket)


def _to_host(ids, dists):
    """A query round's answer as host arrays of the JAX package's dtypes
    (int32 ids, float32 distances), as ``PFOIndex.query`` returns them;
    device tensors come back in one transfer."""
    if torch.is_tensor(ids):
        ids, dists = _pickup((ids, dists))
    return ids.astype(np.int32), dists.astype(np.float32)


# ======================================================================
# the engine
# ======================================================================
class StreamEngine:
    """Online query/update front-end over a backend (see module doc).

    Submission enqueues and returns a ticket immediately; :meth:`flush`
    drains the stream in order and materializes results.  ``stats()``
    exposes round/readback/maintenance counters — including per-kind
    round counts and readbacks-per-round, so the one-readback-per-round
    invariant is assertable from tests.  The engine runs on its
    backend's device and has no device choice of its own.
    """

    MAX_ROUNDS = PFOIndex.MAX_ROUNDS

    def __init__(self, index, scfg: StreamConfig | None = None,
                 obs: Obs | None = None):
        self.backend = index if hasattr(index, "insert_round") \
            else LocalBackend(index)
        self.index = getattr(self.backend, "index", None)
        self.scfg = scfg or StreamConfig()
        cfg = self.backend.cfg
        mb = self.scfg.max_batch
        # flag-word headroom is computed against the worst-case bucket
        # so one carried word stays valid across bucket sizes
        self.backend.set_flags_caps(*self.backend.capacities(mb))
        # query chunk cap resolved against the index's traversal mode
        self._query_cap = self.scfg.query_cap(cfg.traversal)
        self._device = torch.device(self.backend.device)
        # packed batches cross to a card from pinned host tensors
        self._pin = self._device.type == "cuda"
        self._clients: list[StreamClient] = []
        self._self_client = StreamClient(self, 0)
        # deadline classes (client id -> deadline_ms) + the pluggable
        # window-mode flush policy over the query half (slo.edf_order:
        # earliest-deadline-first; only consulted when a deadline
        # client exists, so deadline-free engines skip the sort)
        self._deadlines: dict[int, float] = {}
        self.flush_policy = obs_slo.edf_order
        self._t_flush = time.perf_counter()
        self._results: dict[int, Any] = {}
        self.events: list[tuple[str, int]] = []        # (epoch kind, flush#)
        self.n_flushes = 0
        self.n_batches = 0
        self.n_rounds = 0
        self.n_requests = 0
        self.n_rounds_by_kind = {QUERY: 0, INSERT: 0, DELETE: 0, UPDATE: 0}
        self._dim = cfg.dim
        # observability: inherit the backend's handle unless an explicit
        # one is supplied (then the backend — index, cold manager — is
        # rebound to it).  All recording is host-side; see repro_torch.obs.
        if obs is not None:
            self.backend.set_obs(obs)
        self._bind_obs()

    # ------------------------------------------------------------------
    # observability binding (metric handles cached off the hot path)
    # ------------------------------------------------------------------
    def set_obs(self, obs: Obs) -> None:
        """Rebind engine + backend to a new observability handle."""
        self.backend.set_obs(obs)
        self._bind_obs()

    def _bind_obs(self) -> None:
        o = self.obs = self.backend.obs
        self._obs_on = o.enabled
        self._h_round = {k: o.histogram("stream.round_ms", kind=k)
                         for k in (QUERY, INSERT, DELETE, UPDATE)}
        self._h_flush = o.histogram("stream.flush_ms")
        self._h_fill = o.histogram("stream.batch_fill")
        self._h_bucket = o.histogram("stream.bucket_rows")
        self._g_queue = o.gauge("stream.queue_depth")
        # request-grain lifecycle histograms (module docstring): e2e is
        # per kind; the decomposition shares one histogram each so the
        # metric count stays flat
        self._h_e2e = {k: o.histogram("req.e2e_ms", kind=k)
                       for k in (QUERY, INSERT, DELETE, UPDATE)}
        self._h_queue_wait = o.histogram("req.queue_wait_ms")
        self._h_batch_wait = o.histogram("req.batch_wait_ms")
        self._h_service = o.histogram("req.service_ms")
        self._slo = obs_slo.SLOTracker(o)
        self._c_flags = tuple(
            (bit, o.counter("stream.flag_fired", flag=name))
            for bit, name in FLAG_NAMES.items())
        o.on_snapshot("stream", self._mirror_obs)

    def _mirror_obs(self) -> None:
        """Lazy snapshot mirror: engine counters -> gauges, only when a
        snapshot is taken — zero double bookkeeping per round."""
        o = self.obs
        o.gauge("stream.requests").set(self.n_requests)
        o.gauge("stream.flushes").set(self.n_flushes)
        o.gauge("stream.batches").set(self.n_batches)
        o.gauge("stream.rounds").set(self.n_rounds)
        for k, v in self.n_rounds_by_kind.items():
            o.gauge("stream.rounds", kind=k).set(v)
        o.gauge("stream.clients").set(1 + len(self._clients))
        for ev in ("seal", "merge", "spill"):
            o.gauge("stream.epochs", kind=ev).set(
                sum(1 for e, _ in self.events if e == ev))

    # ------------------------------------------------------------------
    # warmup: every kernel built and loaded, every (op, bucket) run once
    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Build and load every kernel the engine's rounds launch and run
        each (op, bucket) once with all-inactive batches, so no kernel
        build lands inside a serving round.  The index state is left
        bit-identical (:meth:`LocalBackend.warmup`)."""
        self.backend.warmup(self.scfg.buckets, self._query_cap,
                            self.scfg.default_k)

    # ------------------------------------------------------------------
    # submission (the request stream)
    # ------------------------------------------------------------------
    def client(self, deadline_ms: float | None = None) -> StreamClient:
        """Open a new client handle with its own ticket space (see the
        multi-client contract in the module docstring).

        ``deadline_ms`` assigns the client a deadline class: its
        completed requests feed the ``slo.*`` violation counters and
        burn-rate gauges, and window-mode flushes prioritize its
        queries earliest-deadline-first (``repro_torch.obs.slo``)."""
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            assert deadline_ms > 0, "deadline_ms must be positive"
        c = StreamClient(self, len(self._clients) + 1,
                         deadline_ms=deadline_ms)
        self._clients.append(c)
        if deadline_ms is not None:
            self._deadlines[c.cid] = deadline_ms
        return c

    def query(self, vec, k: int | None = None) -> int:
        return self._self_client.query(vec, k)

    def insert(self, vid: int, vec) -> int:
        return self._self_client.insert(vid, vec)

    def delete(self, vid: int) -> int:
        return self._self_client.delete(vid)

    def update(self, vid: int, vec) -> int:
        """Online update (paper §5): new version written, old reclaimed."""
        return self._self_client.update(vid, vec)

    # ------------------------------------------------------------------
    # draining
    # ------------------------------------------------------------------
    def pending(self) -> int:
        return (len(self._self_client._buf)
                + sum(len(c._buf) for c in self._clients))

    def result(self, ticket: int):
        """Result for ``ticket`` (flushes if still queued)."""
        if ticket not in self._results:
            self.flush()
        return self._results.pop(ticket)

    def _ingest(self) -> list:
        """Merge the per-client queues into this flush's round."""
        queues = [self._self_client._buf] + [c._buf for c in self._clients]
        live = [q for q in queues if q]
        merged = list(live[0]) if len(live) == 1 \
            else merge_client_queues(live)
        for q in queues:
            q.clear()
        return merged

    def flush(self) -> dict[int, Any]:
        """Drain the queue; returns {ticket: result} for every request
        processed by this flush.  ``window`` ordering applies the
        window's updates first (in order), then all queries; ``strict``
        keeps exact submission order (see module docstring)."""
        self._g_queue.set(self.pending())
        queue = self._ingest()
        t0 = time.perf_counter()
        self._t_flush = t0                # queue_wait / batch_wait pivot
        with self.obs.span("flush", depth=len(queue)):
            out: dict[int, Any] = {}
            if self.scfg.ordering == "window":
                updates = [r for r in queue if r[1] != QUERY]
                queries = [r for r in queue if r[1] == QUERY]
                if self._deadlines:
                    # deadline-aware bucket priority: the window's
                    # queries all probe the same post-update state, so
                    # reordering them is semantics-free (module doc)
                    queries = self.flush_policy(queries, self._deadlines)
                self._drain_updates_coalesced(updates, out)
                self._drain_in_runs(queries, out)
            else:
                self._drain_in_runs(queue, out)
            self._results.update(out)
            while len(self._results) > self.scfg.max_retained_results:
                self._results.pop(next(iter(self._results)))  # oldest first
            self.n_flushes += 1
        self._h_flush.observe((time.perf_counter() - t0) * 1e3)
        return out

    def _drain_updates_coalesced(self, updates: list, out: dict) -> None:
        """Window mode: coalesce the update half by kind.

        Ops land in per-kind epochs — deletes, then updates, then
        inserts — which is order-equivalent to submission order as long
        as no id is touched twice with conflicting kinds inside one
        epoch; on conflict (or an UPDATE repeat, whose delete half must
        see the previous version) the epoch is flushed first.  Repeated
        same-kind inserts/deletes are submission-stable within a batch
        (dispatch sorts stably), so they need no split."""
        epoch: dict[str, list] = {DELETE: [], UPDATE: [], INSERT: []}
        touched: dict[int, str] = {}
        for req in updates:
            kind, payload = req[1], req[2]
            vid = payload if kind == DELETE else payload[0]
            prev = touched.get(vid)
            if prev is not None and (prev != kind or kind == UPDATE):
                self._flush_epoch(epoch, out)
                epoch = {DELETE: [], UPDATE: [], INSERT: []}
                touched = {}
            touched[vid] = kind
            epoch[kind].append(req)
        self._flush_epoch(epoch, out)

    def _flush_epoch(self, epoch: dict, out: dict) -> None:
        for kind in (DELETE, UPDATE, INSERT):
            if epoch[kind]:
                self._run(epoch[kind], kind, out)

    def _drain_in_runs(self, queue: list, out: dict) -> None:
        """Batch maximal runs of same-kind (and same-k, for queries)
        consecutive requests; never reorders within ``queue``."""
        i = 0
        while i < len(queue):
            kind = queue[i][1]
            key = (kind, queue[i][2][1]) if kind == QUERY else kind
            j = i
            while j < len(queue) and queue[j][1] == kind and (
                    kind != QUERY or queue[j][2][1] == key[1]):
                j += 1
            self._run(queue[i:j], kind, out)
            i = j

    # -- micro-batching -------------------------------------------------
    def _bucket(self, n: int, cap: int) -> int:
        for b in self.scfg.buckets:
            if n <= b:
                return min(b, cap)
        return cap

    def _chunks(self, run: list, cap: int):
        i = 0
        while i < len(run):
            take = min(len(run) - i, cap)
            yield run[i:i + take], self._bucket(take, cap)
            i += take

    def _run(self, run: list, kind: str, out: dict) -> None:
        if kind == UPDATE:
            # An update chunk is one delete batch + one insert batch, so
            # repeated ids inside a chunk would leave the stale version
            # live (its delete half sees only the pre-chunk state) —
            # split the run so each id appears once per chunk.
            sub: list = []
            seen: set = set()
            for req in run:
                if req[2][0] in seen:
                    self._run_chunks(sub, kind, out)
                    sub, seen = [], set()
                sub.append(req)
                seen.add(req[2][0])
            self._run_chunks(sub, kind, out)
        else:
            self._run_chunks(run, kind, out)

    def _cap_for(self, kind: str) -> int:
        return self._query_cap if kind == QUERY else self.scfg.max_batch

    def _run_chunks(self, run: list, kind: str, out: dict) -> None:
        chunks = list(self._chunks(run, self._cap_for(kind)))
        if not chunks:
            return
        with self.obs.span("pack", kind=kind):
            packed = self._pack(kind, *chunks[0])
        for i, (chunk, bucket) in enumerate(chunks):
            if self._obs_on:
                self._h_fill.observe(len(chunk) / bucket)
                self._h_bucket.observe(bucket)
            # double-buffer hook: the batch methods call this between
            # their first device dispatch and the first (blocking)
            # flag/result readback, so batch t+1's host packing hides
            # under batch t's device execution
            hold: dict = {}
            overlap = None
            if self.scfg.async_rounds and i + 1 < len(chunks):
                nxt = chunks[i + 1]

                def overlap(nxt=nxt, hold=hold):
                    with self.obs.span("pack", kind=kind):
                        hold["p"] = self._pack(kind, *nxt)

            t_disp = time.perf_counter()
            if kind == QUERY:
                self._query_batch(packed, chunk, bucket, out, overlap)
            elif kind == INSERT:
                self._insert_batch(packed, chunk, bucket, out,
                                   INSERT, overlap)
            elif kind == DELETE:
                self._delete_batch(packed, chunk, bucket, out,
                                   DELETE, overlap)
            else:                                           # UPDATE
                self._delete_batch(packed["del"], chunk, bucket, None,
                                   UPDATE, overlap)
                self._insert_batch(packed["ins"], chunk, bucket, out,
                                   UPDATE, None)
            self.n_batches += 1
            if self._obs_on:
                self._account(chunk, kind, t_disp, time.perf_counter())
            if i + 1 < len(chunks):
                packed = hold.get("p")
                if packed is None:
                    with self.obs.span("pack", kind=kind):
                        packed = self._pack(kind, *chunks[i + 1])

    # ------------------------------------------------------------------
    # request-grain lifecycle accounting (module docstring): pure host
    # arithmetic on the enqueue stamp riding each queue tuple — never
    # touches a device value, so it adds no readback by construction
    # ------------------------------------------------------------------
    def _account(self, chunk: list, kind: str, t_disp: float,
                 t_done: float) -> None:
        h_e2e = self._h_e2e[kind]
        t_flush = self._t_flush
        batch_wait_ms = (t_disp - t_flush) * 1e3
        service_ms = (t_done - t_disp) * 1e3
        deadlines = self._deadlines
        for req in chunk:
            t_enq = req[3]
            e2e_ms = (t_done - t_enq) * 1e3
            h_e2e.observe(e2e_ms)
            self._h_queue_wait.observe((t_flush - t_enq) * 1e3)
            self._h_batch_wait.observe(batch_wait_ms)
            self._h_service.observe(service_ms)
            if deadlines:
                dl = deadlines.get(ticket_client(req[0]))
                if dl is not None:
                    self._slo.observe(dl, e2e_ms)

    # ------------------------------------------------------------------
    # host-side batch packing (the half that double-buffers)
    # ------------------------------------------------------------------
    def _host(self, shape, dtype) -> torch.Tensor:
        """A zeroed host buffer for one packed batch (pinned on a card)."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    def _put(self, host: torch.Tensor) -> torch.Tensor:
        """A packed host buffer on the device; a pinned buffer's copy
        queues on the stream without waiting for it (on the CPU this is
        the buffer itself)."""
        return host.to(self._device, non_blocking=True)

    def _pack(self, kind: str, chunk: list, bucket: int):
        if kind == QUERY:
            q = self._host((bucket, self._dim), torch.float32)
            qn = q.numpy()
            for r, (_, _, (vec, _), _) in enumerate(chunk):
                qn[r] = vec
            return (self._put(q), chunk[0][2][1])
        if kind == INSERT or kind == UPDATE:
            ids = self._host((bucket,), torch.int32)
            vecs = self._host((bucket, self._dim), torch.float32)
            mask = self._host((bucket,), torch.bool)
            idn, vn, mn = ids.numpy(), vecs.numpy(), mask.numpy()
            for r, (_, _, (vid, vec), _) in enumerate(chunk):
                idn[r], vn[r], mn[r] = vid, vec, True
            ins = (self._put(ids), self._put(vecs), self._put(mask))
            if kind == INSERT:
                return ins
            return {"del": (ins[0], ins[2]), "ins": ins}
        # DELETE
        ids = self._host((bucket,), torch.int32)
        mask = self._host((bucket,), torch.bool)
        idn, mn = ids.numpy(), mask.numpy()
        for r, (_, rkind, payload, _) in enumerate(chunk):
            idn[r] = payload if rkind == DELETE else payload[0]
            mn[r] = True
        return (self._put(ids), self._put(mask))

    # ------------------------------------------------------------------
    # device rounds (all flag-word driven; see module docstring)
    # ------------------------------------------------------------------
    def _maintain(self, flags: int) -> None:
        before = len(self.backend.maintenance_log)
        self.backend.maintain(flags)
        for ev in self.backend.maintenance_log[before:]:
            self.events.append((ev, self.n_flushes))

    def _query_batch(self, packed, chunk: list, bucket: int, out: dict,
                     overlap=None) -> None:
        q_d, k = packed
        t0 = time.perf_counter()
        # the backend invokes overlap() itself, right after its first
        # device dispatch (the cold fetch loop would otherwise block to
        # completion before the engine could start packing batch t+1)
        with self.obs.span("dispatch", kind=QUERY, bucket=bucket):
            ids, dists = self.backend.query_rows(q_d, k, overlap=overlap)
        self.n_rounds_by_kind[QUERY] += 1
        with self.obs.span("result_pickup", kind=QUERY):
            ids, dists = _to_host(ids, dists)
        if self._obs_on:
            self._h_round[QUERY].observe((time.perf_counter() - t0) * 1e3)
        for r, (ticket, _, _, _) in enumerate(chunk):
            out[ticket] = (ids[r], dists[r])

    def _insert_batch(self, packed, chunk: list, bucket: int, out,
                      stat_kind: str = INSERT, overlap=None) -> None:
        be = self.backend
        ids_d, vecs_d, mask = packed
        carry = be.insert_begin(bucket)
        main_active = mask
        # each row's L table entries: expand, never a host-sized repeat
        lsh_active = mask[:, None].expand(-1, be.cfg.L).reshape(-1)
        flags = be.ensure_flags()
        for r in range(self.MAX_ROUNDS):
            self._maintain(flags)
            t0 = time.perf_counter()
            with self.obs.span("dispatch", kind=stat_kind, bucket=bucket):
                carry, main_active, lsh_active, fw = be.insert_round(
                    ids_d, vecs_d, carry, main_active, lsh_active, bucket)
            self.n_rounds += 1
            self.n_rounds_by_kind[stat_kind] += 1
            if r == 0 and overlap is not None:
                overlap()
            with self.obs.span("flag_readback", kind=stat_kind):
                flags = be.read_flags(fw)
            be.after_flags(flags)
            if self._obs_on:
                self._h_round[stat_kind].observe(
                    (time.perf_counter() - t0) * 1e3)
                if flags:
                    for bit, c in self._c_flags:
                        if flags & bit:
                            c.inc()
            if not flags & FLAG_ANY_PENDING:
                break
        be.count_insert(len(chunk))
        if out is not None:
            for ticket, _, _, _ in chunk:
                out[ticket] = "ok"

    def _delete_batch(self, packed, chunk: list, bucket: int, out,
                      stat_kind: str = DELETE, overlap=None) -> None:
        be = self.backend
        ids_d, active = packed
        flags = be.ensure_flags()
        for r in range(self.MAX_ROUNDS):
            self._maintain(flags)
            t0 = time.perf_counter()
            with self.obs.span("dispatch", kind=stat_kind, bucket=bucket):
                pending, fw = be.delete_round(ids_d, active, bucket)
            self.n_rounds += 1
            self.n_rounds_by_kind[stat_kind] += 1
            if r == 0 and overlap is not None:
                overlap()
            with self.obs.span("flag_readback", kind=stat_kind):
                flags = be.read_flags(fw)
            be.after_flags(flags)
            if self._obs_on:
                self._h_round[stat_kind].observe(
                    (time.perf_counter() - t0) * 1e3)
                if flags:
                    for bit, c in self._c_flags:
                        if flags & bit:
                            c.inc()
            if not flags & FLAG_ANY_PENDING:
                break
            active = pending
        if out is not None:
            for ticket, _, _, _ in chunk:
                out[ticket] = "ok"

    # ------------------------------------------------------------------
    # explicit epochs + stats
    # ------------------------------------------------------------------
    def seal(self) -> None:
        """Force a seal epoch (hot tier -> sealed snapshots).  A ring with
        no room is relieved first, as the flag word's own seal relieves
        it (merge, or spill with a cold tier): a seal into a full ring
        would drop the segment, and the items with it."""
        relief = self.backend.ensure_flags() & (FLAG_SNAPS_FULL
                                                | FLAG_COLD_SPILL)
        if relief:
            self._maintain(FLAG_NEED_SEAL | relief)
            return
        self.backend.force_seal()
        self.events.append(("seal", self.n_flushes))

    def merge(self) -> None:
        """Force a merge epoch (compaction + tombstone drain; the cold
        merge with a cold tier)."""
        self.backend.force_merge()
        self.events.append(("merge", self.n_flushes))

    def stats(self) -> dict:
        update_rounds = self.n_rounds
        readbacks = self.backend.sync_count
        return {
            "requests": self.n_requests,
            "flushes": self.n_flushes,
            "batches": self.n_batches,
            "rounds": self.n_rounds,
            "rounds_by_kind": dict(self.n_rounds_by_kind),
            "readbacks": readbacks,
            # steady state this is exactly 1.0; warmup/capacity-growth
            # flag probes can push it epsilon above (assert on deltas).
            # The derivation (incl. the zero-rounds guard) lives in
            # repro_torch.obs.report so this view and Obs.snapshot()
            # agree.
            "readbacks_per_round": obs_report.per_round(readbacks,
                                                        update_rounds),
            "syncs": readbacks,
            "seals": sum(1 for e, _ in self.events if e == "seal"),
            "merges": sum(1 for e, _ in self.events if e == "merge"),
            "spills": sum(1 for e, _ in self.events if e == "spill"),
            "buckets": list(self.scfg.buckets),
            "clients": 1 + len(self._clients),
            "deadline_clients": len(self._deadlines),
            "cold": self.backend.cold_stats(),
        }


class DistStreamEngine(StreamEngine):
    """Distributed stream engine: the same bucket/ordering/flag-word
    machinery on one rank's shard of a distributed state (module
    docstring).  Every rank constructs one with the same arguments and
    feeds it the same requests; every rank gets every answer.  ``mesh``
    None builds ``sharding.policy.stream_mesh(dcfg.n_model,
    device=device)`` over the initialised default process group (None:
    CUDA on NCCL; ``"cpu"``: gloo)."""

    def __init__(self, dcfg, mesh=None, scfg: StreamConfig | None = None,
                 seed: int = 0, obs: Obs | None = None,
                 cold_dir: str | None = None, proj: dict | None = None,
                 device=None):
        if mesh is None:
            from ..sharding.policy import stream_mesh
            mesh = stream_mesh(dcfg.n_model, device=device)
        scfg = scfg or StreamConfig()
        if scfg.min_batch % mesh.n_data:
            raise ValueError("query buckets must divide over the data "
                             f"replicas: min_batch={scfg.min_batch}, "
                             f"n_data={mesh.n_data}")
        super().__init__(DistBackend(dcfg, mesh, seed=seed,
                                     cold_dir=cold_dir, proj=proj),
                         scfg, obs=obs)


# ======================================================================
# closed-loop driver (benchmarks / examples)
# ======================================================================
def drive(engine: StreamEngine, requests: list[tuple], flush_every: int = 0):
    """Feed ``(kind, *args)`` request tuples through the engine.

    ``flush_every`` > 0 flushes after that many submissions (latency
    mode); 0 flushes once at the end (throughput mode).  Returns
    ({ticket: result}, elapsed seconds, per-flush latencies).
    """
    results: dict[int, Any] = {}
    lat: list[float] = []
    t0 = time.perf_counter()
    n = 0
    for req in requests:
        kind, args = req[0], req[1:]
        getattr(engine, kind)(*args)
        n += 1
        if flush_every and n % flush_every == 0:
            f0 = time.perf_counter()
            results.update(engine.flush())
            lat.append(time.perf_counter() - f0)
    if engine.pending():
        f0 = time.perf_counter()
        results.update(engine.flush())
        lat.append(time.perf_counter() - f0)
    return results, time.perf_counter() - t0, lat
