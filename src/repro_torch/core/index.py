"""PFOIndex — the public API of the port, without the cold tier.

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

This mirrors the JAX package's ``core/index.py`` step for step; the
steps update the state's tensors in place and return the state.  The
cold tier (``cold_segments > 0``) belongs to a later slice of the port.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..obs import Obs
from . import snapshots as snap_mod
from .config import PFOConfig
from .dispatch import (FLAG_ANY_PENDING, FLAG_NEED_SEAL, FLAG_SNAPS_FULL,
                       FLAG_STORE_FULL, FLAG_TOMBS_FULL, dispatch_to_trees,
                       gather_mailbox, mailbox_ids, pack_round_flags)
from .hash_tree import (TreeConfig, TreeState, forest_delete_dispatched,
                        forest_headroom, forest_insert_dispatched,
                        forest_lookup_masked, forest_query_masked,
                        init_forest, reset_forest_)
from .lsh import main_table_keys, make_projections, region_ids
from .membership import member_sorted
from .scatter import masked_put_
from .store import DenseStore, dense_alloc, dense_free, dense_init, dense_read

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
    cold: None = None                  # the cold tier is not ported yet


def _snap_cfg_lsh(cfg: PFOConfig) -> PFOConfig:
    cap = cfg.n_trees * cfg.max_leaves_per_tree
    return PFOConfig(**{**cfg.__dict__, "snapshot_capacity": cap})


def _snap_cfg_main(cfg: PFOConfig) -> PFOConfig:
    cap = cfg.main_n_trees * cfg.main_max_leaves_per_tree
    # MainTable probes are exact (key, id) lookups: always single-probe
    return PFOConfig(**{**cfg.__dict__, "snapshot_capacity": cap,
                        "snap_probes": 1})


def check_supported(cfg: PFOConfig) -> None:
    if cfg.cold_enabled:
        raise NotImplementedError(
            "cold_segments > 0 needs the cold tier, which belongs to the "
            "port's cold-tier slice (core/coldtier.py + the staged "
            "gather_rank kernel); this slice runs hot + sealed ring only")


def init_state(cfg: PFOConfig, proj: dict) -> PFOState:
    """Fresh state on the device of ``proj`` (the SRP parameters)."""
    check_supported(cfg)
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


def _round_flags(state: PFOState, cfg: PFOConfig, main_capacity: int,
                 lsh_capacity: int, any_pending: torch.Tensor) -> torch.Tensor:
    """Device-side maintenance decision for the *next* round, packed:
    worst-tree cursors against the arena sizes decide seal, ring and
    tombstone occupancy decide merge."""
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
    store, new_slots, alloc_ok = dense_alloc(state.store, vecs, need_alloc)
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
    forest_insert_dispatched(state.main_forest, mh_g, mailbox_ids(mbox, ids),
                             mval_g, main_tree_config(cfg))

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
    sval, sfound = snap_mod.lookup_exact(snap_mod.one(state.main_snaps), mh,
                                         ids, _snap_cfg_main(cfg))
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
                     k: int):
    """Exact re-rank: the gather_rank kernel reads candidate vectors
    straight out of the store by slot id, then a top-k."""
    valid = (cids >= 0) & found & (slot >= 0)
    idx, top_d = kops.gather_rank_topk(qvecs, state.store.data,
                                       torch.where(valid, slot, 0), valid,
                                       k, cfg.metric)
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
                  lsh_capacity: int):
    """The delete pipeline after the lookup: unlink hot entries, free
    store slots, append tombstones.  Returns (state, pending), pending
    covering mailbox and tombstone-buffer overflow rows.  (The cold
    tier's staging arena joins this signature with the cold-tier slice.)"""
    L = cfg.L
    # re-derive LSH keys from the stored vector
    vecs = dense_read(state.store, torch.where(ok, slot, 0))
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

    store = dense_free(state.store, slot, ok)

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
# host orchestrator
# ======================================================================
def _default_device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA; no CUDA device is "
                           "available (pass device='cpu' to run the plain "
                           "versions of the kernels on the CPU)")
    return torch.device("cuda")


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
    :func:`repro_torch.convert.proj_from_numpy`.
    """

    MAX_ROUNDS = 64

    def __init__(self, cfg: PFOConfig, seed: int = 0, device=None,
                 proj: dict | None = None, obs: Obs | None = None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = _default_device(device)
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
        self.set_obs(obs if obs is not None else Obs())

    # -- observability --------------------------------------------------
    def set_obs(self, obs: Obs) -> None:
        """Bind an observability handle; the index's counters mirror into
        gauges lazily at snapshot time."""
        self.obs = obs
        obs.on_snapshot("index", self._mirror_obs)

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

    # -- capacity heuristics -------------------------------------------
    def _lsh_capacity(self, n: int) -> int:
        total = self.cfg.L * self.cfg.n_trees
        per = (n * self.cfg.L + total - 1) // total
        return int(max(8, 2 * per))

    def _main_capacity(self, n: int) -> int:
        per = (n + self.cfg.main_n_trees - 1) // self.cfg.main_n_trees
        return int(max(8, 2 * per))

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

    def _maintain(self, flags: int) -> None:
        """Run the seal/merge epochs the flag word asks for."""
        if flags & FLAG_NEED_SEAL:
            if flags & FLAG_SNAPS_FULL:
                self.state = self._epoch("merge", merge_step, self.state,
                                         self.cfg)
                self.maintenance_log.append("merge")
            self.state = self._epoch("seal", seal_step, self.state, self.cfg)
            self.maintenance_log.append("seal")
        if flags & FLAG_TOMBS_FULL:
            self.state = self._epoch("merge", merge_step, self.state, self.cfg)
            self.maintenance_log.append("merge")
        if flags & (FLAG_NEED_SEAL | FLAG_TOMBS_FULL | FLAG_STORE_FULL):
            self._flags = None       # state changed; carried word is stale

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
        lcap, mcap = self._lsh_capacity(n), self._main_capacity(n)
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
            ids, dists = query_step(self.state, qvecs, self.cfg, k)
            # one device->host pickup: int32 ids and float32 distances
            # both survive a round trip through float64 exactly
            both = torch.cat([ids.to(torch.float64), dists.to(torch.float64)],
                             1).cpu().numpy()
        self.obs.histogram("index.op_ms", op="query").observe(
            (time.perf_counter() - t0) * 1e3)
        return both[:, :k].astype(np.int32), both[:, k:].astype(np.float32)

    def delete(self, ids) -> int:
        ids = self._ids(ids)
        active = torch.ones(ids.shape, dtype=torch.bool, device=self.device)
        n = int(ids.shape[0])
        lcap, mcap = self._lsh_capacity(n), self._main_capacity(n)
        t0 = time.perf_counter()
        with self.obs.span("delete", n=n):
            flags = self._ensure_flags(mcap, lcap)
            rounds = 0
            for _ in range(self.MAX_ROUNDS):
                self._maintain(flags)
                self.state, pending, fw = delete_step(
                    self.state, ids, active, self.cfg, mcap, lcap)
                rounds += 1
                flags = self._read_flags(fw, (mcap, lcap))
                if not flags & FLAG_ANY_PENDING:
                    break
                active = pending
        self.obs.histogram("index.op_ms", op="delete").observe(
            (time.perf_counter() - t0) * 1e3)
        return rounds

    def update(self, ids, vecs) -> None:
        """Online update (paper §5): new version written, old reclaimed."""
        self.delete(ids)
        self.insert(ids, vecs)

    def stats(self) -> dict:
        st = self.state
        return {
            "items_hot": int(st.main_forest.n_items.sum()),
            "lsh_leaves": int(st.lsh_forest.n_items.sum()),
            "snapshots": int(st.main_snaps.n_snaps),
            "tombstones": int(st.n_tombstones),
            "store_free": int(st.store.free_top),
            "overflow_events": int(st.lsh_forest.overflow.sum()),
            "stamp": int(st.stamp),
        }
