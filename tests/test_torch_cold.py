"""The port's cold tier held against the JAX package's.

Each device function of ``repro_torch.core.coldtier`` gets the same
inputs as its JAX counterpart (a cold state built by a JAX index and
carried across with ``convert.state_from_numpy``) and must give equal
integer outputs and equal payloads; the numpy host halves (Bloom build,
fold) must match bit for bit.  A differential trace drives the port's
``PFOIndex`` and the JAX one through spills, fetches, cold merges and
deletes of cold-only ids: ids, flag words, logs, ``stats()`` (the cold
counters included), ``sync_count`` and every integer leaf of the state
(``ColdState`` included) are equal, distances agree within 1e-5.

Inside the port, a spilling index must answer bit-identically to an
all-device index whose ring never fills.  Compaction is held against a
dict + linear-scan oracle and the invariant that a fold changes no
answer while every bucket span fits the probe budget, not against the
JAX output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_pfo_config
from repro.core import PFOIndex as JaxIndex
from repro.core import coldtier as jcold
from repro.core import index as jindex
from repro_torch import convert
from repro_torch.core import PFOConfig, PFOIndex, bloom, coldtier
from repro_torch.core import index as tindex
from repro_torch.core.lsh import main_table_keys
from test_torch_index import _safe_vectors

torch.set_num_threads(1)

DIST_TOL = 1e-5
# the JAX package's probes run eagerly; one compiled program each is
# quicker than op-by-op dispatch
_jprobe_lsh = jax.jit(jcold.cold_probe_lsh, static_argnums=2)
_jlookup_main = jax.jit(jcold.cold_lookup_main, static_argnums=3)


def cold_cfg(**kw):
    """Small arenas with the cold tier on: seals every few hundred
    inserts, a ring of 3, so spills come fast; a 64-entry tombstone
    buffer, so deletes drive cold merges."""
    base = dict(max_nodes_per_tree=48, max_leaves_per_tree=64,
                main_max_nodes_per_tree=128, main_max_leaves_per_tree=512,
                max_snapshots=3, cold_segments=24, cold_cache_slots=48,
                cold_fetch_rounds=8, max_tombstones=64, bloom_bits=0,
                bloom_hashes=0, snap_budget_per_probe=32)
    base.update(kw)
    return small_pfo_config(**base)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _assert_equal(got, want, what=""):
    """Port value vs JAX value: integers exactly (uint32 keys compare as
    values), floats within DIST_TOL, NamedTuples and dicts leaf by leaf."""
    if want is None:
        assert got is None, what
        return
    if hasattr(want, "_asdict"):
        for name, w in want._asdict().items():
            _assert_equal(getattr(got, name), w, f"{what}.{name}")
        return
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for name, w in want.items():
            _assert_equal(got[name], w, f"{what}.{name}")
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=0, atol=DIST_TOL, err_msg=what)
    else:
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      err_msg=what)


def _assert_states_equal(jidx, tidx):
    js = jax.device_get(jidx.state)
    ts = tidx.state
    for part in ("lsh_forest", "main_forest", "store", "lsh_snaps",
                 "main_snaps", "tombstones", "n_tombstones", "stamp",
                 "cold"):
        _assert_equal(getattr(ts, part), getattr(js, part), part)


def _assert_host_equal(jidx, tidx):
    assert tidx._flags == jidx._flags
    assert tidx.rounds_log == jidx.rounds_log
    assert tidx.maintenance_log == jidx.maintenance_log
    assert tidx.stats() == jidx.stats()
    assert tidx.sync_count == jidx.sync_count


def _assert_query_equal(jidx, tidx, q, k=10):
    jids, jd = jidx.query(q, k)
    tids, td = tidx.query(q, k)
    np.testing.assert_array_equal(tids, jids)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=0, atol=DIST_TOL)
    return tids


# ======================================================================
# the differential trace, port vs JAX
# ======================================================================
@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    cfg = cold_cfg(max_tombstones=128)
    root = tmp_path_factory.mktemp("cold")
    jidx = JaxIndex(cfg, seed=0, cold_dir=str(root / "jax"))
    proj = {k: np.asarray(v) for k, v in jidx.state.proj.items()}
    tcfg = PFOConfig(**cfg.__dict__)
    tidx = PFOIndex(tcfg, device="cpu", proj=convert.proj_from_numpy(proj),
                    cold_dir=str(root / "port"))
    wave = 400
    ids, vecs = _safe_vectors(proj, cfg, 5 * wave, ver=3)
    dead = set()
    mid = None                 # a JAX state with a ring and a cold tier
    for w in range(5):
        sl = slice(w * wave, (w + 1) * wave)
        jidx.insert(ids[sl], vecs[sl])
        tidx.insert(ids[sl], vecs[sl])
        _assert_host_equal(jidx, tidx)
        if mid is None and int(jidx.state.main_snaps.n_snaps) > 0 \
                and jidx.cold.n_cold > 0:
            mid = jax.device_get(jidx.state)
        if w >= 1:                         # churn: ids of the wave before
            gone = ids[(w - 1) * wave:(w - 1) * wave + wave // 4]
            jidx.delete(gone)
            tidx.delete(gone)
            dead.update(gone.tolist())
            _assert_host_equal(jidx, tidx)
        if w in (1, 4):
            _assert_states_equal(jidx, tidx)
    assert mid is not None
    # a cold merge drains the ring and flushes the cache; deletes of ids
    # that now live only in cold segments miss on their first round
    # (COLD_MISS), fetch, and retry
    jidx._merge_with_cold()
    tidx._merge_with_cold()
    _assert_host_equal(jidx, tidx)
    _assert_states_equal(jidx, tidx)
    cold_only = np.asarray(sorted(set(ids[:2 * wave].tolist()) - dead)
                           [:wave // 4], np.int32)
    fetches = tidx.cold.counters["fetches"]
    assert jidx.delete(cold_only) == tidx.delete(cold_only) >= 2
    assert tidx.cold.counters["fetches"] > fetches
    _assert_host_equal(jidx, tidx)
    _assert_states_equal(jidx, tidx)
    return jidx, tidx, cfg, tcfg, ids, vecs, cold_only, mid


def test_differential_trace(traced):
    jidx, tidx, _, _, ids, vecs, cold_only, _ = traced
    c = tidx.stats()["cold"]
    assert c["segments_spilled"] >= 2 and c["cold_merges"] >= 1
    assert c["backing"] == "files"
    assert "spill" in tidx.maintenance_log
    q = vecs[::40]
    _assert_query_equal(jidx, tidx, q)                    # fetches
    assert tidx.stats()["cold"]["fetch_rounds"] > c["fetch_rounds"]
    assert tidx.stats()["cold"]["staged_ranked"] > 0
    # self-queries of the deleted cold-only ids (same batch shape)
    got = _assert_query_equal(jidx, tidx, np.resize(
        vecs[np.isin(ids, cold_only)], q.shape))
    assert not np.isin(cold_only, got).any()
    _assert_host_equal(jidx, tidx)
    _assert_states_equal(jidx, tidx)
    tsnap, jsnap = tidx.obs.snapshot(), jidx.obs.snapshot()
    assert tsnap["gauges"] == jsnap["gauges"]
    assert "cold.vec_staging_hit_rate" in tsnap["gauges"]


def test_cold_state_round_trips_through_numpy(traced):
    _, tidx, *_ = traced
    a = convert.state_to_numpy(tidx.state)
    b = convert.state_to_numpy(convert.state_from_numpy(a, "cpu"))
    assert a["cold"]["lsh_route"]["blooms"].dtype == np.uint32
    assert a["cold"]["main_cache"]["keys"].dtype == np.uint32
    assert a["cold"]["main_cache"]["vecs"].dtype == np.float32
    assert a["cold"]["lsh_cache"]["vecs"] is None
    for part, leaves in a["cold"].items():
        if part == "n_cold":
            np.testing.assert_array_equal(b["cold"][part], leaves)
            continue
        for name, arr in leaves.items():
            if arr is not None:
                np.testing.assert_array_equal(b["cold"][part][name], arr)


# ======================================================================
# each device function against the JAX one, on the traced cold state
# ======================================================================
def _states(traced, empty_caches=False, mid=False):
    """(JAX state, port state, cfg, tcfg) at the end of the trace (or
    ``mid`` it, with a ring and a cold tier); with ``empty_caches`` both
    caches flushed, so every match is missing."""
    jidx, _, cfg, tcfg, *_ = traced
    js = traced[-1] if mid else jax.device_get(jidx.state)
    if empty_caches:
        js = js._replace(cold=js.cold._replace(
            lsh_cache=jcold._empty_cache(
                cfg, jindex._snap_cfg_lsh(cfg).snapshot_capacity),
            main_cache=jcold._empty_cache(
                cfg, jindex._snap_cfg_main(cfg).snapshot_capacity,
                dim=cfg.dim)))
        js = jax.device_get(js)
    return js, convert.state_from_numpy(js, "cpu"), cfg, tcfg


@pytest.mark.parametrize("empty_caches", [False, True])
def test_cold_probe_lsh_matches_jax(traced, empty_caches):
    js, ts, cfg, tcfg = _states(traced, empty_caches)
    vecs = traced[5]
    # keys through the port's hash (held against the JAX one elsewhere)
    h, _ = tindex.compute_keys(ts, torch.as_tensor(vecs[::23]), tcfg)
    want = _jprobe_lsh(js.cold, jnp.asarray(h.numpy().astype(
        np.uint32)), jindex._snap_cfg_lsh(cfg))
    got = coldtier.cold_probe_lsh(ts.cold, h, tindex._snap_cfg_lsh(tcfg))
    for g, w, name in zip(got, want, ("cand", "wanted", "missing", "probed",
                                      "fp")):
        _assert_equal(g, w, name)
    assert np.asarray(want[1]).any()
    assert np.asarray(want[2]).any() == empty_caches


@pytest.mark.parametrize("empty_caches", [False, True])
def test_cold_lookup_main_matches_jax(traced, empty_caches):
    js, ts, cfg, tcfg = _states(traced, empty_caches)
    ids = traced[4]
    vids = np.concatenate([ids[::3], [-1, 10**6, 5, 2**31 - 1]]).astype(
        np.int32)
    mh, _ = main_table_keys(torch.as_tensor(vids), tcfg)
    want = _jlookup_main(js.cold, jnp.asarray(mh.numpy().astype(
        np.uint32)), jnp.asarray(vids), jindex._snap_cfg_main(cfg))
    got = coldtier.cold_lookup_main(ts.cold, mh, torch.as_tensor(vids),
                                    tindex._snap_cfg_main(tcfg))
    names = ("slot", "found", "row_missing", "wanted", "missing", "probed",
             "fp")
    for g, w, name in zip(got, want, names):
        _assert_equal(g, w, name)
    found = np.asarray(want[1])
    assert found.any() != empty_caches
    assert np.asarray(want[2]).any() == empty_caches


def test_cold_lookup_main_ties_copies_budget_and_pad_key():
    """Synthetic main cache: an id in two resident segments of equal
    stamp (the lower slot wins), an id twice in one segment (its first
    copy wins), a newer copy in a third segment (the newest stamp wins),
    a bucket span longer than the probe budget (ids past it are not
    found, as in the reference), the one id whose murmur key is the pad
    key (behind pads in its segment), and a Bloom route into a segment
    that is not resident."""
    cfg = cold_cfg(cold_cache_slots=4, cold_segments=4)
    mcfg = jindex._snap_cfg_main(cfg)
    cap, budget = mcfg.snapshot_capacity, mcfg.snap_budget_per_probe
    shift = 32 - mcfg.snap_prefix_bits
    tcfg = PFOConfig(**cfg.__dict__)

    def mkeys(ids):            # the port's murmur keys, as uint32
        return main_table_keys(torch.as_tensor(ids), tcfg)[0].numpy() \
            .astype(np.uint32)

    cand = np.arange(200_000, dtype=np.int32)
    keys = mkeys(cand)
    crowd = cand[(keys >> shift) == 0x5A][:budget + 12]   # one long span
    crowd = crowd[np.argsort(keys[crowd])]               # in key order
    pad_id = np.int32(0x331DA083)                       # murmur key 2^32-1

    def segment(entries, pads_first=0):
        """Sorted (keys, ids, vals) from (id, val) pairs, padded to cap."""
        e_ids = np.asarray([i for i, _ in entries], np.int32)
        e_vals = np.asarray([v for _, v in entries], np.int32)
        e_keys = mkeys(e_ids)
        o = np.argsort(e_keys, kind="stable")
        k = np.full(cap, 0xFFFFFFFF, np.uint32)
        i = np.full(cap, -1, np.int32)
        v = np.zeros(cap, np.int32)
        n = len(o)
        reg = e_keys[o] != 0xFFFFFFFF
        k[:reg.sum()], i[:reg.sum()], v[:reg.sum()] = (
            e_keys[o][reg], e_ids[o][reg], e_vals[o][reg])
        at = reg.sum() + pads_first          # pad-keyed entries after pads
        k[at:at + n - reg.sum()] = e_keys[o][~reg]
        i[at:at + n - reg.sum()] = e_ids[o][~reg]
        v[at:at + n - reg.sum()] = e_vals[o][~reg]
        return k, i, v

    segs = [  # (cache slot, cold seg, stamp, entries)
        (0, 0, 5, [(42, 1), (42, 2), (7, 3), (pad_id, 4)]
         + [(int(x), 100 + j) for j, x in enumerate(crowd)]),
        (1, 1, 5, [(42, 9), (8, 10)]),
        (2, 2, 7, [(7, 11), (9, 12)]),
    ]
    jc = jcold.init_cold(cfg, jindex._snap_cfg_lsh(cfg), mcfg)
    cache, route = jc.main_cache, jc.main_route
    all_ids = []
    for slot, seg, stamp, entries in segs:
        k, i, v = segment(entries, pads_first=3 if seg == 0 else 0)
        cache = jcold.cache_install(cache, jnp.int32(slot), jnp.asarray(k),
                                    jnp.asarray(i), jnp.asarray(v),
                                    jnp.int32(stamp), jnp.int32(0),
                                    jnp.int32(seg))
        filt = jcold.np_bloom_build(jcold._np_prefix(k, mcfg.snap_prefix_bits),
                                    mcfg.bloom_hashes_eff,
                                    mcfg.bloom_bits_eff, mask=i >= 0)
        route = route._replace(blooms=route.blooms.at[seg].set(filt),
                               stamps=route.stamps.at[seg].set(stamp),
                               counts=route.counts.at[seg].set(len(entries)))
        all_ids += [e for e, _ in entries]
    # cold segment 3 routes id 99 but is not resident
    k3, _, _ = segment([(99, 1)])
    route = route._replace(blooms=route.blooms.at[3].set(
        jcold.np_bloom_build(jcold._np_prefix(k3, mcfg.snap_prefix_bits),
                             mcfg.bloom_hashes_eff, mcfg.bloom_bits_eff,
                             mask=k3 != 0xFFFFFFFF)), stamps=route.stamps.at[3].set(8))
    jc = jax.device_get(jc._replace(main_cache=cache, main_route=route,
                                    n_cold=jnp.int32(4)))
    tc = convert.state_from_numpy(
        {**convert.state_to_numpy(tindex.init_state(
            tcfg, convert.proj_from_numpy(
                {"table_proj": np.zeros((cfg.dim, cfg.L * 32)),
                 "part_proj": np.zeros((cfg.L, 32, cfg.C))}))),
         "cold": jc}, "cpu").cold
    vids = np.asarray(sorted(set(all_ids)) + [99, 12345, -1], np.int32)
    mh = mkeys(vids)
    want = _jlookup_main(jc, jnp.asarray(mh), jnp.asarray(vids), mcfg)
    got = coldtier.cold_lookup_main(
        tc, torch.as_tensor(mh.astype(np.int64)), torch.as_tensor(vids),
        tindex._snap_cfg_main(tcfg))
    for g, w in zip(got, want):
        _assert_equal(g, w)
    slot, found = np.asarray(want[0]), np.asarray(want[1])
    at = {int(x): j for j, x in enumerate(vids)}
    base = cfg.store_capacity
    assert found[at[42]] and slot[at[42]] - base < cap       # slot 0 wins
    assert found[at[7]] and (slot[at[7]] - base) // cap == 2  # newest stamp
    assert found[at[int(pad_id)]]
    assert not found[at[int(crowd[-1])]]        # past the probe budget
    assert found[at[int(crowd[0])]]
    assert np.asarray(want[2])[at[99]] and np.asarray(want[4])[3]


def test_spill_device_matches_jax(traced):
    js, _, cfg, tcfg = _states(traced, mid=True)
    jargs = (jindex._snap_cfg_lsh(cfg), jindex._snap_cfg_main(cfg),
             jindex.main_tree_config(cfg))

    def jspill(js):
        return jcold.spill_device(js.lsh_snaps, js.main_snaps, js.cold,
                                  js.store, js.main_forest, js.tombstones,
                                  *jargs)

    while int(js.main_snaps.counts[0]) == 0:     # pop empty seals first
        lsh2, main2, cold2, store2, _, _ = jspill(js)
        js = jax.device_get(js._replace(lsh_snaps=lsh2, main_snaps=main2,
                                        cold=cold2, store=store2))
    assert int(js.cold.n_cold) < cfg.cold_segments
    ts = convert.state_from_numpy(js, "cpu")
    want = jspill(js)
    got = coldtier.spill_device(
        ts.lsh_snaps, ts.main_snaps, ts.cold, ts.store, ts.main_forest,
        ts.tombstones, tindex._snap_cfg_lsh(tcfg),
        tindex._snap_cfg_main(tcfg), tindex.main_tree_config(tcfg))
    want = jax.device_get(want)
    from repro_torch.core import snapshots as snap_mod
    got = (got[0], snap_mod.one(got[1]), *got[2:])
    want = (want[0], jax.tree.map(lambda a: np.asarray(a)[None], want[1]),
            *want[2:])
    for g, w, name in zip(got, want, ("lsh", "main", "cold", "store",
                                      "popped_lsh", "popped_main")):
        _assert_equal(g, w, name)
    assert np.asarray(want[5]["cur"]).any()


def test_cache_install_matches_jax(traced):
    tidx = traced[1]
    js, ts, cfg, tcfg = _states(traced)
    gid = tidx.cold.main_gids[0]
    k, i, v = (np.array(a) for a in tidx.cold.store.get(gid))
    p = np.array(tidx.cold.store.get_payload(gid))
    want = jcold.cache_install(js.cold.main_cache, jnp.int32(3),
                               jnp.asarray(k), jnp.asarray(i),
                               jnp.asarray(v), jnp.int32(11), jnp.int32(0),
                               jnp.int32(2), vecs=jnp.asarray(p))
    got = coldtier.cache_install(
        ts.cold.main_cache, 3, torch.as_tensor(k.astype(np.int64)),
        torch.as_tensor(i), torch.as_tensor(v), 11, 0, 2,
        vecs=torch.as_tensor(p))
    _assert_equal(got, jax.device_get(want))


def test_ring_payload_drain_matches_jax():
    """A ring where one id has several copies — updated across seals, and
    twice within one segment: only the newest copy per id drains (the
    first in storage order among equal stamps), and only while its slot
    is live and it has no hot copy or tombstone."""
    cfg = cold_cfg()
    mcfg = jindex._snap_cfg_main(cfg)
    S, cap = cfg.max_snapshots, mcfg.snapshot_capacity
    rng = np.random.default_rng(5)
    ids = np.full((S, cap), -1, np.int32)
    vals = np.zeros((S, cap), np.int32)
    segs = [np.arange(100), np.r_[np.arange(50), 200, 200],
            np.arange(20)]                      # stamps 1, 2, 3
    slot = 0
    for s_, seg in enumerate(segs):
        ids[s_, :len(seg)] = seg
        vals[s_, :len(seg)] = np.arange(slot, slot + len(seg))
        slot += len(seg)
    js = jindex.init_state(cfg, jax.random.PRNGKey(0))
    live = np.ones(cfg.store_capacity, bool)
    live[[3, 160]] = False                     # slots freed elsewhere
    js = jax.device_get(js._replace(
        main_snaps=js.main_snaps._replace(
            ids=jnp.asarray(ids), vals=jnp.asarray(vals),
            stamps=jnp.asarray([1, 2, 3], jnp.int32),
            n_snaps=jnp.int32(3)),
        store=js.store._replace(                # every slot allocated
            data=jnp.asarray(rng.normal(size=(cfg.store_capacity, cfg.dim))
                             .astype(np.float32)),
            free_top=jnp.int32(2), live=jnp.asarray(live)),
        tombstones=js.tombstones.at[:2].set(jnp.asarray([30, 60])),
        n_tombstones=jnp.int32(2)))
    ts = convert.state_from_numpy(js, "cpu")
    want = jax.device_get(jcold.ring_payload_drain(
        js.main_snaps, js.store, js.main_forest, js.tombstones, mcfg,
        jindex.main_tree_config(cfg)))
    tcfg = PFOConfig(**cfg.__dict__)
    got = coldtier.ring_payload_drain(
        ts.main_snaps, ts.store, ts.main_forest, ts.tombstones,
        tindex._snap_cfg_main(tcfg), tindex.main_tree_config(tcfg))
    for g, w, name in zip(got, want, ("payload", "cur", "store")):
        _assert_equal(g, w, name)
    cur = np.asarray(want[1])
    assert not cur[:2, :20].any() and not cur[0, :50].any()   # stale copies
    assert cur[2, :20].sum() == 19 and not cur[2, 8]       # slot 160 freed
    assert cur[1, 20:50].sum() == 29 and not cur[1, 30]    # 30 tombstoned
    assert not cur[0, 60] and cur[0, 61]
    assert cur[1, 50] and not cur[1, 51]                   # tie: the first


# ======================================================================
# host halves: Bloom build and fold
# ======================================================================
def test_np_bloom_build_matches_port_bloom():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2**32, 500).astype(np.uint32)
    mask = rng.random(500) < 0.8
    for bits, hashes in ((1 << 10, 3), (1 << 12, 4), (4096 + 32, 5)):
        want = bloom.build(torch.as_tensor(keys.astype(np.int64))[None],
                           hashes, bits, mask=torch.as_tensor(mask)[None])[0]
        host = coldtier.np_bloom_build(keys, hashes, bits, mask=mask)
        np.testing.assert_array_equal(host.astype(np.int64), want.numpy())
        np.testing.assert_array_equal(
            host, jcold.np_bloom_build(keys, hashes, bits, mask=mask))


def test_fold_entries_matches_jax():
    rng = np.random.default_rng(1)
    n = 900
    ids = rng.integers(-1, 300, n).astype(np.int32)   # duplicates, pads
    keys = rng.integers(0, 2**32, n).astype(np.uint32)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    stamps = rng.integers(1, 6, n).astype(np.int32)
    pay = rng.normal(size=(n, 8)).astype(np.float32)
    dead = np.asarray([3, 4, 5, 250], np.int32)
    args = (keys, ids, vals, stamps, dead, 128, 8, 3, 1024)
    want = jcold._fold_entries(*args, payloads=pay)
    got = coldtier._fold_entries(*args, payloads=pay)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


# ======================================================================
# inside the port: cold vs all-device, compaction
# ======================================================================
def _clustered(n, dim, seed, n_centers=100, noise=0.10):
    rng = np.random.default_rng(seed)
    centers = np.random.default_rng(99).normal(
        size=(n_centers, dim)).astype(np.float32)
    v = centers[rng.integers(0, n_centers, n)] \
        + rng.normal(size=(n, dim)).astype(np.float32) * noise
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_cold_vs_all_device_bit_identical():
    """A spilling index answers bit-identically to an all-device index
    whose ring never fills: the cold tier is a pure capacity extension,
    and a row ranked out of the staging arena ranks as it would in the
    store."""
    base = dict(max_nodes_per_tree=48, max_leaves_per_tree=64,
                main_max_nodes_per_tree=128, main_max_leaves_per_tree=512,
                bloom_bits=0, bloom_hashes=0)
    cold = PFOIndex(PFOConfig(**small_pfo_config(
        **base, max_snapshots=3, cold_segments=24, cold_cache_slots=96,
        cold_fetch_rounds=8).__dict__), seed=0, device="cpu")
    ref = PFOIndex(PFOConfig(**small_pfo_config(
        **base, max_snapshots=24).__dict__), seed=0, device="cpu")
    wave = 400
    vecs = _clustered(5 * wave, cold.cfg.dim, seed=7)
    for w in range(5):
        ids = np.arange(w * wave, (w + 1) * wave, dtype=np.int32)
        for idx in (cold, ref):
            idx.insert(ids, vecs[w * wave:(w + 1) * wave])
            if w >= 1:
                idx.delete(np.arange((w - 1) * wave, (w - 1) * wave
                                     + wave // 4, dtype=np.int32))
    assert cold.stats()["cold"]["segments_spilled"] >= 2
    assert "merge" not in ref.maintenance_log
    rng = np.random.default_rng(11)
    for q in (1, 16, 64):
        qv = vecs[rng.integers(0, len(vecs), q)] + rng.normal(
            size=(q, cold.cfg.dim)).astype(np.float32) * 0.03
        ci, cd = cold.query(qv, k=10)
        ri, rd = ref.query(qv, k=10)
        np.testing.assert_array_equal(ci, ri)
        np.testing.assert_array_equal(cd, rd)
    assert cold.stats()["cold"]["staged_ranked"] > 0


def _max_span(store, gids, prefix_bits):
    """The longest bucket span (entries sharing a key prefix) over the
    segments ``gids`` of a SegmentStore."""
    most = 0
    for gid in gids:
        k, i, _ = store.get(gid)
        k = np.asarray(k)[np.asarray(i) >= 0]
        if k.size:
            most = max(most, int(np.unique(k >> np.uint32(32 - prefix_bits),
                                           return_counts=True)[1].max()))
    return most


def test_compaction_against_oracle(tmp_path):
    """Background compaction folds the cold segments, and after it the
    index still answers like a dict + linear scan over the live items:
    every returned id is live at its exact distance, every self-query
    finds itself first, no deleted id comes back.  While every bucket
    span fits the probe budget, the fold changes no answer at all."""
    cfg = PFOConfig(**cold_cfg(cold_segments=8, max_tombstones=1024,
                               max_candidates_total=512,
                               snap_budget_per_probe=64).__dict__)
    idx = PFOIndex(cfg, seed=0, device="cpu", cold_dir=str(tmp_path))
    rng = np.random.default_rng(3)
    live = {}
    for w in range(5):
        v = rng.normal(size=(300, cfg.dim)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        ids = np.arange(w * 300, (w + 1) * 300, dtype=np.int32)
        idx.insert(ids, v)
        live.update(zip(ids.tolist(), v))
        if w >= 1:
            dead = np.arange((w - 1) * 300, (w - 1) * 300 + 60,
                             dtype=np.int32)
            idx.delete(dead)
            for i in dead:
                live.pop(int(i))
    n0 = idx.cold.n_cold
    assert n0 >= 2 and idx.cold.counters["compactions"] == 0
    lid = np.asarray(sorted(live), np.int32)
    q = np.stack([live[int(i)] for i in lid[::29]])

    def spans():
        lc, mc = idx.cold.lsh_cfg, idx.cold.main_cfg
        return max(max(_max_span(idx.cold.store, g, lc.snap_prefix_bits)
                       for g in idx.cold.lsh_gids),
                   _max_span(idx.cold.store, idx.cold.main_gids,
                             mc.snap_prefix_bits))

    def check_oracle(ids, dists):
        assert np.isin(ids[ids >= 0], lid).all()     # nothing deleted
        np.testing.assert_array_equal(ids[:, 0], lid[::29])
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        exact = np.asarray([[1.0 - float(np.dot(qn[r], live[int(i)]))
                             if i >= 0 else np.inf for i in row]
                            for r, row in enumerate(ids)], np.float32)
        np.testing.assert_allclose(dists, exact, rtol=0, atol=DIST_TOL)

    assert spans() <= cfg.snap_budget_per_probe
    i0, d0 = idx.query(q, k=5)
    check_oracle(i0, d0)

    assert idx.cold.compact_start_async()
    idx.cold._worker.join()                        # deterministic here
    idx.state = idx.cold.compact_maybe_install(idx.state)
    assert idx.cold.counters["compactions"] == 1
    assert idx.cold.n_cold <= n0
    assert spans() <= cfg.snap_budget_per_probe
    i1, d1 = idx.query(q, k=5)
    check_oracle(i1, d1)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)


def test_stale_background_fold_discarded():
    """A fold computed against an older cold layout is dropped by the
    generation check, and the index keeps answering from its layout."""
    cfg = PFOConfig(**cold_cfg().__dict__)
    idx = PFOIndex(cfg, seed=0, device="cpu")
    vecs = _clustered(900, cfg.dim, seed=24)
    for s in range(0, 900, 300):
        idx.insert(np.arange(s, s + 300, dtype=np.int32), vecs[s:s + 300])
    assert idx.cold.n_cold >= 1
    idx.cold.compact_start_async()
    idx.cold._worker.join()
    idx.cold._gen += 1                 # the layout moved mid-fold
    idx.state = idx.cold.compact_maybe_install(idx.state)
    assert idx.cold.counters["compactions"] == 0
    ids, _ = idx.query(vecs[:8], k=5)
    assert (ids[:, 0] == np.arange(8)).all()
