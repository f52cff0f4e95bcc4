"""The port's PFOIndex held against the JAX PFOIndex on one trace.

Both indexes get the same config, the same projections (copied out of
the JAX index with ``convert.proj_from_numpy``) and the same seeded
vectors.  The trace covers inserts, deletes, re-inserts, updates, two
or more seals and a merge.  Ids, flag words, the round and maintenance
logs, stats, sync counts and every integer leaf of the state must be
equal; distances agree within 1e-5.

Vectors are kept only when every table projection and every partition
projection, computed in float64, lies at least 1e-4 from zero: the two
systems sum floats in different orders, and a projection at zero could
hash differently on each side for reasons that say nothing about the
port.
"""
import jax
import numpy as np
import pytest
import torch

from conftest import small_pfo_config, unit_vec
from repro.core import PFOIndex as JaxIndex
from repro_torch import convert
from repro_torch.core import PFOConfig, PFOIndex

torch.set_num_threads(1)

DIST_TOL = 1e-5
MARGIN = 1e-4


def _cfg(**kw):
    # 128-leaf trees seal every ~1000 inserts, a 3-segment ring merges
    # on the third seal, a 64-entry tombstone buffer after ~48 deletes
    return small_pfo_config(max_leaves_per_tree=128, max_snapshots=3,
                            max_tombstones=64, **kw)


def _safe_vectors(proj, cfg, n, ver, start=0):
    """The first ``n`` unit_vec(i, ver) with i >= start whose table and
    partition projections are all >= MARGIN from zero (float64)."""
    table = np.asarray(proj["table_proj"], np.float64)
    part = np.asarray(proj["part_proj"], np.float64)
    out, ids, i = [], [], start
    while len(out) < n:
        x = unit_vec(i, ver, cfg.dim)
        p = x.astype(np.float64) @ table                        # (L*32,)
        bits = np.where(p >= 0, 1.0, -1.0).reshape(cfg.L, 32)
        pp = np.einsum("lm,lmc->lc", bits, part)
        if np.abs(p).min() >= MARGIN and np.abs(pp).min() >= MARGIN:
            out.append(x)
            ids.append(i)
        i += 1
    return np.asarray(ids, np.int32), np.stack(out)


def _leaves(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _assert_states_equal(jidx, tidx):
    js = jax.device_get(jidx.state)
    ts = convert.state_to_numpy(tidx.state)
    for part in ("lsh_forest", "main_forest", "store", "lsh_snaps",
                 "main_snaps"):
        for name, a in _leaves(getattr(js, part)).items():
            b = ts[part][name]
            assert a.shape == b.shape, (part, name)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=0, atol=DIST_TOL,
                                           err_msg=f"{part}.{name}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{part}.{name}")
    for name in ("tombstones", "n_tombstones", "stamp"):
        np.testing.assert_array_equal(ts[name], np.asarray(getattr(js, name)))


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


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    jidx = JaxIndex(cfg, seed=0)
    proj = {k: np.asarray(v) for k, v in jidx.state.proj.items()}
    tidx = PFOIndex(PFOConfig(**cfg.__dict__), device="cpu",
                    proj=convert.proj_from_numpy(proj))
    return jidx, tidx, proj, cfg


def test_differential_trace(pair):
    jidx, tidx, proj, cfg = pair
    ids, vecs = _safe_vectors(proj, cfg, 2400, ver=0)
    batch = 300
    for s in range(0, len(ids), batch):
        jidx.insert(ids[s:s + batch], vecs[s:s + batch])
        tidx.insert(ids[s:s + batch], vecs[s:s + batch])
        _assert_host_equal(jidx, tidx)
        _assert_states_equal(jidx, tidx)
    assert jidx.maintenance_log.count("seal") >= 2
    _assert_query_equal(jidx, tidx, vecs[:32])

    # deletes spanning the hot forests and the sealed ring, enough to
    # fill the tombstone buffer and force a merge
    dead = ids[::40]
    for s in range(0, len(dead), 30):
        jidx.delete(dead[s:s + 30])
        tidx.delete(dead[s:s + 30])
        _assert_host_equal(jidx, tidx)
        _assert_states_equal(jidx, tidx)
    assert "merge" in jidx.maintenance_log
    got = _assert_query_equal(jidx, tidx, vecs[::40][:32])
    assert not np.isin(dead, got).any()

    # re-insert half of the deleted ids, update other ids to new vectors
    back = slice(0, len(dead), 2)
    jidx.insert(dead[back], vecs[::40][back])
    tidx.insert(dead[back], vecs[::40][back])
    _assert_host_equal(jidx, tidx)
    upd_ids = ids[1:60:2]                   # live ids (none is in `dead`)
    _, upd_vecs = _safe_vectors(proj, cfg, len(upd_ids), ver=1)
    jidx.update(upd_ids, upd_vecs)
    tidx.update(upd_ids, upd_vecs)
    _assert_host_equal(jidx, tidx)
    _assert_states_equal(jidx, tidx)
    got = _assert_query_equal(jidx, tidx, upd_vecs, k=5)
    assert (got[:, 0] == upd_ids).all()
    assert tidx.stats()["overflow_events"] == 0

    # the port's obs copy records the same metrics the reference does
    tsnap, jsnap = tidx.obs.snapshot(), jidx.obs.snapshot()
    assert tsnap["gauges"] == jsnap["gauges"]
    assert {k: v["count"] for k, v in tsnap["histograms"].items()} == \
        {k: v["count"] for k, v in jsnap["histograms"].items()}
    assert "index.maint_ms{epoch=seal}" in tidx.obs.format()


def test_ranking_budget_cut_matches_jax():
    """A ranking budget (max_candidates_total) below the candidate union:
    the dedupe keeps the smallest ids, so a self-query misses rank 0
    exactly when its id is larger than every id kept in a full row.  The
    port keeps the same candidates and answers the same ids."""
    from repro.core import index as jax_index_mod
    from repro_torch.core import index as index_mod
    cfg = _cfg(max_candidates_total=8)
    jidx = JaxIndex(cfg, seed=1)
    proj = {k: np.asarray(v) for k, v in jidx.state.proj.items()}
    tcfg = PFOConfig(**cfg.__dict__)
    tidx = PFOIndex(tcfg, device="cpu", proj=convert.proj_from_numpy(proj))
    ids, vecs = _safe_vectors(proj, cfg, 600, ver=2)
    for s in range(0, len(ids), 300):
        jidx.insert(ids[s:s + 300], vecs[s:s + 300])
        tidx.insert(ids[s:s + 300], vecs[s:s + 300])
    self_ids, q = ids[::10], vecs[::10]
    got = _assert_query_equal(jidx, tidx, q, k=5)

    _, jcand = jax_index_mod._hot_sealed_candidates(jidx.state, q, cfg)
    jcids = np.asarray(jax_index_mod._dedupe_candidates(
        jcand, jidx.state.tombstones, cfg))
    _, tcand = index_mod._hot_sealed_candidates(
        tidx.state, torch.as_tensor(q), tcfg)
    tcids = index_mod._dedupe_candidates(tcand, tidx.state.tombstones, tcfg)
    np.testing.assert_array_equal(tcids.numpy(), jcids)

    miss = got[:, 0] != self_ids
    assert miss.any() and not miss.all()        # the budget did cut
    assert (jcids[miss] >= 0).all()
    assert (self_ids[miss] > jcids[miss].max(1)).all()
    assert (jcids[~miss] == self_ids[~miss, None]).any(1).all()


def test_cold_tier_config_raises():
    """A cold-tier config no longer raises: it builds on the CPU, spills,
    and answers a query (the cold tier is held against the JAX package
    in ``test_torch_cold.py``)."""
    cfg = PFOConfig(**small_pfo_config(
        max_leaves_per_tree=64, max_snapshots=3, cold_segments=4,
        cold_cache_slots=12).__dict__)
    idx = PFOIndex(cfg, device="cpu")
    rng = np.random.default_rng(8)
    vecs = rng.normal(size=(1500, cfg.dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    for s in range(0, 1500, 300):
        idx.insert(np.arange(s, s + 300, dtype=np.int32), vecs[s:s + 300])
    assert idx.stats()["cold"]["segments_spilled"] >= 1
    ids, dists = idx.query(vecs[:8], 3)
    assert (ids[:, 0] == np.arange(8)).all()
    assert np.abs(dists[:, 0]).max() <= DIST_TOL


def test_rank_tap_sees_the_answering_ranking(monkeypatch):
    """A query answers with the ranking of the candidates
    ``index._rank_candidates`` is handed (the function a measurement
    taps for the kernel's inputs): ranking the last of them through the
    plain version gives the query's answer, staged rows included."""
    from repro_torch.core import index as tindex
    from repro_torch.kernels import ref
    cfg = PFOConfig(**small_pfo_config(
        max_leaves_per_tree=64, max_snapshots=3, cold_segments=4,
        cold_cache_slots=12).__dict__)
    idx = PFOIndex(cfg, device="cpu")
    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(1500, cfg.dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    for s in range(0, 1500, 300):
        idx.insert(np.arange(s, s + 300, dtype=np.int32), vecs[s:s + 300])
    seen, real = [], tindex._rank_candidates

    def tap(state, qvecs, cids, slot, found, cfg, k, staging=None):
        seen.append(dict(store=state.store.data.clone(), qvecs=qvecs,
                         cids=cids, slot=slot, found=found, staging=staging))
        return real(state, qvecs, cids, slot, found, cfg, k, staging=staging)

    monkeypatch.setattr(tindex, "_rank_candidates", tap)
    ids, dists = idx.query(vecs[:16], 5)
    assert seen
    r = seen[-1]
    assert r["staging"] is not None
    valid = (r["cids"] >= 0) & r["found"] & (r["slot"] >= 0)
    slots = torch.where(valid, r["slot"], 0)
    assert (valid & (slots >= cfg.store_capacity)).any()
    d = ref.ref_gather_rank(r["qvecs"], r["store"], slots, valid,
                            cfg.metric, staging=r["staging"])
    neg, at = torch.topk(-d, 5, dim=1)
    want = torch.where(torch.isfinite(neg), r["cids"].gather(1, at), -1)
    np.testing.assert_array_equal(ids, want.numpy())
    np.testing.assert_array_equal(dists, (-neg).numpy())


def test_loop_traversal_raises():
    with pytest.raises(NotImplementedError, match="masked"):
        PFOIndex(PFOConfig(**_cfg(traversal="loop").__dict__), device="cpu")


def test_default_device_is_cuda():
    cfg = PFOConfig(**_cfg().__dict__)
    if torch.cuda.is_available():
        assert PFOIndex(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            PFOIndex(cfg)


def test_seeded_projections_are_reproducible():
    cfg = PFOConfig(**_cfg().__dict__)
    a = PFOIndex(cfg, seed=3, device="cpu").state.proj
    b = PFOIndex(cfg, seed=3, device="cpu").state.proj
    c = PFOIndex(cfg, seed=4, device="cpu").state.proj
    assert torch.equal(a["table_proj"], b["table_proj"])
    assert not torch.equal(a["table_proj"], c["table_proj"])
    assert a["table_proj"].shape == (cfg.dim, cfg.L * cfg.M)
    assert a["part_proj"].shape == (cfg.L, cfg.M, cfg.C)


def test_state_round_trips_through_numpy(pair):
    jidx, tidx, _, _ = pair
    back = convert.state_from_numpy(convert.state_to_numpy(tidx.state), "cpu")
    a, b = convert.state_to_numpy(tidx.state), convert.state_to_numpy(back)
    for part in ("lsh_forest", "main_forest", "store", "lsh_snaps",
                 "main_snaps"):
        for name in a[part]:
            np.testing.assert_array_equal(a[part][name], b[part][name])
    # a JAX state converts too, and then equals the port's
    from_jax = convert.state_to_numpy(convert.state_from_numpy(
        jax.device_get(jidx.state), "cpu"))
    for name, arr in from_jax["main_forest"].items():
        np.testing.assert_array_equal(arr, a["main_forest"][name])
