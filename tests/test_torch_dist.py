"""The port's distributed path (``repro_torch.core.distributed``,
``DistBackend`` / ``DistStreamEngine``, ``sharding.stream_mesh`` and the
distributed checkpoints) on the CPU, over gloo.

* In process, a one-rank group (the JAX package's own fast lane runs the
  same degenerate mesh): ``make_dist_insert`` / ``make_dist_query`` hold
  the reference's three properties; the port's ``DistStreamEngine``
  answers the JAX ``DistStreamEngine``'s fast-lane traces, hot and cold,
  ticket for ticket, and so does the port's own ``StreamEngine``; ids
  above 2^24 survive the routing payloads, held against a dict +
  linear-scan oracle; round variants stay bounded by the buckets; a
  steady round reads back once; a distributed checkpoint written by the
  JAX package loads into the port, and the reverse.  The traces delete
  only live ids and find room for their forced seal, off the cases where
  the port repairs the JAX package (``ROADMAP.md`` Queue 3).
* The mixed-table cold tier and the grouped merge against the JAX
  functions.
* Four ranks in subprocesses (``tests/_torch_dist_child.py``, a
  ``FileStore`` under ``tmp_path``): ``(data=1, model=4)`` and
  ``(data=2, model=2)``, hot and cold, with duplicate-id re-inserts and
  forced epochs, every ticket held to the port's single-device engine
  and every answer to a dict + linear-scan oracle, the shards' agreement
  on a fold's survivors, one readback a round on every rank, large ids
  against the oracle, and a 4-rank checkpoint round trip.

No default process group outlives this module.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import small_pfo_config, unit_vec
from repro.checkpoint import ckpt as jckpt
from repro.core import DistConfig as JaxDistConfig
from repro.core import coldtier as jcold
from repro.core import snapshots as jsnap
from repro.serving import DistStreamEngine as JaxDistStreamEngine
from repro.serving import StreamConfig as JaxStreamConfig
from repro.sharding.policy import stream_mesh as jax_stream_mesh
from repro_torch import convert
from repro_torch.checkpoint import load_dist_checkpoint, save_dist_checkpoint
from repro_torch.core import (DistConfig, PFOConfig, PFOIndex, coldtier,
                              dist_init_state, make_dist_insert,
                              make_dist_query)
from repro_torch.core import distributed as dist_mod
from repro_torch.core import snapshots as snap_mod
from repro_torch.core.dispatch import all_to_all_route, owner_of_tree
from repro_torch.serving import DistStreamEngine, StreamConfig, StreamEngine
from repro_torch.sharding import stream_mesh
from _torch_dist_child import Vectors, oracle_live
from test_torch_cold import _assert_equal

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 16
DIST_TOL = 1e-5


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A one-rank gloo group for this module, torn down after it."""
    store = tmp_path_factory.mktemp("pg") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield stream_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _port_cfg(cfg):
    return PFOConfig(**cfg.__dict__)


# ======================================================================
# the process layout
# ======================================================================
def test_stream_mesh_layout_and_refusals(mesh, monkeypatch):
    assert (mesh.n_model, mesh.n_data, mesh.shard, mesh.data_index,
            mesh.rank, mesh.backend) == (1, 1, 0, 0, 0, "gloo")
    with pytest.raises(RuntimeError, match="world of 4"):
        stream_mesh(4, device="cpu")
    with pytest.raises(RuntimeError, match="world of 2"):
        stream_mesh(1, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            stream_mesh(1)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        stream_mesh(1, device="cpu")


def test_routing_primitives(mesh):
    tree = torch.tensor([0, 5, -1, 7, 3])
    np.testing.assert_array_equal(owner_of_tree(tree, 8, 2).numpy(),
                                  [0, 1, -1, 1, 0])
    # two mailboxes of a one-rank group share one counted all_to_all
    a = torch.arange(12, dtype=torch.int32).reshape(1, 3, 4)
    b = -torch.arange(5, dtype=torch.int32).reshape(1, 5, 1)
    before = dist_mod.COLLECTIVES["all_to_all"]
    ra, rb = all_to_all_route([a, b], mesh.model_group)
    assert dist_mod.COLLECTIVES["all_to_all"] == before + 1
    np.testing.assert_array_equal(ra.numpy(), a.reshape(3, 4).numpy())
    np.testing.assert_array_equal(rb.numpy(), b.reshape(5, 1).numpy())


# ======================================================================
# the distributed steps: the reference's properties
# ======================================================================
@pytest.fixture(scope="module")
def dist_setup(mesh):
    cfg = _port_cfg(small_pfo_config(dim=16, L=2, C=1, m=2, main_m=2,
                                     max_leaves_per_tree=512,
                                     main_max_leaves_per_tree=2048,
                                     store_capacity=4096,
                                     max_candidates_total=128))
    dcfg = DistConfig(pfo=cfg, n_model=1)
    # the reference test's inputs: projections from jax.random key 0
    from repro.core.lsh import make_projections
    proj = make_projections(jax.random.PRNGKey(0), _jax_cfg(cfg))
    state = dist_init_state(dcfg, mesh,
                            proj={k: np.asarray(v) for k, v in proj.items()})
    rng = np.random.default_rng(0)
    n = 600
    vecs = rng.normal(size=(n, 16)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    ins = make_dist_insert(dcfg, mesh, capacity=2048)
    state, pending = ins(state, torch.arange(n, dtype=torch.int32),
                         torch.as_tensor(vecs), torch.ones(n, dtype=torch.bool))
    assert int(pending.sum()) == 0
    return state, make_dist_query(dcfg, mesh, k=10), vecs


def test_dist_query_self_hit(dist_setup):
    state, qry, vecs = dist_setup
    ids, dists = qry(state, torch.as_tensor(vecs[:16]))
    assert (ids[:, 0].numpy() == np.arange(16)).all()
    np.testing.assert_allclose(dists[:, 0].numpy(), 0, atol=1e-5)


def test_dist_query_no_duplicate_ids(dist_setup):
    state, qry, vecs = dist_setup
    ids, _ = qry(state, torch.as_tensor(vecs[:8]))
    for row in ids.numpy():
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


def test_dist_recall_beats_random(dist_setup):
    state, qry, vecs = dist_setup
    rng = np.random.default_rng(2)
    q = vecs[:16] + rng.normal(size=(16, 16)).astype(np.float32) * 0.05
    ids, _ = qry(state, torch.as_tensor(q))
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    oid = np.argsort(1.0 - qn @ vecs.T, axis=1)[:, :10]
    rec = np.mean([len(set(ids.numpy()[i]) & set(oid[i])) / 10
                   for i in range(16)])
    assert rec > 0.1


# ======================================================================
# the stream engine: the JAX DistStreamEngine, the port's StreamEngine
# ======================================================================
def _hot_cfg():
    return small_pfo_config(dim=16, L=2, C=1, m=2, main_m=2,
                            max_leaves_per_tree=64, max_nodes_per_tree=32,
                            main_max_leaves_per_tree=512,
                            store_capacity=4096,
                            max_candidates_per_probe=32,
                            max_candidates_total=256,
                            snap_budget_per_probe=32, max_tombstones=48)


def _cold_cfg():
    # cold_cache_slots >= L * cold_segments: the single-device per-table
    # chains never thrash the cache
    return small_pfo_config(
        dim=16, L=2, C=1, m=2, main_m=2,
        max_leaves_per_tree=24, max_nodes_per_tree=32,
        main_max_leaves_per_tree=256, store_capacity=4096,
        max_candidates_per_probe=32, max_candidates_total=256,
        snap_budget_per_probe=32, max_snapshots=4, max_tombstones=32,
        cold_segments=8, cold_cache_slots=16, cold_fetch_rounds=4)


def _engines(mesh, cfg, cold_dir=None):
    """The JAX DistStreamEngine on a one-device mesh, the port's on the
    one-rank group (with the JAX projections) and the port's
    single-device engine."""
    scfg = dict(max_batch=16, min_batch=16, default_k=5)
    jeng = JaxDistStreamEngine(JaxDistConfig(pfo=cfg, n_model=1),
                               jax_stream_mesh(1, n_data=1),
                               JaxStreamConfig(**scfg), seed=0)
    proj = {k: np.asarray(v) for k, v in jeng.backend.state.proj.items()}
    tcfg = _port_cfg(cfg)
    deng = DistStreamEngine(DistConfig(pfo=tcfg, n_model=1), mesh,
                            StreamConfig(**scfg), proj=proj,
                            cold_dir=cold_dir)
    seng = StreamEngine(PFOIndex(tcfg, device="cpu",
                                 proj=convert.proj_from_numpy(proj)),
                        StreamConfig(**scfg))
    return jeng, deng, seng, Vectors(proj)


def _fast_lane(engs, vec, cold: bool):
    """The JAX package's fast-lane traces (``tests/test_dist_stream.py``):
    hot, 120 interleaved requests with a forced seal and merge; cold,
    insert pressure until spills, then 140 requests.  Returns the
    ticket tuples and, for each query's index among them, its vector and
    the dict oracle's state at its window's flush (each live id at its
    newest vector)."""
    rng = np.random.default_rng(7 if cold else 5)
    ver, live, tickets = {}, set(), []
    probes, waiting = {}, []

    def each(op, *args):
        tickets.append(tuple(getattr(e, op)(*args) for e in engs))

    def flush():
        for e in engs:
            e.flush()
        snap = {i: vec(i, ver[i]) for i in live}
        for at, q in waiting:
            probes[at] = (q, snap)
        waiting.clear()

    if cold:
        for nxt in range(1000, 1000 + 24 * 16):
            ver[nxt] = 1
            each("insert", nxt, vec(nxt, 1))
            live.add(nxt)
            if nxt % 16 == 15:
                flush()
    for step in range(140 if cold else 120):
        kind = rng.choice(4, p=[.3, .4, .15, .15] if cold
                          else [.35, .3, .15, .2])
        i = int(rng.integers(0, 128 if cold else 48))
        if kind == 0 and live:
            j = sorted(live)[int(rng.integers(0, len(live)))]
            q = vec(j, ver[j]) + rng.normal(size=(DIM,)).astype(
                np.float32) * 0.05
            each("query", q, 5)
            waiting.append((len(tickets) - 1, q))
        elif kind == 1:
            ver[i] = ver.get(i, 0) + 1
            each("insert", i, vec(i, ver[i]))
            live.add(i)
        elif kind == 2 and live:
            j = sorted(live)[int(rng.integers(0, len(live)))]
            each("delete", j)
            live.discard(j)
        elif kind == 3 and live:
            j = sorted(live)[int(rng.integers(0, len(live)))]
            ver[j] += 1
            each("update", j, vec(j, ver[j]))
        if not cold and step in (60, 90):
            flush()
            for e in engs:
                (e.seal if step == 60 else e.merge)()
        if rng.random() < (0.12 if cold else 0.1):
            flush()
    flush()
    return tickets, probes


def _assert_answers_equal(got, want):
    if isinstance(want, str):
        assert got == want
        return
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0,
                               atol=DIST_TOL)


@pytest.fixture(scope="module", params=["hot", "cold"])
def played(request, mesh):
    cold = request.param == "cold"
    jeng, deng, seng, vec = _engines(mesh, _cold_cfg() if cold
                                     else _hot_cfg())
    # count the hot MainTable entries the port's rounds displace (a live
    # re-insert's older entry), in all and at each seal
    displaced, at_seals = [0], []
    free_displaced, seal_fn = dist_mod.free_displaced, deng.backend._seal_fn

    def counted_free(store, slots, mail_ids):
        displaced[0] += int((slots >= 0).sum())
        return free_displaced(store, slots, mail_ids)

    def counted_seal(state):
        at_seals.append(displaced[0])
        return seal_fn(state)

    deng.backend._seal_fn = counted_seal
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist_mod, "free_displaced", counted_free)
        tickets, probes = _fast_lane((jeng, deng, seng), vec, cold)
    res = [tuple(e.result(t) for e, t in zip((jeng, deng, seng), ts))
           for ts in tickets]
    return dict(jeng=jeng, deng=deng, seng=seng, res=res, probes=probes,
                cold=cold, displaced=displaced[0],
                displaced_since_seal=displaced[0] - (at_seals or [0])[-1])


def test_one_rank_matches_jax_dist_engine(played):
    """Ticket for ticket against the JAX engine, except where the trace
    re-inserted a live id: the port keeps one MainTable entry an id and
    answers at its newest vector, the JAX engine may answer at an older
    one (``ROADMAP.md`` Queue 3).  So every port answer holds to the dict
    + linear-scan oracle, and equals the JAX engine's wherever that one
    holds to it too."""
    jeng, deng = played["jeng"], played["deng"]
    jax_stale = 0
    for at, (want, got, _) in enumerate(played["res"]):
        if at in played["probes"]:
            assert oracle_live(got, *played["probes"][at]), (at, got)
            if not oracle_live(want, *played["probes"][at]):
                jax_stale += 1
                continue
        _assert_answers_equal(got, want)
    assert jax_stale < len(played["probes"]) // 4, jax_stale
    js, ds = jeng.stats(), deng.stats()
    for key in ("seals", "merges", "spills", "rounds_by_kind", "batches"):
        assert ds[key] == js[key], key
    jb, db = jeng.backend.stats(), deng.backend.stats()
    for key in ("lsh_leaves", "tombstones", "stamp",
                "query_candidate_drops"):
        assert db[key] == jb[key], key
    # the JAX engine keeps a second MainTable entry and store slot for
    # each live re-insert the hot forest still held: one entry each since
    # the last seal (a seal empties the hot forest), one slot each in all
    assert played["displaced"] >= 1
    assert (jb["items_hot"] - db["items_hot"]
            == played["displaced_since_seal"])
    assert db["store_free"] - jb["store_free"] == played["displaced"]
    if played["cold"]:
        assert ds["spills"] >= 1 and ds["cold"]["cold_segments"] >= 1
        assert ds["cold"]["incomplete_query_rounds"] == 0
    else:
        assert ds["seals"] >= 1 and ds["merges"] >= 1


def test_one_rank_matches_port_engine(played):
    deng, seng = played["deng"], played["seng"]
    for _, got, want in played["res"]:
        _assert_answers_equal(got, want)
    ds, ss = deng.stats(), seng.stats()
    for key in ("seals", "merges", "spills", "rounds_by_kind"):
        assert ds[key] == ss[key], key
    db, sb = deng.backend.stats(), seng.index.stats()
    for key in ("items_hot", "lsh_leaves", "tombstones", "stamp"):
        assert db[key] == sb[key], key
    # the shard's whole state against the single-device one
    dst, sst = deng.backend.state, seng.index.state
    for part in ("lsh_forest", "tombstones", "n_tombstones", "stamp"):
        _assert_equal(getattr(dst, part), getattr(sst, part), part)


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_crowded_buckets_match_port_engine(mesh, cold):
    """Four prefix buckets and a probe budget of 4: a shard's mixed ring
    (cold: its cold chain) crowds each bucket with every table's
    entries, and its (table, key) views still read each table's own run,
    so the answers are the single-device engine's (the shared span the
    JAX package reads would lose candidates here)."""
    base = _cold_cfg() if cold else _hot_cfg()
    cfg = _port_cfg(base.__class__(**{**base.__dict__, "snap_prefix_bits": 2,
                                      "snap_budget_per_probe": 4}))
    scfg = dict(max_batch=16, min_batch=16, default_k=5)
    deng = DistStreamEngine(DistConfig(pfo=cfg, n_model=1), mesh,
                            StreamConfig(**scfg), seed=3)
    proj = {k: v.clone() for k, v in deng.backend.state.proj.items()}
    seng = StreamEngine(PFOIndex(cfg, device="cpu", proj=proj),
                        StreamConfig(**scfg))
    vec = Vectors(proj)
    rng = np.random.default_rng(4)
    n = 24 * 16 if cold else 320
    for e in (deng, seng):
        for i in range(n):
            e.insert(i, vec(i, 1))
            if i % 16 == 15:
                e.flush()
        e.flush()
        if not cold:
            e.seal()
    tickets = []
    for i in range(0, n, 3):
        q = vec(i, 1) + rng.normal(size=(DIM,)).astype(np.float32) * 0.1
        tickets.append((deng.query(q, 5), seng.query(q, 5)))
    deng.flush(), seng.flush()
    for td, ts in tickets:
        _assert_answers_equal(deng.result(td), seng.result(ts))
    st = deng.stats()
    assert (st["spills"] if cold else st["seals"]) >= 1


def test_round_variants_bounded_by_buckets(played):
    be = played["deng"].backend
    n_buckets = len(played["deng"].scfg.buckets)
    assert len(be._ins) <= n_buckets
    assert len(be._del) <= n_buckets
    assert len(be._qry) <= 1 + 1          # default_k (+ explicit k=5)


def test_steady_state_single_readback(played):
    deng = played["deng"]
    for i in range(16):
        deng.insert(2000 + i, unit_vec(2000 + i, 1, DIM))
    deng.flush()
    for i in range(16):
        deng.insert(2100 + i, unit_vec(2100 + i, 1, DIM))
    st0 = deng.stats()
    deng.flush()
    st1 = deng.stats()
    rounds = st1["rounds"] - st0["rounds"]
    assert rounds >= 1
    assert st1["readbacks"] - st0["readbacks"] == rounds


def test_large_ids_survive_routing(mesh):
    """Ids past 2^24 ride the int32 payload columns bit for bit: each is
    its own nearest neighbour at ~0, every distance is the true one to
    its id's vector (a dict + linear-scan oracle), and after the deletes
    no query returns them."""
    cfg = _port_cfg(_hot_cfg())
    eng = DistStreamEngine(DistConfig(pfo=cfg, n_model=1), mesh,
                           StreamConfig(max_batch=16, min_batch=16,
                                        default_k=3))
    big = [2**24 + 1, 2**28 + 7, 2**31 - 2]
    store = {b: unit_vec(b, 1, DIM) for b in big}
    store.update({j: unit_vec(j, 1, DIM) for j in range(20)})
    for vid, x in store.items():
        eng.insert(vid, x)
    eng.flush()
    for b in big:
        t = eng.query(store[b], k=3)
        ids, d = eng.flush()[t]
        assert int(ids[0]) == b and float(d[0]) < 1e-5
        for vid, dv in zip(ids[ids >= 0], d[ids >= 0]):
            x, q = store[int(vid)], store[b]
            true = 1.0 - float(q @ x) / float(np.linalg.norm(q)
                                              * np.linalg.norm(x))
            assert abs(true - float(dv)) < 1e-4
    for b in big:
        eng.delete(b)
    eng.flush()
    for b in big:
        t = eng.query(store[b], k=3)
        ids, _ = eng.flush()[t]
        assert not set(ids.tolist()) & set(big)


# ======================================================================
# distributed checkpoints, both directions (n_model = 1, cold)
# ======================================================================
@pytest.fixture(scope="module")
def spilled(mesh, tmp_path_factory):
    """A JAX and a port DistStreamEngine fed the same inserts until
    their rings spilled into file-backed cold chains."""
    root = tmp_path_factory.mktemp("dck")
    cfg = _cold_cfg()
    scfg = dict(max_batch=16, min_batch=16, default_k=5)
    jeng = JaxDistStreamEngine(JaxDistConfig(pfo=cfg, n_model=1),
                               jax_stream_mesh(1, n_data=1),
                               JaxStreamConfig(**scfg), seed=0,
                               cold_dir=str(root / "jcold"))
    proj = {k: np.asarray(v) for k, v in jeng.backend.state.proj.items()}
    deng = DistStreamEngine(DistConfig(pfo=_port_cfg(cfg), n_model=1), mesh,
                            StreamConfig(**scfg), proj=proj,
                            cold_dir=str(root / "pcold"))
    vec = Vectors(proj)
    for nxt in range(1000, 1000 + 24 * 16):
        jeng.insert(nxt, vec(nxt, 1))
        deng.insert(nxt, vec(nxt, 1))
        if nxt % 16 == 15:
            jeng.flush(), deng.flush()
    assert deng.stats()["cold"]["cold_segments"] >= 1
    probes = [vec(p, 1) for p in (1000, 1100, 1200, 1383)]
    return dict(cfg=cfg, scfg=scfg, jeng=jeng, deng=deng, root=root,
                probes=probes)


def _answers(eng, probes):
    out = []
    for q in probes:
        t = eng.query(q, k=5)
        out.append(eng.flush()[t])
    return out


def test_dist_checkpoint_jax_to_port(spilled, mesh, tmp_path):
    s = spilled
    jckpt.save_dist_checkpoint(str(tmp_path), 3, s["jeng"].backend)
    port = DistStreamEngine(DistConfig(pfo=_port_cfg(s["cfg"]), n_model=1),
                            mesh, StreamConfig(**s["scfg"]), seed=5,
                            cold_dir=str(tmp_path / "pc"))
    load_dist_checkpoint(str(tmp_path), 3, port.backend)
    jrest = JaxDistStreamEngine(JaxDistConfig(pfo=s["cfg"], n_model=1),
                                jax_stream_mesh(1, n_data=1),
                                JaxStreamConfig(**s["scfg"]), seed=0,
                                cold_dir=str(tmp_path / "jc"))
    jckpt.load_dist_checkpoint(str(tmp_path), 3, jrest.backend)
    assert port.backend.state.store.owner is None
    assert port.backend.n_inserted == jrest.backend.n_inserted > 0
    _dist_states_equal(jrest.backend.state, port.backend.state)
    assert port.backend.cold_mgr.n_cold == jrest.backend.cold_mgrs[0].n_cold
    for got, want in zip(_answers(port, s["probes"]),
                         _answers(jrest, s["probes"])):
        _assert_answers_equal(got, want)


def test_dist_checkpoint_port_to_jax(spilled, mesh, tmp_path):
    s = spilled
    path = save_dist_checkpoint(str(tmp_path), 4, s["deng"].backend)
    man = json.load(open(os.path.join(path, "manifest.json")))
    assert man["extra"]["n_model"] == 1
    assert len(man["extra"]["cold_manifests"]) == 1
    jrest = JaxDistStreamEngine(JaxDistConfig(pfo=s["cfg"], n_model=1),
                                jax_stream_mesh(1, n_data=1),
                                JaxStreamConfig(**s["scfg"]), seed=0,
                                cold_dir=str(tmp_path / "jc"))
    jckpt.load_dist_checkpoint(str(tmp_path), 4, jrest.backend)
    port = DistStreamEngine(DistConfig(pfo=_port_cfg(s["cfg"]), n_model=1),
                            mesh, StreamConfig(**s["scfg"]), seed=5,
                            cold_dir=str(tmp_path / "pc"))
    load_dist_checkpoint(str(tmp_path), 4, port.backend)
    assert port.backend.state.store.owner is not None
    _dist_states_equal(jrest.backend.state, port.backend.state)
    for got, want in zip(_answers(port, s["probes"]),
                         _answers(jrest, s["probes"])):
        _assert_answers_equal(got, want)
    other = DistStreamEngine(DistConfig(pfo=_port_cfg(s["cfg"]), n_model=2),
                             mesh, StreamConfig(**s["scfg"]))
    with pytest.raises(ValueError, match="resharded"):
        load_dist_checkpoint(str(tmp_path), 4, other.backend)


def _dist_states_equal(js, ts):
    """A JAX distributed state (stacked, n_model = 1) against a port
    shard: forests as they are, every stacked leaf at shard 0."""
    js = jax.device_get(js)
    for part in ("lsh_forest", "main_forest", "tombstones", "n_tombstones",
                 "stamp", "proj"):
        _assert_equal(getattr(ts, part), getattr(js, part), part)
    for part in ("store", "main_snaps", "cold"):
        _assert_equal(getattr(ts, part), jax.tree.map(lambda a: a[0],
                                                      getattr(js, part)),
                      part)
    _assert_equal(ts.lsh_snaps, js.lsh_snaps, "lsh_snaps")


# ======================================================================
# the mixed-table cold tier and the grouped merge against the JAX ones
# ======================================================================
def test_mixed_tier_functions_match_jax(spilled):
    """``cold_probe_lsh_mixed`` on the spilled shard (its cache empty,
    then holding what a query round fetched), ``_fold_entries(
    group_by_val=True)`` and ``snapshots.merge(group_by_val=True)``
    against the JAX functions."""
    dcfg = DistConfig(pfo=_port_cfg(spilled["cfg"]), n_model=1)
    snap_cfg = dist_mod.shard_snap_cfg(dcfg)
    rng = np.random.default_rng(3)
    for fetched in (False, True):
        if fetched:
            _answers(spilled["jeng"], spilled["probes"])
            _answers(spilled["deng"], spilled["probes"])
        tstate = spilled["deng"].backend.state
        jshard = jax.tree.map(lambda a: a[0], jax.device_get(
            spilled["jeng"].backend.state.cold))
        _assert_equal(tstate.cold, jshard, "cold")
        hs, _ = dist_mod._keys_and_trees(
            tstate, torch.as_tensor(np.stack(spilled["probes"])), dcfg.pfo)
        want = jcold.cold_probe_lsh_mixed(
            jshard, jnp.asarray(hs.numpy().astype(np.uint32)),
            _jax_cfg(snap_cfg))
        got = coldtier.cold_probe_lsh_mixed(tstate.cold, hs, snap_cfg)
        for g, w, name in zip(got, want, ("cand", "wanted", "missing",
                                          "probed", "fp")):
            _assert_equal(g, w, name)
        assert np.asarray(want[1]).any()
        assert np.asarray(want[2]).any() != fetched

    n = 700
    ids = rng.integers(-1, 200, n).astype(np.int32)
    keys = rng.integers(0, 2**32, n).astype(np.uint32)
    vals = rng.integers(0, 2, n).astype(np.int32)        # table ids
    stamps = rng.integers(1, 6, n).astype(np.int32)
    args = (keys, ids, vals, stamps, np.asarray([3, 9], np.int32), 128, 8,
            3, 1024)
    jf = jcold._fold_entries(*args, group_by_val=True)
    tf = coldtier._fold_entries(*args, group_by_val=True)
    assert len(tf) == len(jf) >= 2
    for g, w in zip(tf, jf):
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)

    # a mixed ring with duplicate (id, table) entries across segments
    ring = snap_mod.init_snapshots(snap_cfg, 1)
    jring = jsnap.init_snapshots(_jax_cfg(snap_cfg))
    cap = snap_cfg.snapshot_capacity
    for st in (1, 2, 3):
        sid = rng.integers(0, 60, cap).astype(np.int32)
        sval = rng.integers(0, 2, cap).astype(np.int32)
        skey = rng.integers(0, 2**32, cap).astype(np.uint32)
        mask = rng.random(cap) < 0.6
        ring = snap_mod.seal(ring, torch.as_tensor(skey.astype(np.int64))[None],
                             torch.as_tensor(sid)[None],
                             torch.as_tensor(sval)[None],
                             torch.as_tensor(mask)[None],
                             torch.tensor(st, dtype=torch.int32), snap_cfg)
        jring = jsnap.seal(jring, jnp.asarray(skey), jnp.asarray(sid),
                           jnp.asarray(sval), jnp.asarray(mask),
                           jnp.int32(st), _jax_cfg(snap_cfg))
    tombs = np.asarray([5, 7, -1], np.int32)
    got = snap_mod.merge(ring, snap_cfg, torch.as_tensor(tombs),
                         group_by_val=True)
    want = jsnap.merge(jring, _jax_cfg(snap_cfg), jnp.asarray(tombs),
                       group_by_val=True)
    _assert_equal(snap_mod.unbatch(got), want, "merge")


def _jax_cfg(cfg):
    from repro.core import PFOConfig as JaxPFOConfig
    return JaxPFOConfig(**cfg.__dict__)


# ======================================================================
# four ranks in subprocesses
# ======================================================================
@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    child = os.path.join(REPO, "tests", "_torch_dist_child.py")
    procs = [subprocess.Popen(
        [sys.executable, child, str(r), "4", str(tmp / "store"),
         str(tmp / "ckpt")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed\n{out}\n{err[-4000:]}"
        line = [ln for ln in out.splitlines()
                if ln.startswith("TORCH_DIST_RESULT ")]
        assert line, out
        recs.append(json.loads(line[0].split(" ", 1)[1]))
    return recs


@pytest.mark.parametrize("trace", ["hot_1x4", "cold_1x4", "hot_2x2",
                                   "cold_2x2", "strict_1x4"])
def test_four_ranks_equal_single_device(four_ranks, trace):
    recs = [r[trace] for r in four_ranks]
    assert all(r == recs[0] for r in recs)          # every rank agrees
    rec = recs[0]
    assert rec["mismatches"] == 0, rec
    assert rec["oracle_violations"] == 0, rec
    assert rec["queries"] >= 25
    if trace != "strict_1x4":
        assert rec["live_reinserts"] >= 1         # duplicate-id re-inserts
    assert rec["query_candidate_drops"] == 0
    assert rec["seals"][0] == rec["seals"][1] >= 1
    assert rec["merges"][0] == rec["merges"][1] >= 1
    assert rec["spills"][0] == rec["spills"][1]
    rounds, readbacks = rec["readbacks_per_round"]
    assert rounds >= 1 and readbacks == rounds
    if trace.startswith("cold"):
        assert rec["spills"][0] >= 1 and rec["cold_segments"] >= 1
        assert rec["incomplete"] == 0


@pytest.mark.parametrize("case", ["stale_entries", "stale_entries_cold"])
def test_four_ranks_agree_on_fold_survivors(four_ranks, case):
    """Re-inserted ids whose versions' trees sit on different shards,
    then a merge (a cold merge with a cold tier): without the agreement
    (``distributed.agree_fold``) 50 of these 64 queries at the older
    vectors find the id on the distributed engine alone."""
    recs = [r[case] for r in four_ranks]
    assert all(r == recs[0] for r in recs)
    rec = recs[0]
    assert rec["queries"] == 64
    assert rec["mismatches"] == 0, rec
    assert rec["oracle_violations"] == 0, rec


@pytest.mark.parametrize("case", ["live_reinsert", "live_reinsert_cold"])
def test_four_ranks_live_reinsert(four_ranks, case):
    """48 ids re-inserted while live (with a cold tier, past a spill),
    queried at their older vectors before a seal, after it and after a
    merge: no answer ranks an id at its older vector's distance on
    either engine, every ticket equals the single-device engine's, and
    every answer holds to the dict + linear-scan oracle."""
    recs = [r[case] for r in four_ranks]
    assert all(r == recs[0] for r in recs)
    rec = recs[0]
    assert rec["queries"] == 3 * 48
    assert rec["stale"] == [[0, 0]] * 3, rec
    assert rec["mismatches"] == 0, rec
    assert rec["oracle_violations"] == 0, rec


def test_four_ranks_cold_compaction_at_another_epoch(four_ranks):
    """Updated ids whose two versions sit in cold segments, queried at
    their older vectors while the distributed backend has compacted its
    shards' chains and the single device has not yet installed its
    background fold: the answers may differ between the engines (one
    still finds ids through their older entries), and each engine's
    answers hold to the dict + linear-scan oracle."""
    recs = [r["cold_compaction_epochs"] for r in four_ranks]
    assert all(r == recs[0] for r in recs)
    rec = recs[0]
    assert rec["queries"] == 24
    assert min(rec["spills_before_update"]) >= 1     # v1 reached the cold
    assert rec["compactions"][0] != rec["compactions"][1], rec
    assert rec["merges"] == [0, 0], rec              # no merge dropped v1
    assert rec["oracle_violations"] == [0, 0], rec


def test_four_ranks_large_ids_and_checkpoint(four_ranks):
    for r in four_ranks:
        assert r["big_ids"]["found"] == 3
        assert r["checkpoint"]["cold_segments"] >= 1
        assert r["checkpoint"]["probes"] == 4
