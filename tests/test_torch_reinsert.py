"""A live re-insert replaces its id's hot MainTable entry (the port's
repair of a reference defect, ``ROADMAP.md`` Queue 3).

Inserting an id that the hot MainTable already holds overwrites that
entry's store slot with the new one and frees the older slot, in the
same round (``hash_tree.forest_replace_dispatched``,
``index.free_displaced``): one live entry an id, so a query at the older
vector finds the id at its newest vector's distance before a seal,
after one and after a merge.  The JAX package keeps both entries and
answers at the older vector for most such ids.

Held here against a dict + linear-scan oracle (each id live, once, at
its newest vector): 48 ids re-inserted live once, hot and with a cold
tier past a spill, through ``PFOIndex`` and through ``StreamEngine``;
two rows of one id in one batch (the later wins); the forest's displaced
values.  The four-rank distributed engine runs the same trace in
``tests/_torch_dist_child.py`` (``live_reinsert``).  On traces without a
live re-insert the port's slot allocation still equals the JAX
engine's bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_dist_child import Vectors, _angular, config, oracle_live
from repro.core import PFOIndex as JaxIndex
from repro_torch import convert
from repro_torch.core import PFOConfig, PFOIndex, hash_tree
from repro_torch.serving import StreamConfig, StreamEngine

torch.set_num_threads(1)

N_IDS = 48
STAGES = ("before_seal", "after_seal", "after_merge")


def _cfg(cold: bool) -> PFOConfig:
    """The four-rank child's config; hot, with LSH arenas that hold the
    whole trace, so the first stage runs before any seal."""
    cfg = config(cold)
    if cold:
        return cfg
    return PFOConfig(**{**cfg.__dict__, "max_leaves_per_tree": 64})


def _engine(cold: bool, tmp_path=None):
    cfg = _cfg(cold)
    idx = PFOIndex(cfg, seed=0, device="cpu",
                   cold_dir=str(tmp_path) if tmp_path else None)
    eng = StreamEngine(idx, StreamConfig(max_batch=16, min_batch=16,
                                         default_k=5))
    return eng, Vectors({k: v.numpy() for k, v in idx.state.proj.items()})


def _spill(eng, vec) -> dict:
    """Fresh inserts until the ring has spilled into the cold tier;
    returns them as the oracle's {id: vector}."""
    filler = {}
    while eng.stats()["spills"] < 1:
        for _ in range(16):
            i = 1000 + len(filler)
            filler[i] = vec(i, 1)
            eng.insert(i, filler[i])
        eng.flush()
        assert len(filler) < 3000, "no spill"
    return filler


def _stale(answer, i: int, q, v_old, v_new) -> bool:
    """The answer ranks id ``i`` at its older vector's distance."""
    ids, d = answer
    hit = ids == i
    if not hit.any():
        return False
    di = float(d[hit][0])
    return (abs(di - _angular(q, v_old)) <= 1e-5
            and abs(di - _angular(q, v_new)) > 1e-5)


def _live_reinsert(eng, vec, via_stream: bool, filler: dict):
    """Ids 0..47 inserted, then each re-inserted live once with a new
    vector; queries at every older vector before a seal, after a seal,
    and after a seal then a merge.  Returns {stage: (stale, oracle
    violations, answers holding the id)}."""
    ids = np.arange(N_IDS, dtype=np.int32)
    old = np.stack([vec(i, 1) for i in ids])
    new = np.stack([vec(i, 2) for i in ids])
    for vecs in (old, new):
        if via_stream:
            for i in ids:
                eng.insert(int(i), vecs[i])
            eng.flush()
        else:                       # the stream's window size a call
            for s in range(0, N_IDS, 16):
                eng.index.insert(ids[s:s + 16], vecs[s:s + 16])
    snap = dict(filler)
    snap.update({int(i): new[i] for i in ids})
    out = {}
    for stage in STAGES:
        if stage == "after_seal":
            eng.seal()
        elif stage == "after_merge":
            eng.merge()
        if via_stream:
            tickets = [eng.query(old[i], k=5) for i in ids]
            res = eng.flush()
            answers = [res[t] for t in tickets]
        else:
            got = eng.index.query(old, k=5)
            answers = list(zip(*got))
        stale = sum(_stale(a, int(i), old[i], old[i], new[i])
                    for i, a in zip(ids, answers))
        bad = sum(not oracle_live(a, old[i], snap)
                  for i, a in zip(ids, answers))
        found = sum(int(i) in a[0] for i, a in zip(ids, answers))
        out[stage] = (stale, bad, found)
    return out


@pytest.mark.parametrize("via_stream", [False, True],
                         ids=["pfo_index", "stream_engine"])
@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_live_reinsert_answers_at_the_newest_vector(cold, via_stream,
                                                    tmp_path):
    eng, vec = _engine(cold, tmp_path if cold else None)
    filler = _spill(eng, vec) if cold else {}
    seals = eng.stats()["seals"]
    out = _live_reinsert(eng, vec, via_stream, filler)
    assert eng.stats()["seals"] >= seals + 1 and eng.stats()["merges"] >= 1
    for stage, (stale, bad, found) in out.items():
        assert (stale, bad) == (0, 0), (stage, out)
    if not cold:
        # before a merge folds away the older vectors' LSH entries, every
        # query reaches its id (with fillers, nearer ones may fill k)
        assert out["before_seal"][2] == out["after_seal"][2] == N_IDS, out
    # one live store slot an id: the displaced ones went back
    st = eng.index.state.store
    live = int(st.live.sum())
    assert live == int(st.data.shape[0]) - int(st.free_top)
    if not cold:
        assert live == N_IDS


def test_jax_engine_answers_at_older_vectors():
    """The reference on the hot trace: both versions stay in its hot
    MainTable, whose lookup takes the older where a spread reversed
    their chain (3 of 48 here), and a seal writes both into one segment,
    whose lookup takes the older (48 of 48); both store slots stay
    held."""
    from repro.serving import StreamConfig as JaxStreamConfig
    from repro.serving import StreamEngine as JaxStreamEngine
    cfg = _cfg(False)
    jidx = JaxIndex(cfg, seed=0)
    eng = JaxStreamEngine(jidx, JaxStreamConfig(max_batch=16, min_batch=16,
                                                default_k=5))
    proj = {k: np.asarray(v) for k, v in jidx.state.proj.items()}
    vec = Vectors(proj)
    ids = np.arange(N_IDS, dtype=np.int32)
    old = np.stack([vec(i, 1) for i in ids])
    new = np.stack([vec(i, 2) for i in ids])
    jidx.insert(ids, old)
    jidx.insert(ids, new)
    assert int(jax.device_get(jidx.state.store.free_top)) == \
        cfg.store_capacity - 2 * N_IDS
    stale = []
    for stage in STAGES:
        if stage == "after_seal":
            eng.seal()
        elif stage == "after_merge":
            eng.merge()
        got = jidx.query(old, k=5)
        stale.append(sum(_stale((a, d), int(i), old[i], old[i], new[i])
                         for i, a, d in zip(ids, *got)))
    assert stale[0] >= 1 and stale[1] > N_IDS // 2, stale


def test_two_rows_of_one_id_in_one_batch():
    """The later row wins, as a dict's assignment does; its slot is the
    only one the id holds."""
    eng, vec = _engine(False)
    idx = eng.index
    ids = np.asarray([5, 7, 5, 9, 5], np.int32)
    vecs = np.stack([vec(5, 1), vec(7, 1), vec(5, 2), vec(9, 1), vec(5, 3)])
    idx.insert(ids, vecs)
    snap = {5: vec(5, 3), 7: vec(7, 1), 9: vec(9, 1)}
    for q in (vec(5, 1), vec(5, 2), vec(5, 3)):
        a = tuple(x[0] for x in idx.query(q[None], k=5))
        assert oracle_live(a, q, snap), a
    ids_q, d = idx.query(vec(5, 3)[None], k=1)
    assert ids_q[0, 0] == 5 and d[0, 0] < 1e-5
    st = idx.state.store
    assert int(st.live.sum()) == 3
    assert int(st.free_top) == st.data.shape[0] - 3
    for stage in ("seal", "merge"):
        getattr(eng, stage)()
        a = tuple(x[0] for x in idx.query(vec(5, 1)[None], k=5))
        assert oracle_live(a, vec(5, 1), snap), (stage, a)


def test_forest_displaced_values():
    """``forest_replace_dispatched``: a slot whose id the chain holds
    overwrites that leaf's value and gives up the older one; of two
    slots of one id in a mailbox the later wins and the earlier gives up
    its own value; what is left inserts as before."""
    cfg = hash_tree.TreeConfig(skip_bits=2, log2_l=4, l=16, t=4,
                               max_depth=7, max_nodes=32, max_leaves=64,
                               max_candidates=32)
    rng = np.random.default_rng(0)
    keys = {i: int(rng.integers(0, 2**32)) for i in range(40)}

    def mailbox(rows, vals):
        return (torch.tensor([[keys.get(i, 0) for i in r] for r in rows]),
                torch.tensor(rows), torch.tensor(vals))

    def round_(f, rows, vals):
        h, vid, val = mailbox(rows, vals)
        left, disp = hash_tree.forest_replace_dispatched(f, h, vid, val, cfg)
        hash_tree.forest_insert_dispatched(f, h, left, val, cfg)
        return left.tolist(), disp.tolist()

    f = hash_tree.init_forest(cfg, 2)
    left, disp = round_(f, [[3, 8, 3, 11, -1], [20, 21, 22, 20, 20]],
                        [[100, 101, 102, 103, 0], [200, 201, 202, 203, 204]])
    assert left == [[-1, 8, 3, 11, -1], [-1, 21, 22, -1, 20]]
    assert disp == [[100, -1, -1, -1, -1], [200, -1, -1, 203, -1]]
    assert f.n_items.tolist() == [3, 3]
    # a second round: the live entries are replaced in place
    left, disp = round_(f, [[3, 30], [20, -1]], [[300, 301], [400, 0]])
    assert left == [[-1, 30], [-1, -1]] and disp == [[102, -1], [204, -1]]
    assert f.n_items.tolist() == [4, 3]
    tids = torch.tensor([0, 0, 0, 0, 1, 1, 1])
    look = torch.tensor([3, 8, 11, 30, 20, 21, 22])
    v, found = hash_tree.forest_lookup_masked(
        f, tids, torch.tensor([keys[i] for i in look.tolist()]), look, cfg)
    assert found.all() and v.tolist() == [300, 101, 103, 301, 400, 201, 202]
    # without the pre-pass every slot adds a leaf, as the reference does
    g = hash_tree.init_forest(cfg, 2)
    h, vid, val = mailbox([[3, 8, 3, 11, -1], [20, 21, 22, 20, 20]],
                          [[100, 101, 102, 103, 0], [200, 201, 202, 203, 204]])
    hash_tree.forest_insert_dispatched(g, h, vid, val, cfg)
    assert g.n_items.tolist() == [4, 5]


def test_slot_allocation_without_live_reinserts_equals_jax():
    """Inserts, deletes, re-inserts of deleted ids and updates (no id
    inserted while live): the store's slots, free stack and the
    MainTable's values equal the JAX engine's after every call."""
    cfg = config(False)                # small arenas: seals and merges
    jidx = JaxIndex(cfg, seed=0)
    proj = {k: np.asarray(v) for k, v in jidx.state.proj.items()}
    tidx = PFOIndex(cfg, device="cpu", proj=convert.proj_from_numpy(proj))
    vec = Vectors(proj)
    rng = np.random.default_rng(3)
    live, ver = set(), {}

    def check():
        js = jax.device_get(jidx.state)
        ts = convert.state_to_numpy(tidx.state)
        for name in ("free_stack", "free_top", "live"):
            np.testing.assert_array_equal(
                ts["store"][name], np.asarray(getattr(js.store, name)), name)
        for name in ("leaf_id", "leaf_val"):
            np.testing.assert_array_equal(
                ts["main_forest"][name],
                np.asarray(getattr(js.main_forest, name)), name)
        np.testing.assert_array_equal(ts["main_snaps"]["vals"],
                                      np.asarray(js.main_snaps.vals))

    for step in range(10):
        fresh = [i for i in range(400) if i not in live][:16]
        for i in fresh:
            ver[i] = ver.get(i, 0) + 1
        new = np.asarray(fresh, np.int32)
        x = np.stack([vec(i, ver[i]) for i in fresh])
        jidx.insert(new, x), tidx.insert(new, x)
        live.update(fresh)
        check()
        dead = np.asarray(sorted(rng.choice(sorted(live), 3, replace=False)),
                          np.int32)
        jidx.delete(dead), tidx.delete(dead)
        live.difference_update(dead.tolist())
        check()
        upd = np.asarray(sorted(rng.choice(sorted(live), 2, replace=False)),
                         np.int32)
        for i in upd:
            ver[int(i)] += 1
        x = np.stack([vec(int(i), ver[int(i)]) for i in upd])
        jidx.update(upd, x), tidx.update(upd, x)
        check()
    assert {"seal", "merge"} <= set(tidx.maintenance_log)
