"""One rank of the port's multi-rank distributed checks, on gloo CPU ranks.

    python tests/_torch_dist_child.py RANK WORLD STORE_FILE CKPT_DIR

``tests/test_torch_dist.py`` starts WORLD (4) of these processes with a
``FileStore`` path under its ``tmp_path`` (no network).  Every rank
replays the same seeded traces — duplicate-id re-inserts of live ids,
delete-then-reinsert, update storms, forced seal and merge epochs —
through a ``DistStreamEngine`` on a ``(data=1, model=4)`` and a ``(data=2,
model=2)`` grid, hot and cold, and through the port's single-device
``StreamEngine``, and requires every ticket to match: query ids exact,
distances within 1e-5, update acks equal (the reference child's
contract, ``tests/_dist_stream_child.py``), and holds every distributed
answer to a dict + linear-scan oracle (each id live, once, at its newest
vector's distance).  ``stale_entries`` forces the case where the shards
must agree on a fold's survivors; ``live_reinsert`` re-inserts 48 live
ids and queries their older vectors (the port's one entry an id);
``cold_compaction_epochs`` queries updated ids at their older vectors
while one engine has compacted its cold chains and the other has not.  It also checks one readback a
steady-state round on every rank, ids above 2^24 through the routing
payloads against the oracle, and a 4-rank distributed checkpoint round
trip (a load at another ``n_model`` raises).

Prints one ``TORCH_DIST_RESULT <json>`` line; exit code 0 == every
check held.  Imports nothing of JAX.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from conftest import unit_vec                     # noqa: E402

from repro_torch.checkpoint import (load_dist_checkpoint,  # noqa: E402
                                    save_dist_checkpoint)
from repro_torch.core import DistConfig, PFOConfig, PFOIndex  # noqa: E402
from repro_torch.serving import (DistStreamEngine, StreamConfig,  # noqa: E402
                                 StreamEngine)
from repro_torch.sharding import stream_mesh      # noqa: E402

torch.set_num_threads(1)

DIM = 16
MARGIN = 1e-4
BIG_IDS = (2**24 + 1, 2**28 + 7, 2**31 - 2)


def config(cold: bool) -> PFOConfig:
    """Tiny arenas, so inserts force seals through the flag word; a
    small tombstone buffer, so deletes force merges; budgets generous
    enough that no candidate truncation binds (exactness)."""
    kw = dict(dim=DIM, L=2, C=1, m=2, l=16, t=4, main_m=2,
              max_nodes_per_tree=32, max_leaves_per_tree=24,
              main_max_nodes_per_tree=128, main_max_leaves_per_tree=256,
              store_capacity=4096, max_candidates_per_probe=32,
              max_candidates_total=256, max_snapshots=6, bloom_bits=1 << 12,
              snap_prefix_bits=8, snap_budget_per_probe=32, max_tombstones=48)
    if cold:
        # cold_cache_slots >= L * cold_segments: the single-device engine
        # runs one cold chain per table, and its Bloom fan-out may want
        # every segment at once
        kw.update(max_snapshots=4, cold_segments=8, cold_cache_slots=16,
                  cold_fetch_rounds=4)
    return PFOConfig(**kw)


class Vectors:
    """unit_vec(i, ver) re-drawn until every projection of the trace's
    SRP parameters lies MARGIN from zero (float64), so every hash of it
    agrees, whatever the batch and whichever package computes it."""

    def __init__(self, proj: dict):
        self.table = np.asarray(proj["table_proj"], np.float64)
        self.part = np.asarray(proj["part_proj"], np.float64)

    def __call__(self, i: int, ver: int) -> np.ndarray:
        for t in range(1000):
            x = unit_vec(i, ver + 7919 * t, DIM)
            p = x.astype(np.float64) @ self.table
            bits = np.where(p >= 0, 1.0, -1.0).reshape(self.part.shape[0], -1)
            pp = np.einsum("lm,lmc->lc", bits, self.part)
            if np.abs(p).min() >= MARGIN and np.abs(pp).min() >= MARGIN:
                return x
        raise AssertionError("no margin-safe vector")


def engines(mesh, cold: bool, ordering: str = "window", ckpt=None):
    cfg = config(cold)
    dcfg = DistConfig(pfo=cfg, n_model=mesh.n_model)
    scfg = StreamConfig(max_batch=16, min_batch=16, default_k=5,
                        ordering=ordering)
    deng = DistStreamEngine(dcfg, mesh, scfg, seed=0,
                            cold_dir=None if ckpt is None
                            else os.path.join(ckpt, "cold"))
    proj = {k: v.cpu() for k, v in deng.backend.state.proj.items()}
    seng = StreamEngine(PFOIndex(cfg, device="cpu", proj=proj), scfg)
    return deng, seng, Vectors(proj)


def _angular(q: np.ndarray, x: np.ndarray) -> float:
    q = q.astype(np.float64)
    x = x.astype(np.float64)
    return 1.0 - float(q @ x) / float(np.linalg.norm(q) * np.linalg.norm(x))


def oracle_live(a, q: np.ndarray, snap: dict) -> bool:
    """Every id of an answer live, once, at its newest vector's
    distance."""
    ids, d = a[0], a[1]
    got = ids[ids >= 0].tolist()
    return (len(set(got)) == len(got) and all(i in snap for i in got)
            and all(abs(_angular(q, snap[i]) - float(di)) <= 1e-5
                    for i, di in zip(got, d[ids >= 0])))


def compare(pairs, deng, seng, probes: dict) -> tuple[int, int]:
    """(mismatches, oracle violations) over every ticket: an answer must
    equal the single-device one (ids exact, distances within 1e-5, update
    acks equal), and every distributed query answer is also held to
    :func:`oracle_live` (``probes``: ticket -> the query vector and the
    oracle state it probed)."""
    mism = bad = 0
    for td, ts in pairs:
        a, b = deng.result(td), seng.result(ts)
        if isinstance(b, str):
            assert a == b, (td, a, b)
            continue
        if td in probes:
            bad += not oracle_live(a, *probes[td])
        if not (np.array_equal(a[0], b[0])
                and np.allclose(a[1], b[1], atol=1e-5)):
            mism += 1
    return mism, bad


def run_trace(mesh, cold: bool, ordering: str, seed: int, n_ops: int):
    """The reference child's trace (``tests/_dist_stream_child.py``):
    duplicate-id re-inserts of live ids, delete-then-reinsert, update
    storms and forced seal / merge epochs, through both engines."""
    deng, seng, vec = engines(mesh, cold, ordering)
    deng.warmup()
    rng = np.random.default_rng(seed)
    ver, live, pairs = {}, set(), []
    probes, waiting = {}, []        # query ticket -> (q, oracle state)
    n_live_reinserts = 0

    def state():
        return {i: vec(i, ver[i]) for i in live}

    def flush():
        deng.flush(), seng.flush()
        # window: a query probes the state after its window's updates
        snap = state()
        for td, q in waiting:
            probes[td] = (q, snap)
        waiting.clear()

    if cold:
        # insert pressure until the rings spill into the cold chains
        for nxt in range(1000, 1000 + 24 * 16):
            ver[nxt] = 1
            pairs.append((deng.insert(nxt, vec(nxt, 1)),
                          seng.insert(nxt, vec(nxt, 1))))
            live.add(nxt)
            if nxt % 16 == 15:
                flush()
    for _ in range(n_ops):
        kind = rng.choice(5, p=[.3, .3, .15, .15, .1])
        i = int(rng.integers(0, 96))
        if kind == 0 and live:
            j = sorted(live)[int(rng.integers(0, len(live)))]
            q = vec(j, ver[j]) + rng.normal(size=(DIM,)).astype(
                np.float32) * 0.05
            pairs.append((deng.query(q, k=5), seng.query(q, k=5)))
            if ordering == "strict":
                probes[pairs[-1][0]] = (q, state())
            else:
                waiting.append((pairs[-1][0], q))
        elif kind == 1:
            ver[i] = ver.get(i, 0) + 1        # duplicate-id re-inserts
            n_live_reinserts += i in live
            pairs.append((deng.insert(i, vec(i, ver[i])),
                          seng.insert(i, vec(i, ver[i]))))
            live.add(i)
        elif kind == 2 and live:
            j = sorted(live)[int(rng.integers(0, len(live)))]
            pairs.append((deng.delete(j), seng.delete(j)))
            live.discard(j)                   # delete-then-reinsert later
        elif kind == 3 and live:
            j = sorted(live)[int(rng.integers(0, len(live)))]
            for _ in range(int(rng.integers(1, 4))):   # update storms
                ver[j] += 1
                pairs.append((deng.update(j, vec(j, ver[j])),
                              seng.update(j, vec(j, ver[j]))))
        elif kind == 4:
            # forced epochs mid-stream, applied to both
            flush()
            if rng.random() < 0.5:
                deng.seal(), seng.seal()
            else:
                deng.merge(), seng.merge()
        if rng.random() < 0.12:
            flush()
    flush()
    dst, sst = deng.stats(), seng.stats()
    mism, bad = compare(pairs, deng, seng, probes)
    rec = {"checked": len(pairs), "queries": len(probes),
           "mismatches": mism, "oracle_violations": bad,
           "live_reinserts": n_live_reinserts,
           "query_candidate_drops":
               deng.backend.stats()["query_candidate_drops"],
           "seals": [dst["seals"], sst["seals"]],
           "merges": [dst["merges"], sst["merges"]],
           "spills": [dst["spills"], sst["spills"]],
           "readbacks_per_round": steady_readbacks(deng)}
    if cold:
        rec["cold_segments"] = dst["cold"]["cold_segments"]
        rec["incomplete"] = dst["cold"]["incomplete_query_rounds"]
    return rec


def stale_entries(mesh, cold: bool) -> dict:
    """Ids inserted, sealed, re-inserted live with a new vector, sealed
    and merged (a cold merge with a cold tier).  One device's table-wide
    merge keeps only the newer LSH entry of each (table, id); where the
    two versions' trees sit on different shards, each shard would keep
    its own, and a query at the older vector would find the id on the
    distributed engine alone, unless the shards agree on the fold's
    survivors (``distributed.agree_fold``).  Queries at every older
    vector."""
    deng, seng, vec = engines(mesh, cold)
    deng.warmup()
    ids = list(range(500, 564))
    for v in (1, 2):
        for i in ids:
            deng.insert(i, vec(i, v)), seng.insert(i, vec(i, v))
        deng.flush(), seng.flush()
        deng.seal(), seng.seal()
    deng.merge(), seng.merge()
    snap = {i: vec(i, 2) for i in ids}
    pairs, probes = [], {}
    for i in ids:
        q = vec(i, 1)
        pairs.append((deng.query(q, k=5), seng.query(q, k=5)))
        probes[pairs[-1][0]] = (q, snap)
    deng.flush(), seng.flush()
    mism, bad = compare(pairs, deng, seng, probes)
    return {"queries": len(pairs), "mismatches": mism,
            "oracle_violations": bad}


def live_reinsert(mesh, cold: bool) -> dict:
    """Ids 0..47 inserted, then each re-inserted live once with a new
    vector (with a cold tier, after fresh inserts have spilled the
    ring); queries at every older vector before a forced seal, after it
    and after a merge.  ``stale`` counts, per stage and engine, answers
    that rank the id at its older vector's distance."""
    deng, seng, vec = engines(mesh, cold)
    deng.warmup()
    snap, nxt = {}, 1000
    while cold and min(deng.stats()["spills"], seng.stats()["spills"]) < 1:
        for _ in range(16):
            snap[nxt] = vec(nxt, 1)
            deng.insert(nxt, snap[nxt]), seng.insert(nxt, snap[nxt])
            nxt += 1
        deng.flush(), seng.flush()
        assert nxt < 4000, "no spill"
    ids = list(range(48))
    for v in (1, 2):
        for i in ids:
            deng.insert(i, vec(i, v)), seng.insert(i, vec(i, v))
        deng.flush(), seng.flush()
    snap.update({i: vec(i, 2) for i in ids})
    out = {"queries": 0, "mismatches": 0, "oracle_violations": 0,
           "stale": []}
    for stage in ("before_seal", "after_seal", "after_merge"):
        if stage == "after_seal":
            deng.seal(), seng.seal()
        elif stage == "after_merge":
            deng.merge(), seng.merge()
        pairs, probes = [], {}
        for i in ids:
            q = vec(i, 1)
            pairs.append((deng.query(q, k=5), seng.query(q, k=5)))
            probes[pairs[-1][0]] = (q, snap)
        answers = (deng.flush(), seng.flush())
        stale = [0, 0]
        for i, tickets in zip(ids, pairs):
            for e, t in enumerate(tickets):
                got, d = answers[e][t]
                # the query is the older vector: its distance is 0
                stale[e] += int((np.abs(d[got == i]) <= 1e-5).any())
        mism, bad = compare(pairs, deng, seng, probes)
        out["queries"] += len(pairs)
        out["mismatches"] += mism
        out["oracle_violations"] += bad
        out["stale"].append(stale)
    return out


def cold_compaction_epochs(mesh) -> dict:
    """Ids inserted and pushed into the cold chains by fresh inserts,
    then updated to a new vector (fewer than ``max_tombstones``, so no
    merge drops the older entries) and pushed on until a cold compaction
    folds one engine's chains and not yet the other's: the distributed
    backend compacts every shard's chain synchronously once any routing
    table passes its watermark, the single device folds its per-table
    chains on a background thread and installs the fold at a later
    round.  While the two engines' compaction counts differ, queries at
    every older vector, each engine's answers held to the dict +
    linear-scan oracle (each id live, once, at its newest vector's
    distance).  ``found_older`` counts, per engine, the answers that
    hold the queried id."""
    deng, seng, vec = engines(mesh, cold=True)
    deng.warmup()
    ids = list(range(200, 224))
    snap, nxt = {}, 1000

    def fill(until):
        nonlocal nxt
        for _ in range(200):
            if until():
                return
            for _ in range(16):
                snap[nxt] = vec(nxt, 1)
                deng.insert(nxt, snap[nxt]), seng.insert(nxt, snap[nxt])
                nxt += 1
            deng.flush(), seng.flush()
        raise AssertionError("the trace never reached its state")

    def compactions():
        return [sum(ev == "cold_compact" for ev in e.backend.maintenance_log)
                for e in (deng, seng)]

    for i in ids:
        snap[i] = vec(i, 1)
        deng.insert(i, snap[i]), seng.insert(i, snap[i])
    deng.flush(), seng.flush()
    fill(lambda: min(deng.stats()["spills"], seng.stats()["spills"]) >= 2)
    spilled = [deng.stats()["spills"], seng.stats()["spills"]]
    for i in ids:
        snap[i] = vec(i, 2)
        deng.update(i, snap[i]), seng.update(i, snap[i])
    deng.flush(), seng.flush()
    fill(lambda: compactions()[0] != compactions()[1])
    counts = compactions()
    asked = [(i, vec(i, 1)) for i in ids]
    tickets = [(deng.query(q, k=5), seng.query(q, k=5)) for _, q in asked]
    deng.flush(), seng.flush()
    bad, found, mism = [0, 0], [0, 0], 0
    for (i, q), (td, ts) in zip(asked, tickets):
        got = deng.result(td), seng.result(ts)
        for e, a in enumerate(got):
            bad[e] += not oracle_live(a, q, snap)
            found[e] += int(i in a[0].tolist())
        mism += not (np.array_equal(got[0][0], got[1][0])
                     and np.allclose(got[0][1], got[1][1], atol=1e-5))
    return {"queries": len(asked), "spills_before_update": spilled,
            "compactions": counts, "oracle_violations": bad,
            "found_older": found, "mismatches": mism,
            "merges": [deng.stats()["merges"], seng.stats()["merges"]],
            "spills": [deng.stats()["spills"], seng.stats()["spills"]]}


def steady_readbacks(deng) -> list:
    """[rounds, readbacks] of one steady-state insert flush."""
    for i in range(16):
        deng.insert(3000 + i, unit_vec(3000 + i, 1, DIM))
    deng.flush()
    for i in range(16):
        deng.insert(3100 + i, unit_vec(3100 + i, 1, DIM))
    st0 = deng.stats()
    deng.flush()
    st1 = deng.stats()
    return [st1["rounds"] - st0["rounds"], st1["readbacks"] - st0["readbacks"]]


def big_ids(mesh) -> dict:
    """Ids past 2^24 through the routing payloads, held against a dict +
    linear-scan oracle: a self-query finds the id at distance ~0 and
    every reported distance is the true one; after the deletes no query
    reports them."""
    deng, _, vec = engines(mesh, cold=False)
    store = {}
    for j, b in enumerate(BIG_IDS):
        store[b] = vec(b, 1)
        deng.insert(b, store[b])
    for j in range(40):                       # neighbours to rank against
        store[j] = vec(j, 1)
        deng.insert(j, store[j])
    deng.flush()
    found = 0
    for b in BIG_IDS:
        t = deng.query(store[b], k=5)
        ids, d = deng.flush()[t]
        assert int(ids[0]) == b and float(d[0]) < 1e-5, (b, ids, d)
        for vid, dist_ in zip(ids[ids >= 0], d[ids >= 0]):
            x = store[int(vid)]
            true = 1.0 - float(store[b] @ x) / float(
                np.linalg.norm(store[b]) * np.linalg.norm(x))
            assert abs(true - float(dist_)) < 1e-4, (vid, dist_, true)
        found += 1
    for b in BIG_IDS:
        deng.delete(b)
    deng.flush()
    for b in BIG_IDS:
        t = deng.query(store[b], k=5)
        ids, _ = deng.flush()[t]
        assert not set(ids.tolist()) & set(BIG_IDS), ids
    return {"found": found}


def checkpoint(mesh, ckpt: str) -> dict:
    """Save a spilled cold engine, restore into a fresh one on other
    segment files: same answers, same cold layout; a backend of another
    n_model refuses the checkpoint."""
    deng, _, vec = engines(mesh, cold=True, ckpt=ckpt)
    nxt = 1000
    for _ in range(40):
        for _ in range(16):
            deng.insert(nxt, vec(nxt, 1))
            nxt += 1
        deng.flush()
    probes = [1000, 1100, 1200, nxt - 1]
    want = {}
    for p in probes:
        t = deng.query(vec(p, 1), k=5)
        want[p] = deng.flush()[t]
    path = save_dist_checkpoint(os.path.join(ckpt, "ck"), 3, deng.backend)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert len(man["extra"]["cold_manifests"]) == mesh.n_model
    cfg = config(True)
    scfg = StreamConfig(max_batch=16, min_batch=16, default_k=5)
    deng2 = DistStreamEngine(DistConfig(pfo=cfg, n_model=mesh.n_model), mesh,
                             scfg, seed=1,
                             cold_dir=os.path.join(ckpt, "cold2"))
    load_dist_checkpoint(os.path.join(ckpt, "ck"), 3, deng2.backend)
    assert deng2.backend.n_inserted == deng.backend.n_inserted
    segs = deng.stats()["cold"]["cold_segments"]
    assert deng2.stats()["cold"]["cold_segments"] == segs >= 1, (
        segs, deng.stats()["spills"])
    for p in probes:
        t = deng2.query(vec(p, 1), k=5)
        ids, d = deng2.flush()[t]
        np.testing.assert_array_equal(ids, want[p][0])
        np.testing.assert_allclose(d, want[p][1], atol=1e-5)
    other = DistStreamEngine(DistConfig(pfo=cfg, n_model=2),
                             stream_mesh(2, 2, device="cpu"), scfg)
    try:
        load_dist_checkpoint(os.path.join(ckpt, "ck"), 3, other.backend)
    except ValueError:
        refused = True
    else:
        refused = False
    assert refused
    return {"cold_segments": segs, "probes": len(probes)}


def main():
    rank, world, store_file, ckpt = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for grid in ((1, 4), (2, 2)):
            mesh = stream_mesh(grid[1], grid[0], device="cpu")
            name = f"{grid[0]}x{grid[1]}"
            out[f"hot_{name}"] = run_trace(mesh, False, "window", 11, 120)
            out[f"cold_{name}"] = run_trace(mesh, True, "window", 7, 100)
        mesh = stream_mesh(4, 1, device="cpu")
        out["strict_1x4"] = run_trace(mesh, False, "strict", 12, 80)
        out["stale_entries"] = stale_entries(mesh, cold=False)
        out["stale_entries_cold"] = stale_entries(mesh, cold=True)
        out["live_reinsert"] = live_reinsert(mesh, cold=False)
        out["live_reinsert_cold"] = live_reinsert(mesh, cold=True)
        out["cold_compaction_epochs"] = cold_compaction_epochs(mesh)
        out["big_ids"] = big_ids(mesh)
        out["checkpoint"] = checkpoint(mesh, ckpt)
        print("TORCH_DIST_RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
