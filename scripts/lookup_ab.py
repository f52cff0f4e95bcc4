"""Time the index's two MainTable ring searches against each other.

    python3 scripts/lookup_ab.py            # one NVIDIA GPU

The index resolves an id to its store slot through the sealed MainTable
ring with ``snapshots.lookup_key_run`` (the run of entries whose key is
the id's hash).  The JAX package searches the key's prefix bucket
instead (``snapshots.lookup_exact``), which misses ids once a bucket
outgrows ``snap_budget_per_probe``.  This script swaps the search the
index calls and changes nothing else, in one process on one card:

* hot: ``chip_smoke.py``'s main-path index (500,000 glove-width items,
  built with the key-run search, the same seed and data); then queries
  (its 1024-query batch, k = 10), 16 insert calls of 4096 fresh items
  and one delete call of 4096 items, each timed for both searches in the
  order bucket, run, run, bucket, repeated.  Every insert and delete leg
  starts from the same copy of the state;
* cold: ``chip_smoke.py``'s cold-path config, built with the key-run
  search to ``--cold-items`` inserts with its churn (a third of the wave
  two back deleted); then its queries (cold-only self-queries and fresh
  vectors) in the same order, and insert waves with their churn deletes
  alternating bucket, run, run, bucket (the cold tier's host state
  cannot be copied, so the waves run on, each on the state the last
  left).

Each leg prints one JSON line; the last lines are a summary, the card's
name and power limit, and ``{"ok": true}``.  ``--device cpu`` with small
``--items`` checks the script itself on the CPU (shrink
``chip_smoke``'s cold config and counts first).
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import PFOIndex  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.core import snapshots  # noqa: E402

SEARCHES = {"bucket": snapshots.lookup_exact,
            "key_run": snapshots.lookup_key_run}
ORDER = ("bucket", "key_run", "key_run", "bucket")
INSERT_CALLS = 16          # insert calls of 4096 a hot leg
COLD_WAVES = 8             # cold insert waves a leg


def use(name: str) -> None:
    """Make the index call the named ring search."""
    snapshots.lookup_key_run = SEARCHES[name]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def clone(x):
    """A copy of an index state's tensors (NamedTuples, dicts, None)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(clone(v) for v in x))
    return x


def timed(dev, fn) -> float:
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def summary(times: dict, per: int) -> dict:
    """Per search: every reading (s), their median and the rate it gives
    (``per`` items a reading)."""
    return {k: dict(s=v, median_s=statistics.median(v),
                    per_s=per / statistics.median(v))
            for k, v in times.items()}


def query_ab(idx, q, reps: int, dev) -> dict:
    """Both searches on one state and one query batch, ``reps`` times in
    the order bucket, run, run, bucket."""
    answers = {}
    for name in SEARCHES:                      # warm both, keep answers
        use(name)
        answers[name] = idx.query(q, 10)
    times = {k: [] for k in SEARCHES}
    for _ in range(reps):
        for name in ORDER:
            use(name)
            times[name].append(timed(dev, lambda: idx.query(q, 10)))
    use("key_run")
    (bi, _), (ri, _) = answers["bucket"], answers["key_run"]
    return dict(queries=int(q.shape[0]), rates=summary(times, q.shape[0]),
                same_ids=bool((bi == ri).all()),
                rows_differing=int((bi != ri).any(1).sum()))


def hot_leg(args, dev) -> dict:
    cfg = cs.main_config()
    n, batch, nq = args.items, 4096, cs.QUERIES
    data = cs.clustered(n + nq, cfg.dim, args.seed, dev)
    vecs, fresh = data[:n], data[n:]
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    ids = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    idx = PFOIndex(cfg, seed=args.seed, device=dev)
    use("key_run")
    t_build = 0.0
    for b, s in enumerate(range(0, n, batch)):
        t_build += timed(dev, lambda: idx.insert(ids[s:s + batch],
                                                 vecs[s:s + batch]))
        if b % 32 == 31:
            cs.emit(phase="hot_build", items=s + batch, s=t_build)
    # chip_smoke.py's queries: half self-queries of items in the hot
    # forests, half fresh vectors
    tail = torch.arange(max(0, n - 4 * batch), n, device=dev)
    _, hot = index_mod.forest_lookup_masked(
        idx.state.main_forest, *reversed(index_mod.main_table_keys(
            ids[tail], cfg)), ids[tail], index_mod.main_tree_config(cfg))
    rows = tail[hot] if bool(hot.any()) else tail
    pick = rows[torch.randint(0, rows.numel(), (nq // 2,), generator=g,
                              device=dev)]
    q = torch.cat([vecs[pick], fresh[:nq - nq // 2]])
    out = dict(leg="hot", items=n, build_s=t_build,
               build_maintenance=list(idx.maintenance_log),
               query=query_ab(idx, q, args.query_reps, dev))

    # inserts and deletes, each leg from the same copy of the state
    saved = (clone(idx.state), idx._flags, idx._flags_caps)
    extra = cs.clustered(INSERT_CALLS * batch, cfg.dim, args.seed + 2, dev)
    new_ids = torch.arange(n, n + INSERT_CALLS * batch, dtype=torch.int32,
                           device=dev)
    dead = ids[torch.randperm(n, generator=g, device=dev)[:cs.DELETES]]

    def restore():
        idx.state = clone(saved[0])
        idx._flags, idx._flags_caps = saved[1], saved[2]
        idx.maintenance_log = []

    ins = {k: [] for k in SEARCHES}
    dels = {k: [] for k in SEARCHES}
    events = {k: [] for k in SEARCHES}
    tombstoned = {}
    for _ in range(args.reps):
        for name in ORDER:
            use(name)
            restore()
            t = 0.0
            for c in range(INSERT_CALLS):
                rows = slice(c * batch, (c + 1) * batch)
                t += timed(dev, lambda: idx.insert(new_ids[rows],
                                                   extra[rows]))
            ins[name].append(t)
            events[name].append(list(idx.maintenance_log))
            restore()
            dels[name].append(timed(dev, lambda: idx.delete(dead)))
            tombstoned[name] = int(idx.state.n_tombstones)
    use("key_run")
    restore()
    out.update(inserts=dict(calls=INSERT_CALLS, batch=batch,
                            rates=summary(ins, INSERT_CALLS * batch),
                            maintenance=events),
               deletes=dict(ids=int(dead.numel()),
                            rates=summary(dels, dead.numel()),
                            tombstones_after=tombstoned))
    return out


def cold_leg(args, dev) -> dict:
    cfg = cs.cold_config()
    n, wave, nq = args.cold_items, cs.COLD_WAVE, cs.QUERIES
    total = n + args.reps * len(ORDER) * COLD_WAVES * wave
    data = cs.clustered(total + nq, cfg.dim, args.seed + 7, dev)
    vecs, fresh = data[:total], data[total:]
    g = torch.Generator(device=dev).manual_seed(args.seed + 8)
    ids = torch.randperm(total, generator=g, device=dev).to(torch.int32)
    alive = torch.ones(total, dtype=torch.bool, device=dev)
    tmp = tempfile.TemporaryDirectory()
    idx = PFOIndex(cfg, seed=args.seed, device=dev, cold_dir=tmp.name)
    use("key_run")
    t_ins, t_del = {k: [] for k in SEARCHES}, {k: [] for k in SEARCHES}

    def insert_wave(w: int, name: str | None) -> None:
        rows = slice(w * wave, (w + 1) * wave)
        ti = timed(dev, lambda: idx.insert(ids[rows], vecs[rows]))
        td = 0.0
        if w >= 2:             # churn: a third of the wave two back
            gone = slice((w - 2) * wave, (w - 2) * wave + wave // 3)
            td = timed(dev, lambda: idx.delete(ids[gone]))
            alive[gone] = False
        if name is not None:
            t_ins[name][-1] += ti
            t_del[name][-1] += td

    t_build = timed(dev, lambda: [insert_wave(w, None)
                                  for w in range(n // wave)])
    w = n // wave
    # chip_smoke.py's queries: self-queries of items that live only in
    # cold segments, and fresh vectors
    live_rows = alive[:w * wave].nonzero().squeeze(1)
    early = live_rows[live_rows < w * wave // 4]
    early = early[torch.randperm(early.numel(), generator=g,
                                 device=dev)[:8 * nq]]
    _, hot_or_ring = index_mod._main_lookup(idx.state, ids[early], cfg)
    cold_rows = early[~hot_or_ring][:nq // 2]
    q = torch.cat([vecs[cold_rows], fresh[:nq - cold_rows.numel()]])
    out = dict(leg="cold", items=w * wave, build_s=t_build,
               cold_only_self_queries=int(cold_rows.numel()),
               build_maintenance={m: idx.maintenance_log.count(m) for m in (
                   "seal", "spill", "merge", "cold_compact")},
               query=query_ab(idx, q, args.query_reps, dev))
    for _ in range(args.reps):
        for name in ORDER:
            use(name)
            t_ins[name].append(0.0)
            t_del[name].append(0.0)
            for _ in range(COLD_WAVES):
                insert_wave(w, name)
                w += 1
    use("key_run")
    log = idx.maintenance_log
    out.update(inserts=dict(waves=COLD_WAVES, wave=wave,
                            rates=summary(t_ins, COLD_WAVES * wave)),
               churn_deletes=dict(rates=summary(t_del,
                                                COLD_WAVES * (wave // 3))),
               maintenance={m: log.count(m) for m in (
                   "seal", "spill", "merge", "cold_compact")})
    idx.cold._discard_worker()
    del idx
    tmp.cleanup()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--items", type=int, default=cs.ITEMS)
    ap.add_argument("--cold-items", type=int, default=500_000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--query-reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-cold", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    card = "not a card"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("lookup_ab: no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
            else "unknown"
        cs.emit(phase="build", build_s=cs._build.build())
    legs = [hot_leg(args, dev)]
    cs.emit(**legs[-1])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if not args.skip_cold:
        legs.append(cold_leg(args, dev))
        cs.emit(**legs[-1])
    cs.emit(summary={
        f"{leg['leg']}_{what}_per_s": {k: v["per_s"] for k, v in
                                       leg[what]["rates"].items()}
        for leg in legs for what in ("query", "inserts", "deletes",
                                     "churn_deletes") if what in leg})
    print(card, flush=True)
    cs.emit(ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
