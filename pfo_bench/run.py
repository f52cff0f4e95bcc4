"""One run of one cell of the benchmark of ``repro_torch``.

    python3 pfo_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

From the root of a checkout, on a machine with a CUDA card.  One run:

1. set-up (``setup_s``): imports, CUDA, the deployment's vectors made on
   the card from its configuration's ``data_seed``, the prefill through
   ``PFOIndex.insert``, a seal epoch where the prefill did not seal the
   hot forests into the ring, ``StreamEngine`` and its warm-up, the
   traffic's first ``WARM + generator.CHUNK`` windows made from the
   seed, ``WARM`` windows of it run, and a merge epoch if those held none;
2. the window: a closed loop that submits one window of requests
   through the engine, calls ``flush``, and goes on to the next until
   ``--seconds`` of serving have passed; the next ``generator.CHUNK``
   windows are made between two flushes when the loop reaches their
   end, with the engine idle and the window's clock stopped; with
   ``--trace 1`` under the program's span tracer and a count of
   implicit syncs, and its first ``TRACE_SECONDS`` under the profiler;
3. the check (``correct``): every request answered or acknowledged; one
   more flush, through the served path, of exact self-queries of ids
   the window wrote and of other live ids (each has to come back unless
   the ranking budget can have cut it) and of deleted ids' last
   vectors; then, with the program's state freed, the plain reference
   (``reference/window_knn.py``) replays every window and judges each
   answer of the window and of that flush;
4. the result: one JSON line on standard output, its last key
   ``checks``, each compared number beside its limit, and the same
   numbers as the last lines on standard error.

``--control`` judges, in the program's place, the reference's own
answers computed with TF32 products: the control that has to come out
not correct.  Its result also holds, under ``program``, the readings of
the program's own answers in the same run.  Nothing here imports JAX or the JAX package; the run exits
non-zero, printing no result, if anything loaded them.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)
# compile caches at fixed paths inside the checkout (the kernels build
# into build/repro_torch/, repro_torch.kernels._build's own directory)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(REPO / "build" / "pfo_bench" / _sub)
# one host thread for the CPU math libraries: the run is host-bound, and
# idle worker threads spinning beside the launching thread add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
WARM = 2                 # windows of the cell's traffic run in set-up
WRITTEN_CHECK = 2048     # self-queries of ids the window wrote, after it
LIVE_CHECK = 1024        # self-queries of live ids after the window
DEAD_CHECK = 256         # queries of deleted ids' last vectors
SYNC_WARNING = "synchronizing CUDA operation"
TRACE_SECONDS = 10       # the profiler's part of a traced window


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    from pfo_bench import spec
    bench = spec.load_benchmark()
    cell = spec.cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", control=args.control)
    found = forbidden_modules()
    if found:
        print(f"loaded modules of JAX or the JAX package: {found}",
              file=sys.stderr)
        return 3
    for name, (value, limit) in result["checks"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def merged(base: dict, over: dict | None) -> dict:
    """``base`` with ``over``'s keys (nested dicts merged) in place."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


class Stream:
    """Submits the traffic's windows to the engine, as a closed-loop
    client: a window's requests, then ``flush``."""

    def __init__(self, eng, traffic):
        self.eng, self.t = eng, traffic

    def window(self, w: int):
        """Window ``w``; returns (its tickets, flush's {ticket: result})."""
        t, W = self.t, self.t.window
        s = slice(w * W, (w + 1) * W)
        eng, vecs, n, k = self.eng, t.host, t.n_prefill, t.k
        tickets = []
        for kd, key, row in zip(t.kind[s].tolist(), t.key[s].tolist(),
                                t.row[s].tolist()):
            if kd == 0:
                tickets.append(eng.query(vecs[row - n], k))
            elif kd == 1:
                tickets.append(eng.insert(key, vecs[row - n]))
            elif kd == 2:
                tickets.append(eng.delete(key))
            else:
                tickets.append(eng.update(key, vecs[row - n]))
        return tickets, eng.flush()


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str, control: bool = False, cfg_over=None,
             mix_over=None, limits=None) -> dict:
    """One run of ``cell``; returns the result line's dict.  The
    ``*_over`` dicts and ``limits`` replace parts of the cell's files
    (the CPU tests run small copies of a cell)."""
    import numpy as np
    import torch
    from pfo_bench import data, generator, spec
    from pfo_bench.reference.window_knn import Replay
    from repro_torch.core.config import PFOConfig
    from repro_torch.core.index import PFOIndex
    from repro_torch.obs import Obs
    from repro_torch.serving.stream import StreamConfig, StreamEngine

    cfg = merged(spec.config_of(bench, cell["config"]), cfg_over)
    mix = merged(spec.traffic_of(cell["traffic"]), mix_over)
    limits = limits or spec.limits_of(cell["name"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # -- set-up -------------------------------------------------------
    pcfg = PFOConfig(dim=cfg["dim"], metric=cfg["metric"], **cfg["index"])
    n = cfg["rows"]
    # the deployment's rows and its index's projections are the
    # configuration's own (its ``data_seed``), as a dataset file would be;
    # ``seed`` draws the traffic over them
    base = data.base_vectors(cfg, n, cfg["data_seed"], dev)
    idx = PFOIndex(pcfg, seed=cfg["data_seed"], device=dev)
    batch = cfg["prefill_batch"]
    for s in range(0, n, batch):
        e = min(n, s + batch)
        idx.insert(torch.arange(s, e, dtype=torch.int32, device=dev),
                   base[s:e])
    eng = StreamEngine(idx, StreamConfig(**cfg["stream"]))
    forced_seal = "seal" not in idx.maintenance_log
    if forced_seal:
        # the window's queries are to read the sealed ring; a program
        # that fills its trees differently may not seal in the prefill
        eng.seal()
    eng.warmup()
    traffic = generator.Traffic(mix, cfg, base, seed).extend(
        WARM + generator.CHUNK)
    stream = Stream(eng, traffic)
    for w in range(WARM):
        stream.window(w)
    if not any(ev == "merge" for ev, _ in eng.events):
        eng.merge()
    sync()
    # what set-up left stays out of the collector's later passes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T_START

    # -- the window ---------------------------------------------------
    from repro_torch.kernels import ops
    rec = None
    if trace:
        rec = Recorder(ops, dev)
        eng.set_obs(Obs(metrics=True, trace=True, trace_capacity=1 << 22,
                        profiler_annotations=True))
    before = eng.stats()
    windows = []
    with (rec.window() if rec else contextlib.nullcontext()):
        t0 = time.perf_counter()
        making = 0.0              # seconds spent making traffic, not served
        w = WARM
        while True:
            if w == traffic.n_windows:
                # between two flushes, the engine idle: off the clock
                sync()
                m0 = time.perf_counter()
                traffic.extend(generator.CHUNK)
                sync()
                making += time.perf_counter() - m0
            windows.append(stream.window(w))
            w += 1
            served = time.perf_counter() - t0 - making
            if rec is not None and served >= TRACE_SECONDS:
                rec.pause()
            if served >= seconds:
                break
        sync()
        elapsed = time.perf_counter() - t0 - making
    after = eng.stats()
    n_win = w
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # -- the check, program side: answers, acknowledgements, self-queries
    W = traffic.window
    unanswered = 0
    answers = []                  # per measured window: (pos, ids, dists)
    for i, (tickets, out) in enumerate(windows):
        s = (WARM + i) * W
        kinds = traffic.kind[s:s + W]
        q_pos, q_ids, q_d = [], [], []
        for j, (tk, kd) in enumerate(zip(tickets, kinds)):
            res = out.get(tk)
            if kd != 0:
                unanswered += res != "ok"
            elif isinstance(res, tuple) and len(res) == 2:
                q_pos.append(s + j)
                q_ids.append(np.asarray(res[0], np.int64))
                q_d.append(np.asarray(res[1], np.float32))
            else:
                unanswered += 1
        answers.append((np.asarray(q_pos, np.int64), _stack(q_ids, traffic.k),
                        _stack(q_d, traffic.k, np.float32)))
    attempted = len(windows) * W

    # each id's current and last version after the windows, by the
    # reference's replay of their writes
    final = Replay(traffic.table, n, n + n_win * W, cfg["metric"])
    for w in range(n_win):
        s = slice(w * W, (w + 1) * W)
        final.apply(traffic.kind[s], traffic.key[s], traffic.row[s])
    cur, last = final.row_of.cpu().numpy(), final.last_of.cpu().numpy()
    del final
    measured = slice(WARM * W, n_win * W)
    written = np.unique(traffic.key[measured][np.isin(
        traffic.kind[measured], (generator.INSERT, generator.UPDATE))])
    rng = np.random.default_rng(seed + 2)
    live = np.flatnonzero(cur >= 0)
    dead = np.flatnonzero((cur < 0) & (last >= 0))
    check_written = rng.permutation(written[cur[written] >= 0])[
        :WRITTEN_CHECK]
    check_live = rng.choice(live, min(live.size, LIVE_CHECK), replace=False)
    check_dead = rng.choice(dead, min(dead.size, DEAD_CHECK), replace=False)
    check_self = np.concatenate([check_written, check_live,
                                 np.full(check_dead.size, -1)])
    check_rows = np.concatenate([cur[check_written], cur[check_live],
                                 last[check_dead]])
    tab = traffic.table[torch.as_tensor(check_rows, device=dev)].cpu().numpy()
    tickets = [eng.query(v, traffic.k) for v in tab]
    out = eng.flush()
    c_ids, c_d = [], []
    for tk in tickets:
        res = out.get(tk)
        if not (isinstance(res, tuple) and len(res) == 2):
            unanswered += 1
            res = (np.full(traffic.k, -1), np.full(traffic.k, np.inf))
        c_ids.append(np.asarray(res[0], np.int64))
        c_d.append(np.asarray(res[1], np.float32))
    check_ans = (_stack(c_ids, traffic.k), _stack(c_d, traffic.k, np.float32))

    run = dict(windows=len(windows), requests=attempted, seconds=elapsed,
               setup_s=setup_s, before=before, after=after,
               forced_seal=forced_seal)
    if rec is not None:
        run.update(rec.reduce(eng))
    del eng, idx, stream
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check, reference side ----------------------------------
    replay = Replay(traffic.table, n, n + n_win * W, cfg["metric"])
    tot = dict(malformed=0, dead=0, dist_gap=0.0, self_missing=0,
               self_absent=0)
    # with ``control``, the program's own answers are judged beside it,
    # so one run reads both
    own = dict(tot)
    hits = n_q = 0
    n_self = int((check_self >= 0).sum())

    def add(r: dict, into: dict = tot) -> None:
        for key in ("malformed", "dead", "self_missing", "self_absent"):
            into[key] += r[key]
        into["dist_gap"] = max(into["dist_gap"], r["dist_gap"])

    for w in range(n_win):
        s = slice(w * W, (w + 1) * W)
        replay.apply(traffic.kind[s], traffic.key[s], traffic.row[s])
        if w < WARM:
            continue
        pos, ids, dists = answers[w - WARM]
        if pos.size == 0:
            continue
        q_rows = traffic.row[pos]
        truth, _ = replay.knn(q_rows, traffic.k)
        selfk = np.where(traffic.self_query[pos], traffic.key[pos], -1)
        r = replay.judge(q_rows, selfk, ids, dists, truth)
        hits += r["hits"]
        n_q += pos.size
        n_self += int((selfk >= 0).sum())
        if control:
            add(r, own)
            ids, dists = replay.knn(q_rows, traffic.k, tf32=True)
            r = replay.judge(q_rows, selfk, ids, dists, None)
        add(r)
    if check_rows.size:
        ids, dists = check_ans
        if control:
            add(replay.judge(check_rows, check_self, ids, dists, None), own)
            ids, dists = replay.knn(check_rows, traffic.k, tf32=True)
        add(replay.judge(check_rows, check_self, ids, dists, None))
    run["recall_at_10"] = hits / max(1, n_q * traffic.k)
    run["queries"] = n_q

    checks = dict(unanswered=[unanswered, 0], malformed=[tot["malformed"], 0],
                  dead_ids=[tot["dead"], 0],
                  self_missing=[tot["self_missing"], 0],
                  dist_gap=[tot["dist_gap"], limits["dist_gap"]])
    correct = all(v <= lim for v, lim in checks.values())

    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], trace):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                    count=1, memory_peak_bytes=int(memory_peak))
    result = dict(correct=bool(correct), attempted=attempted,
                  failed=unanswered, metrics=metrics, device=dev_info)
    if trace and "busy_s" in run:
        dev_info.update(busy_s=run["busy_s"], window_s=run["window_s"])
        result["breakdown"] = dict(device_ops=run["device_ops"],
                                   idle_gaps=run["idle_gaps"])
    if trace:
        result["trace"] = {k: run.get(k) for k in (
            "forced_seal", "syncs", "spans_dropped", "lead_in_lost", "device_events",
            "ranges", "roofline", "reduce_s")}
    if control:
        result["program"] = own
    # self-queries answered without their own id, the ranking budget's
    # cuts among them: a reading beside the checks, not one of them
    result["self_queries"] = dict(
        asked=int(n_self), absent=(own if control else tot)["self_absent"])
    result["checks"] = checks
    return result


def _stack(rows: list, k: int, dtype=None):
    import numpy as np
    if not rows:
        return np.zeros((0, k), dtype or np.int64)
    return np.stack(rows).astype(dtype or np.int64)


class Recorder:
    """The traced run's instruments around the window: the profiler
    (on a card) and a ``record_function`` range around each call of
    ``ops.lsh_hash`` and ``ops.gather_rank`` with the work its inputs
    need, over the window's first ``TRACE_SECONDS`` (its traced part),
    and the syncs ``torch.cuda.set_sync_debug_mode("warn")`` reports
    over all of it."""

    def __init__(self, ops, dev):
        import torch
        self.ops, self.dev = ops, dev
        self.cuda = dev.type == "cuda"
        self.work = {"lsh_hash": [], "gather_rank": []}
        # per gather_rank call: distinct store rows named, valid candidates
        self.counts = torch.zeros((1024, 2), dtype=torch.int64, device=dev)
        self.mark = None
        self.caught: list = []
        self.prof = self.range = self.real = None

    def _wrap(self):
        import torch
        from torch.profiler import record_function
        real_h, real_g = self.ops.lsh_hash, self.ops.gather_rank
        rec = self

        def lsh_hash(x, table_proj, M=32):
            with record_function("pfo_bench.lsh_hash"):
                out = real_h(x, table_proj, M)
            rec.work["lsh_hash"].append((x.shape[0], x.shape[1],
                                         table_proj.shape[1]))
            return out

        def gather_rank(q, store, slots, valid, metric, staging=None):
            with record_function("pfo_bench.gather_rank"):
                out = real_g(q, store, slots, valid, metric, staging=staging)
            # distinct store rows the valid candidates name, counted on
            # the device (no sync inside the window)
            if rec.mark is None or rec.mark.numel() != store.shape[0]:
                rec.mark = torch.zeros(store.shape[0], dtype=torch.uint8,
                                       device=store.device)
            rec.mark.zero_()
            rec.mark.scatter_reduce_(0, slots.reshape(-1).long(),
                                     valid.reshape(-1).to(torch.uint8),
                                     reduce="amax")
            i = len(rec.work["gather_rank"])
            if i == rec.counts.shape[0]:
                rec.counts = torch.cat([rec.counts, torch.zeros_like(
                    rec.counts)])
            rec.counts[i, 0] = rec.mark.sum()
            rec.counts[i, 1] = valid.sum()
            rec.work["gather_rank"].append((q.shape[0], slots.shape[1],
                                            q.shape[1]))
            return out

        return (real_h, real_g), (lsh_hash, gather_rank)

    def pause(self) -> None:
        """Ends the traced part: the window's range closes, the profiler
        stops (between two of the window's flushes; its events are
        reduced after the window) and the kernel entries are the
        program's own again.  Pausing the profiler's collection instead
        loses every device event."""
        import torch
        if self.real is None:
            return
        self.ops.lsh_hash, self.ops.gather_rank = self.real
        self.real = None
        if self.prof is None:
            return
        mode = torch.cuda.get_sync_debug_mode()     # these syncs are ours
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(self.dev)
        self.range.__exit__(None, None, None)
        self.prof.stop()
        torch.cuda.set_sync_debug_mode(mode)

    def window(self):
        import torch
        from torch.profiler import record_function
        from pfo_bench import trace as trace_mod

        @contextlib.contextmanager
        def scope():
            self.real, (h, g) = self._wrap()
            self.ops.lsh_hash, self.ops.gather_rank = h, g
            if self.cuda:
                self.prof = trace_mod.start()
                self.range = record_function(trace_mod.WINDOW)
                self.range.__enter__()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if self.cuda:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    yield
                finally:
                    if self.cuda:
                        torch.cuda.set_sync_debug_mode(0)
                    self.pause()
            self.caught = caught

        return scope()

    def reduce(self, eng) -> dict:
        """The traced run's readings for the per-layer metrics."""
        from pfo_bench import roofline
        from pfo_bench import trace as trace_mod
        out = dict(spans=eng.obs.tracer.events(),
                   spans_dropped=eng.obs.tracer.dropped,
                   syncs=sum(SYNC_WARNING in str(w.message)
                             for w in self.caught) if self.cuda else None)
        if self.prof is None:
            return out
        t0 = time.perf_counter()
        red = trace_mod.reduce(self.prof)
        red["reduce_s"] = time.perf_counter() - t0
        self.prof = None
        least = {"lsh_hash": sum(roofline.bound_ms(*roofline.lsh_hash_work(
            *w))[0] for w in self.work["lsh_hash"]) / 1e3}
        calls = self.work["gather_rank"]
        counts = self.counts[:len(calls)].tolist()
        least["gather_rank"] = sum(roofline.bound_ms(
            *roofline.gather_rank_work(q, c, d, rows, valid))[0]
            for (q, c, d), (rows, valid) in zip(calls, counts)) / 1e3
        roof = {}
        for name, least_s in least.items():
            got = red["ranges"].get(name)
            if got and got["device_s"] > 0 and self.work[name]:
                roof[name] = dict(least_s=least_s, device_s=got["device_s"],
                                  calls=len(self.work[name]),
                                  kernels=got["kernels"])
        out.update(red, roofline=roof)
        return out


if __name__ == "__main__":
    sys.exit(main())
