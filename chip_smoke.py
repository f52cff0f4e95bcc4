"""Drive the PyTorch port of PFO on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

1. the card (``nvidia-smi`` name and power limit) and the build of the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. a seeded trace at a small size, run twice: on the CPU through the
   kernels' plain versions and on the card through the kernels.  Ids,
   flag words, logs, stats, sync counts and every integer leaf of the
   state must be equal, distances within 1e-5;
3. the main path at a realistic size: ``PFOIndex.insert / query /
   delete`` on data shaped like ann-benchmarks' glove-100-angular
   (clustered unit vectors, d = 100, made from ``--seed``), with the
   kernel launch counts set to 0 just before and read just after;
4. each kernel against its plain version on the card, at the shapes the
   main path gave it, with its time, the plain version's time, one
   PyTorch library call's time and the least time the card could take
   (the bound);
5. the last line: ``{"ok": true, "device": {...}}``.

Everything worth keeping is printed as one JSON object per line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.core import PFOConfig, PFOIndex  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.gather_rank import gather_rank_cuda  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
MARGIN = 1e-4            # |projection| below this may flip a hash bit
DIST_TOL = 1e-5          # distances, card vs CPU trace
RANK_TOL = 2e-5          # gather_rank kernel vs plain (reference tolerance)
GLOVE_ROWS = 1_183_514   # glove-100-angular's train rows ...
ITEMS = 1_000_000        # ... cut so that a merge's one 2^20 segment holds all
QUERIES = 1024           # k = 10, half self-queries, half fresh vectors
DELETES = 4096           # enough to fill the tombstone buffer and merge
DEVICE = "cuda"


def emit(**kw):
    print(json.dumps(kw), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def main_config() -> PFOConfig:
    return PFOConfig(dim=100, max_nodes_per_tree=512,
                     max_leaves_per_tree=4096, main_max_nodes_per_tree=1024,
                     main_max_leaves_per_tree=16384, store_capacity=1 << 20)


def clustered(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """Clustered unit vectors (~20 members a cluster), made on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((max(1, n // 20), dim), generator=g, device=device)
    centers = centers / centers.norm(dim=1, keepdim=True)
    which = torch.randint(0, centers.shape[0], (n,), generator=g,
                          device=device)
    x = centers[which] + 0.5 / dim ** 0.5 * torch.randn(
        (n, dim), generator=g, device=device)
    return x / x.norm(dim=1, keepdim=True)


_L2_FLUSH = None


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` in ms, from CUDA events around each
    launch, with the 50 MB L2 cache flushed before each: the main path
    finds its inputs cold (a query's store rows were last touched rounds
    ago), so a warm L2 would flatter every contender."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        _L2_FLUSH.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: host wall time (the profiler
    adds to it), the time the card spent in kernels (one stream, so no
    overlap is double counted),
    the idle share and the five kernels with the most device time.  The
    device numbers are None where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel events only: an operator's own row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return dict(wall_ms=wall, device_busy_ms=busy if events else None,
                idle_share=1 - busy / wall if events else None,
                kernels=[dict(name=e.key[:60], count=e.count,
                              ms=e.self_device_time_total / 1e3)
                         for e in top])


def clone_state(x):
    """A copy of an index state (NamedTuples and dicts of tensors): the
    index updates its state in place."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_state(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*map(clone_state, x))
    return x


def bound_ms(n_bytes: float, flops: float):
    tb, tf = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


# ----------------------------------------------------------------------
# phase 2: the same seeded trace on the CPU and on the card
# ----------------------------------------------------------------------
def small_config() -> PFOConfig:
    return PFOConfig(dim=16, L=3, C=2, m=2, l=16, t=4, max_nodes_per_tree=64,
                     max_leaves_per_tree=128, main_m=3,
                     main_max_nodes_per_tree=128,
                     main_max_leaves_per_tree=1024, store_capacity=8192,
                     max_candidates_per_probe=16, max_candidates_total=192,
                     max_snapshots=3, max_tombstones=64, bloom_bits=1 << 12,
                     snap_prefix_bits=8, snap_budget_per_probe=16)


def safe_vectors(proj, cfg, n, seed):
    """Seeded unit vectors whose table and partition projections all lie
    >= MARGIN from zero in float64, so the two float summation orders
    cannot hash them differently."""
    rng = np.random.default_rng(seed)
    table = proj["table_proj"].double().numpy()
    part = proj["part_proj"].double().numpy()
    out = []
    while len(out) < n:
        x = rng.normal(size=(4 * n, cfg.dim)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        p = x.astype(np.float64) @ table
        bits = np.where(p >= 0, 1.0, -1.0).reshape(len(x), cfg.L, 32)
        pp = np.einsum("nlm,lmc->nlc", bits, part)
        ok = (np.abs(p).min(1) >= MARGIN) & (np.abs(pp).min((1, 2)) >= MARGIN)
        out.extend(x[ok])
    return np.stack(out[:n])


def run_trace(device, proj, cfg, vecs):
    idx = PFOIndex(cfg, device=device, proj=proj)
    ids = np.arange(len(vecs), dtype=np.int32)
    answers = []
    for s in range(0, 2400, 300):
        idx.insert(ids[s:s + 300], vecs[s:s + 300])
    answers.append(idx.query(vecs[:64], 10))
    dead = ids[:2400:40]
    for s in range(0, len(dead), 30):
        idx.delete(dead[s:s + 30])
    answers.append(idx.query(vecs[:2400:40], 10))
    idx.insert(dead[::2], vecs[:2400:40][::2])
    idx.update(ids[1:60:2], vecs[2400:2430])
    answers.append(idx.query(vecs[2400:2430], 5))
    check((answers[-1][0][:, 0] == ids[1:60:2]).all(),
          f"{device}: an updated id did not return itself first")
    host = dict(flags=idx._flags, rounds=idx.rounds_log,
                maint=idx.maintenance_log, stats=idx.stats(),
                syncs=idx.sync_count)
    return answers, host, convert.state_to_numpy(idx.state)


def phase_trace(seed: int):
    cfg = small_config()
    proj = PFOIndex(cfg, seed=seed, device="cpu").state.proj
    vecs = safe_vectors(proj, cfg, 2430, seed)
    t0 = time.perf_counter()
    cpu = run_trace("cpu", proj, cfg, vecs)
    t1 = time.perf_counter()
    gpu = run_trace(DEVICE, proj, cfg, vecs)
    t2 = time.perf_counter()
    check(cpu[1] == gpu[1], f"host state differs: {cpu[1]} vs {gpu[1]}")
    check(cpu[1]["maint"].count("seal") >= 2 and "merge" in cpu[1]["maint"],
          "trace must seal twice and merge")
    max_d = 0.0
    for (ci, cd), (gi, gd) in zip(cpu[0], gpu[0]):
        check(np.array_equal(ci, gi), "query ids differ, card vs CPU")
        fin = np.isfinite(cd)
        check(np.array_equal(fin, np.isfinite(gd)), "inf pattern differs")
        if fin.any():
            max_d = max(max_d, float(np.abs(cd[fin] - gd[fin]).max()))
    check(max_d <= DIST_TOL, f"distance error {max_d} > {DIST_TOL}")
    n_int = 0
    for part in ("lsh_forest", "main_forest", "store", "lsh_snaps",
                 "main_snaps"):
        for name, a in cpu[2][part].items():
            b = gpu[2][part][name]
            if a.dtype.kind == "f":
                check(np.allclose(a, b, rtol=0, atol=DIST_TOL),
                      f"{part}.{name}")
            else:
                check(np.array_equal(a, b), f"{part}.{name} differs")
                n_int += 1
    emit(phase="trace", equal=True, integer_leaves=n_int, max_dist_err=max_d,
         maintenance=cpu[1]["maint"], cpu_s=t1 - t0, gpu_s=t2 - t1)


# ----------------------------------------------------------------------
# phase 3: the main path at a realistic size
# ----------------------------------------------------------------------
def exact_topk(store: torch.Tensor, q: torch.Tensor, k: int):
    """Exact angular kNN over the whole store, in row chunks."""
    qn = q / q.norm(dim=1, keepdim=True)
    best_d = torch.full((q.shape[0], k), float("inf"), device=q.device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                        device=q.device)
    for s in range(0, store.shape[0], 1 << 18):
        x = store[s:s + (1 << 18)]
        d = 1.0 - qn @ (x / x.norm(dim=1, keepdim=True).clamp_min(1e-9)).T
        d, i = torch.topk(torch.cat([best_d, d], 1), k, dim=1, largest=False)
        best_i = torch.cat([best_i, torch.arange(s, s + x.shape[0],
                                                 device=q.device)
                            .expand(q.shape[0], -1)], 1).gather(1, i)
        best_d = d
    return best_i, best_d


def phase_main(args):
    cfg = main_config()
    dev = torch.device(DEVICE)
    n, batch = ITEMS, 4096
    data = clustered(n + QUERIES, cfg.dim, args.seed, dev)
    vecs, fresh = data[:n], data[n:]
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    ids = torch.randperm(n, generator=g, device=dev).to(torch.int32)

    idx = PFOIndex(cfg, seed=args.seed, device=dev)
    probes = [0]
    real_round_flags = index_mod.round_flags

    def counted_round_flags(*a, **kw):
        probes[0] += 1
        return real_round_flags(*a, **kw)

    index_mod.round_flags = counted_round_flags
    torch.cuda.synchronize()
    ops.reset_launches()                      # counts start here ...
    t0 = time.perf_counter()
    for b, s in enumerate(range(0, n, batch)):
        if s + batch >= n:                    # the last batch, traced
            profile = device_profile(lambda: idx.insert(
                ids[s:s + batch], vecs[s:s + batch]))
        else:
            idx.insert(ids[s:s + batch], vecs[s:s + batch])
        if b % 64 == 63:
            emit(phase="insert_progress", items=s + batch,
                 s=time.perf_counter() - t0,
                 maintenance=len(idx.maintenance_log))
    torch.cuda.synchronize()
    t_ins = time.perf_counter() - t0

    # queries: half self-queries of items still in the hot forests (the
    # tier whose candidates reach the ranking whole), half fresh vectors
    # from the same distribution
    nq = QUERIES
    tail = torch.arange(max(0, n - 4 * batch), n, device=dev)
    _, hot = index_mod.forest_lookup_masked(
        idx.state.main_forest, *reversed(index_mod.main_table_keys(
            ids[tail], cfg)), ids[tail], index_mod.main_tree_config(cfg))
    hot_rows = tail[hot] if bool(hot.any()) else tail
    pick = hot_rows[torch.randint(0, hot_rows.numel(), (nq // 2,),
                                  generator=g, device=dev)]
    q = torch.cat([vecs[pick], fresh[:nq - nq // 2]])
    torch.cuda.synchronize()
    before_q = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    got_ids, got_d = idx.query(q, 10)
    t_q = time.perf_counter() - t0
    q_launch = {k: ops.LAUNCHES[k] - before_q[k] for k in before_q}
    queried = clone_state(idx.state)           # the checks read it below

    dead_rows = torch.randperm(n, generator=g, device=dev)[:DELETES]
    dead = ids[dead_rows]
    t0 = time.perf_counter()
    del_rounds = idx.delete(dead)
    torch.cuda.synchronize()
    t_del = time.perf_counter() - t0
    after_ids, _ = idx.query(vecs[dead_rows[:nq]], 10)
    launches = dict(ops.LAUNCHES)              # ... and stop here
    index_mod.round_flags = real_round_flags

    # checks of what came out
    check(got_ids.shape == (nq, 10) and got_d.shape == (nq, 10),
          "query output shape")
    check(np.array_equal(got_ids >= 0, np.isfinite(got_d)),
          "an answered id without a finite distance, or the reverse")
    check((np.diff(np.where(np.isfinite(got_d), got_d, 9.0), axis=1)
           >= 0).all(), "distances not sorted")
    # A self-query returns itself at rank 0 unless its id was cut before
    # ranking: the reference's dedupe keeps the max_candidates_total
    # smallest candidate ids, so the cut can only drop an id larger than
    # every id kept, from a full row.  Rebuilt from the state the query
    # read (after the launch counts were read).
    self_ids = ids[pick].cpu().numpy()
    _, cand = index_mod._hot_sealed_candidates(queried, q[: nq // 2], cfg)
    cids = index_mod._dedupe_candidates(cand, queried.tombstones,
                                        cfg).cpu().numpy()
    del queried
    rank0 = got_ids[: nq // 2, 0] == self_ids
    miss = ~rank0
    check((cids[miss] >= 0).all() and (self_ids[miss]
                                       > cids[miss].max(1)).all(),
          "a self-query missed rank 0 without its id being cut by the "
          "ranking budget")
    in_cand = (cids == self_ids[:, None]).any(1)
    n_cand = float((cids >= 0).sum(1).mean())
    check(np.abs(got_d[: nq // 2][rank0, 0]).max(initial=0) <= 1e-5,
          "self distance not 0")
    dead_np = dead.cpu().numpy()
    check(not np.isin(after_ids, dead_np).any(), "a deleted id came back")
    check(launches["lsh_hash"] > 0 and launches["gather_rank"] > 0,
          f"a kernel of the path was never launched: {launches}")
    n_rounds = sum(idx.rounds_log) + del_rounds
    check(idx.sync_count == n_rounds + probes[0],
          f"sync_count {idx.sync_count} != rounds {n_rounds} + probes "
          f"{probes[0]}")
    check(idx.stats()["overflow_events"] == 0, "arena overflow")
    check("merge" in idx.maintenance_log, "deletes did not drive a merge")

    # recall@10 against an exact search of the live store contents
    truth_rows, _ = exact_topk(vecs, q, 10)
    truth = ids[truth_rows].cpu().numpy()
    recall = float(np.mean([len(set(got_ids[i]) & set(truth[i])) / 10
                            for i in range(nq)]))
    fresh_recall = float(np.mean([len(set(got_ids[i]) & set(truth[i])) / 10
                                  for i in range(nq // 2, nq)]))
    emit(phase="main_path", items=n, dim=cfg.dim,
         reduced=[f"items {GLOVE_ROWS} -> {n}: a merge keeps one segment "
                  "of 2^20 entries"],
         insert_batch=batch, insert_s=t_ins, inserts_per_s=n / t_ins,
         insert_rounds=sum(idx.rounds_log), insert_calls=len(idx.rounds_log),
         seals=idx.maintenance_log.count("seal"),
         merges=idx.maintenance_log.count("merge"),
         queries=nq, query_s=t_q, queries_per_s=nq / t_q,
         recall_at_10=recall, recall_at_10_fresh=fresh_recall,
         self_rank0_rate=float(rank0.mean()),
         fresh_answered_rate=float((got_ids[nq // 2:, 0] >= 0).mean()),
         self_in_candidates_rate=float(in_cand.mean()),
         self_candidates_per_query=n_cand,
         deletes=int(dead.numel()), delete_rounds=del_rounds,
         delete_s=t_del, sync_count=idx.sync_count, flag_probes=probes[0],
         launches=launches,
         query_launches=q_launch,
         stats=idx.stats(),
         last_insert_profile=profile,
         maintenance=idx.maintenance_log)
    return idx, q, launches


# ----------------------------------------------------------------------
# phase 4: each kernel against its plain version, timed, with its bound
# ----------------------------------------------------------------------
def phase_kernels(idx, q, launches):
    cfg, st = idx.cfg, idx.state
    rows = []

    # lsh_hash at the insert batch's shape: (4096, d) x (d, L*32)
    x = clustered(4096, cfg.dim, 12345, q.device)
    a = st.proj["table_proj"].contiguous()
    n, d = x.shape
    p = a.shape[1]
    words = p // 32
    got = ops.lsh_hash(x, a)
    plain = ref.ref_lsh_hash(x, a)
    proj64 = x.double() @ a.double()
    near = (proj64.abs() < MARGIN).reshape(n, words, 32)
    shifts = torch.arange(31, -1, -1, device=x.device)
    diff = (((got ^ plain)[..., None] >> shifts) & 1).bool()
    truth = ((((proj64 >= 0).reshape(n, words, 32).long()
               << shifts).sum(-1) ^ got)[..., None] >> shifts) & 1
    far_flips = int((diff & ~near).sum()) + int((truth.bool() & ~near).sum())
    near_flips = int((diff & near).sum())
    check(far_flips == 0, f"lsh_hash: {far_flips} bit flips away from zero")
    out = torch.empty((n, words), dtype=torch.int32, device=x.device)
    fn = _build.load("lsh_hash")
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(lambda: fn(x.data_ptr(), a.data_ptr(), out.data_ptr(), n, d,
                            words, stream))
    b_ms, b_by = bound_ms(4 * (n * d + d * p + n * words), 2 * n * d * p)
    rows.append(dict(
        name="lsh_hash", route="cuda",
        source="src/repro_torch/kernels/csrc/lsh_hash.cu",
        replaces="src/repro/kernels/lsh_hash.py:64",
        launches=launches["lsh_hash"], max_abs_err=far_flips,
        near_zero_flips=near_flips, shape=[n, d, p],
        ms=ms, plain_ms=cuda_ms(lambda: ref.ref_lsh_hash(x, a)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(x, a))))

    # gather_rank at the query's shape, on the query's own candidates
    _, cand = index_mod._hot_sealed_candidates(st, q, cfg)
    cids = index_mod._dedupe_candidates(cand, st.tombstones, cfg)
    slot, found = index_mod._main_lookup(st, cids.reshape(-1), cfg)
    valid = (cids >= 0) & found.reshape(cids.shape) & (slot.reshape(
        cids.shape) >= 0)
    slots = torch.where(valid, slot.reshape(cids.shape), 0).to(torch.int32)
    store = st.store.data
    got = ops.gather_rank(q, store, slots, valid, cfg.metric)
    plain = ref.ref_gather_rank(q, store, slots, valid, cfg.metric)
    check(torch.equal(torch.isinf(got), torch.isinf(plain)),
          "gather_rank: +inf pattern differs")
    fin = torch.isfinite(plain)
    err = float((got[fin] - plain[fin]).abs().max()) if fin.any() else 0.0
    torch.testing.assert_close(got, plain, rtol=RANK_TOL, atol=RANK_TOL)
    qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)
    nq, c = slots.shape
    n_valid = int(valid.sum())
    n_rows = int(torch.unique(slots[valid]).numel())   # store rows needed
    ms = cuda_ms(lambda: gather_rank_cuda(qn, store, slots, valid, True))
    b_ms, b_by = bound_ms(4 * (nq * d + n_rows * d + 2 * nq * c) + nq * c,
                          4 * n_valid * d)
    block = store[slots.long()]                       # (Q, C, d) gathered
    rows.append(dict(
        name="gather_rank", route="cuda",
        source="src/repro_torch/kernels/csrc/gather_rank.cu",
        replaces="src/repro/kernels/gather_rank.py:112",
        launches=launches["gather_rank"], max_abs_err=err,
        shape=[nq, c, d], valid_candidates=n_valid, distinct_rows=n_rows,
        ms=ms, plain_ms=cuda_ms(lambda: ref.ref_gather_rank(
            q, store, slots, valid, cfg.metric)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.bmm(block, qn[:, :, None]))))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    t0 = time.perf_counter()
    build_s = _build.build()
    emit(phase="build", torch=torch.__version__, cuda=torch.version.cuda,
         card=card, nvcc_s=build_s, build_s=time.perf_counter() - t0)
    phase_trace(args.seed)
    idx, q, launches = phase_main(args)
    emit(kernels=phase_kernels(idx, q, launches))
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
