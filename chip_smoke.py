"""Drive the PyTorch port of PFO on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

1. the card (``nvidia-smi`` name and power limit) and the build of the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. a seeded trace at a small size, run twice: on the CPU through the
   kernels' plain versions and on the card through the kernels.  Ids,
   flag words, logs, stats, sync counts and every integer leaf of the
   state must be equal, distances within 1e-5;
3. the same for a spilling cold-tier trace (spills, a cold merge, a
   compaction, deletes of cold-only ids), and on the card the trace
   through an all-device index whose ring never fills must answer
   bit-identically;
4. the stream engine on a small seeded stream (``stream_trace``): the
   same requests through ``StreamEngine`` on the CPU and on the card, in
   strict and in window ordering, on the hot trace config and on a
   spilling cold one; answers, acks, stats, flag counters, sync counts
   and every integer leaf equal, distances within 1e-5; and on the card
   a strict engine equal, bit for bit, to the same requests as
   ``PFOIndex`` calls;
5. the four example programs (``examples``), started after the build
   and run beside phases 2-4 (which time nothing), each started as a
   user starts it, ``python3 examples/<name>_torch.py``, in three lanes side
   by side: the quickstart (its own asserts), the streaming
   recommendation (recall@10 of each epoch held to the same program
   with ``--device cpu``, run beside it) and kNN-LM serving (the
   datastore grows by one memory a request), then the train example on
   the reduced config (300 steps: the loss falls); the train example at
   published width, 60 steps with checkpoints into ``build/``,
   then to 70, resuming from step 60 (every loss finite, near ln V;
   the parameters moving).  Each child runs the program as
   ``__main__`` under a runner that counts its launches from 0 and
   keeps the inputs of its heaviest call of each kernel; the launches
   join the kernel rows as ``examples``, and ``lsh_hash``,
   ``gather_rank`` and ``pair_dist`` are held against their plain
   versions and timed on those inputs;
6. the hot main path at a realistic size: ``PFOIndex.insert / query /
   delete`` on data shaped like ann-benchmarks' glove-100-angular
   (clustered unit vectors, d = 100, made from ``--seed``), with the
   kernel launch counts set to 0 just before and read just after, the
   inserts sealing the hot forests into the ring at least once; its
   recall@10 is measured against ``BruteForce`` (the ``pair_dist``
   kernel), whose ids are also held against the plain version's;
7. the stream engine on that index (``stream``): the streaming
   benchmark's 50/25/12.5/12.5 query/insert/delete/update mix in windows
   of 256 requests, 8,192 measured after a warm prefix, the counts set
   to 0 just before and read just after, every answer held to a
   window-mode oracle on the card; requests/s against the same stream as
   per-request ``PFOIndex`` calls, flush and request latencies, one flag
   readback per round, the syncs no one counted, a traced flush's idle
   share, and ``lsh_hash`` / ``gather_rank`` at the 256-row bucket;
8. checkpoints (``checkpoint``): ``save_index_checkpoint`` of that index
   into a temp dir and ``load_index_checkpoint`` on the card, every leaf
   equal and the 1,024 hot queries answered bit-identically (save and
   load seconds, bytes, the first restored query's ms); the small cold
   trace config with file-backed segments checkpointed (segments
   hardlinked) and restored with the same answers;
9. the distributed engine (``dist``) on a one-rank NCCL group: a
   ``DistStreamEngine`` and a ``StreamEngine`` on the card with the same
   projections get the same trace (8,192 inserts, then 4,096 requests of
   the stream mix in windows of 256, one forced seal, one forced merge)
   and answer alike; requests/s of both, readbacks, implicit syncs and
   collectives a round; a distributed checkpoint round trip;
10. the LM serving path (``lm``): reduced smollm_135m and qwen2_7b in
   f32 on the CPU and on the card (prefill and decode logits within
   1e-4, three rounds of the kNN-LM engine with equal tokens and equal
   datastore leaves); then smollm_135m at full width in bf16 (random
   weights from a seeded ``torch.Generator``) behind ``ServingEngine``
   with the PFO kNN-LM head on a ``StreamEngine``, over a datastore
   filled with 4,096 memories (the model's hidden states over
   ``SyntheticLM`` text -> the next token), the counts set to 0 just
   before the fill and read after the recall oracle: three rounds of
   four requests, decode == forward, the greedy tokens with the head
   off, the kNN log-probs recomputed on the host, the online memories'
   self-hits, recall@8 against ``BruteForce``; fill rate, prefill and
   decode-step ms (the engine's CUDA-event clock), readbacks and
   implicit syncs; then the path's kernels on the inputs tapped from it
   at d = 576 (``lsh_hash`` on the first fill call and the first kNN
   query, ``gather_rank`` on that query, ``pair_dist`` on the recall
   oracle), each held against its plain version and timed, with its
   bound (the kernel rows' ``lm`` entries and ``lm_oracle``);
11. training (``train``), which launches none of the six kernels:
   (a) reduced smollm_135m and llama4_scout_17b_a16e in f32, the same
   init and ``SyntheticLM`` batches, five ``make_train_step`` steps on
   the CPU and on the card: losses and grad norms at every step and the
   final params within 1e-4, the MoE routing (expert ids, kept pairs)
   equal; (b) smollm_135m at its published widths through ``Trainer``
   (f32 params and master, bf16 compute, batch 8 x 1,024 tokens cycling
   4 ``SyntheticLM`` batches, loss chunks of 512, remat, AdamW lr 6e-4
   with 5 warmup steps): 20 steps
   uninterrupted, then 10 steps, a checkpoint, and a resumed run to 20;
   the loss falls, the restored state equals the saved one bit for bit
   and the resumed losses lie within 1e-3 of the uninterrupted ones; step
   ms (CUDA events), tokens/s, checkpoint seconds and bytes, peak
   memory, launches and implicit syncs a step, a profiled step's idle
   share; (c) llama4_scout_17b_a16e at its published widths with its
   depth cut to one repeat of its 4-block pattern (4 of 48 layers, ~22
   GB of bf16 weights from a generator on the card): prefill of 4 x 64
   tokens and 16 decode steps, decode == forward within 3e-2 (relative
   in norm) at every position whose row was routed alike up to it, and
   every routing difference at a near tie of the router's bf16 logits;
   no pair dropped at decode, tokens per expert, and the pairs one 4 x
   256-token prefill drops by capacity;
12. the remaining block kinds (``families``): (a) reduced
   deepseek_v2_236b (MLA + MoE), rwkv6_7b, recurrentgemma_9b (RG-LRU
   with local attention) and whisper_medium (encoder + cross-attention)
   in f32, their zero-init leaves drawn (std 0.1), on the CPU and on the
   card: forward, prefill and decode logits and every cache and state
   tensor within 1e-4, one train step's loss and grad norm within 1e-4;
   (b) each at its published widths (deepseek_v2 cut to its dense layer
   0 and one MoE layer, 2 of 60), bf16 weights from a seeded generator on
   the card, behind ``ServingEngine`` with the PFO kNN-LM head over a
   datastore of 1,024 of its own hidden states (one insert call, the
   ``lm`` phase's index config at its d_model): two rounds of 4
   requests, prompt 64 (whisper with 1,500 frames), 16 new tokens,
   lambda 0.3, k 8; prefill and decode-step ms, decode == forward within
   3e-2 (relative in norm; deepseek at 4 x 20 tokens, where no pair
   drops, on positions routed alike), launches a decode step, peak
   memory; its kNN head's ``lsh_hash`` and ``gather_rank`` at its
   d_model counted, held against their plain versions and timed (the
   kernel rows' ``families`` entries);
13. the LM stack's sharding (``sharded``) on a one-rank NCCL DeviceMesh
   ``(data, model)`` = (1, 1), where every rule of the policy resolves
   to a replicated placement (the same code as a larger mesh): (a)
   smollm_135m at published widths in f32 behind ``ServingEngine(policy=
   make_policy(mesh, cfg, "serve"))`` with the kNN-LM head over 1,024 of
   its own states, one round of 4 requests (prompt 16, 16 new) against
   the unsharded engine on the same params: every step's logits within
   1e-5 (relative in norm), the tokens equal, the head's ``lsh_hash``
   and ``gather_rank`` counted (set to 0 just before the sharded round,
   read after: ``launches_by_path["sharded"]``); then both engines in
   bf16, decode-step ms p50 / p99 (DTensor's host cost); (b)
   smollm_135m through ``Trainer(policy=)``, 3 steps against 3 unsharded
   steps from the same state, every leaf within 1e-5, the sharded
   checkpoint restored bit-equal into an unsharded ``Trainer``; (c)
   llama4_scout_17b_a16e at published widths, 4 of 48 layers, f32, a
   4 x 64 prefill through ``moe_impl="gspmd"`` whose every MoE block's
   input is run again through ``moe_apply_shardmap`` (all_to_all over
   the mesh's ``model`` group): rows whose pairs all survived within
   1e-5, the dropped rows those the reference's ``cap2`` drops
   (recounted by the plain CPU routing of the same block), and the whole
   prefill with ``moe_impl="shardmap"``; (d) the dry-run's
   ``llama4_scout_17b_a16e decode_32k`` cell at full width on the fake
   16 x 16 world, in a subprocess on the host beside (a)-(c);
14. the paper's comparators on the hot path's own items and queries
   (``baselines``): ``ZOrderIndex`` and ``MultiProbeFlat`` inserted and
   queried beside PFO's answer, each with recall@10 and Eq. 1's error
   ratio against ``BruteForce``; ``SerializedPFO`` against a dispatched
   ``PFOIndex`` on 500 vectors, its forest equal on the CPU and on the
   card; counts set to 0 just before each comparator and read just
   after;
15. the cold path at glove-100 width: 800,000 inserts with churn into
   an index whose store holds a third of them, spilling to file-backed
   segments; queries of cold-only items and deletes of them, counts set
   to 0 just before and read just after;
16. each kernel against its plain version on the card, at the shapes its
   path gave it, with its time, the plain version's time, one PyTorch
   library call's time and the least time the card could take (the
   bound): the larger of the bytes the call must move over the memory
   rate and its operations over the fastest fp32-accurate rate the card
   has, FFMA (67 TFLOP/s) or 3xTF32 on the dense TF32 tensor cores (3 x
   the operations at 495 TFLOP/s), whichever route the kernel took, so
   one rule reads every row.  Every row also gives its kernel's device
   time as ``torch.profiler`` records it (``kernel_ms``), a second
   witness beside the events; ``pair_dist`` is held and timed at both of
   its launches (hot and cold oracles), ``rank_dots`` at both of its
   launch shapes (ZOrderIndex's block and MultiProbeFlat's first query
   step), ``hamming`` through its wrapper, range check included, and
   ``lsh_hash`` and ``gather_rank`` also at the stream's 256-row bucket
   (``stream_bucket``, with their launches by path);
17. the kernels line, the card's name and power limit, then the last
    line: ``{"ok": true, "device": {...}}``.

Everything worth keeping is printed as one JSON object per line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    load_dist_checkpoint, load_index_checkpoint, save_dist_checkpoint,
    save_index_checkpoint)
from repro_torch.checkpoint.ckpt import (  # noqa: E402
    _read_leaf, _step_dir, flatten_with_paths, read_manifest)
from repro_torch.core import DistConfig  # noqa: E402
from repro_torch.core import distributed as dist_mod  # noqa: E402
from repro_torch.core import PFOConfig, PFOIndex  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.core.baselines import (  # noqa: E402
    BruteForce, MultiProbeFlat, SerializedPFO, ZOrderIndex)
from repro_torch.core.lsh import region_ids  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.gather_rank import (  # noqa: E402
    gather_rank_cuda, gather_rank_staged_cuda)
from repro_torch.kernels.hamming import hamming_cuda  # noqa: E402
from repro_torch.kernels.lsh_hash import lsh_hash_cuda  # noqa: E402
from repro_torch.kernels.pair_dist import pair_dist_cuda  # noqa: E402
from repro_torch.kernels.rank_candidates import rank_dots_cuda  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    GROUP_KEYS, param_dict)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.obs import Obs  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    DistStreamEngine, ServeConfig, ServingEngine, StreamConfig, StreamEngine,
    drive)
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.sharding import stream_mesh  # noqa: E402
from repro_torch.train import TrainConfig, Trainer, make_train_step  # noqa
from repro_torch.train import loop as train_loop  # noqa: E402

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bytes/s, fp32
# FLOP/s outside the tensor cores and dense TF32 FLOP/s on them.  A bound
# counts operations at the faster fp32-accurate route: FFMA, or 3xTF32
# (three TF32 products per fp32 one) on the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
MARGIN = 1e-4            # |projection| below this may flip a hash bit
FLIP_SIGMAS = 16         # ... or below this many fp32 rounding units (at
#                          large d; see hash_flips)
DIST_TOL = 1e-5          # distances, card vs CPU trace
RANK_TOL = 2e-5          # gather_rank, rank_dots vs plain (the reference)
PAIR_TOL = 1e-4          # pair_dist vs plain (reference tolerance)
TIE_TOL = 1e-5           # oracle ids may differ only across a near-tie
GLOVE_ROWS = 1_183_514   # glove-100-angular's train rows ...
ITEMS = 192_000          # ... cut for the hot path, to leave time for the cold
QUERIES = 1024           # k = 10, half self-queries, half fresh vectors
QUERY_REPS = 7           # timed repeats of the hot path's query call
DELETES = 4096           # enough to fill the tombstone buffer and merge
COLD_ITEMS = 800_000     # the cold path's inserts (cut for time), in waves
#                          of COLD_WAVE
COLD_WAVE = 4096
FIG7_ITEMS = 500         # paper_figs.fig7's n (3000, cut for time)
FIG7_CHECK = 300         # the prefix whose forest is held CPU vs card
HAMMING_KEYS = 1 << 18   # stored keys the hamming row ranks against
DEVICE = "cuda"
SPIN_CYCLES = 100_000    # ~50 us of device spin before each timed call
LEAD_IN = 256            # spins that open each profiler session
GATHER_DESIGN = "compacted-lane-groups"   # gather_rank.cu since PR 16
DOTS_DESIGN = "lane-group-row-stream"     # rank_dots.cu
HAMMING_DESIGN = "int8-mma-bitcount"      # hamming.cu
L2_POOL_ROWS = 20_000    # gather_rank's L2-resident yardstick


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
FLUSH_KERNEL = "FillFunctor<unsigned char>"   # the name of l2_flush's kernel


def l2_flush() -> None:
    """Evict the card's 50 MB L2 by writing (``zero_()``) a 64 MB buffer."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    _L2_FLUSH.zero_()


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of one ``fn()`` in ms, from CUDA events around each
    launch, with the 50 MB L2 cache flushed before each: the main path
    finds its inputs cold (a query's store rows were last touched rounds
    ago), so a warm L2 would flatter every contender.  A device spin
    after the flush keeps the card busy while the host enqueues the
    events and the call, so the interval holds the call's device time and
    not the host's Python time (a wrapper's ~20 us of Python would
    otherwise show in a 10 us kernel's time)."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for e0, e1 in ev:
        l2_flush()
        torch.cuda._sleep(SPIN_CYCLES)
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return sum(e0.elapsed_time(e1) for e0, e1 in ev) / iters


def kernel_ms(fn, iters: int = 20, tries: int = 3, only: str = ""):
    """Mean device time, in ms, of the kernels one ``fn()`` launches (those
    whose name holds ``only``), as ``torch.profiler`` records them, with
    the L2 flushed before each call as in :func:`cuda_ms` (the flush's
    own kernel is left out).  A witness beside cuda_ms that owes nothing
    to its events or its spin: it sums the kernels' own durations, so
    neither host time nor the gaps between a call's launches enter it.
    A session that comes back short (now and then one comes back empty)
    is run again, up to ``tries`` sessions; None where none handed back
    every call's kernels."""
    from torch.profiler import ProfilerActivity, profile
    l2_flush()
    for _ in range(3):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_in()
            for _ in range(iters):
                l2_flush()
                fn()
            torch.cuda.synchronize()
        flushes = kernels = ns = 0
        for e in device_events(prof)[0]:
            if FLUSH_KERNEL in e.name():
                flushes += 1
            elif only in e.name():
                kernels += 1
                ns += e.duration_ns()
        if flushes == iters and kernels and kernels % iters == 0:
            return ns / iters / 1e6
    return None


def lead_in() -> None:
    """LEAD_IN one-cycle device spins to open a profiler session.  Once
    one session has run, the profiler drops the first device events of
    each later one, more as the run goes on (PERF.md section 7); these
    absorb that loss, and their kernel (``spin_kernel``) is never one a
    measured call launches."""
    for _ in range(LEAD_IN):
        torch.cuda._sleep(1)


def device_events(prof):
    """The device events of a profiler session, but the lead-in's, and
    how many lead-in events the profiler dropped."""
    events, spins = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if "spin_kernel" in e.name():
            spins += 1
        else:
            events.append(e)
    return events, LEAD_IN - spins


def paired_ms(kernel, library, iters: int = 20):
    """A kernel and its library call timed in turns (kernel, library,
    library, kernel), each the mean of its two turns, after one untimed
    turn of each, so a card whose clock is still rising, or a busier
    neighbour, weighs on both alike."""
    cuda_ms(kernel, iters), cuda_ms(library, iters)
    k1, l1 = cuda_ms(kernel, iters), cuda_ms(library, iters)
    l2, k2 = cuda_ms(library, iters), cuda_ms(kernel, iters)
    return (k1 + k2) / 2, (l1 + l2) / 2


def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: host wall time (the profiler
    adds to it), the time the card spent in kernels and copies (one
    stream, so no overlap is double counted), the idle share and the
    five kernels with the most device time.  The raw device events are
    summed directly: the profiler's own event tree takes tens of seconds
    to build for a call of ~10^5 operators.  The device numbers are None
    where the profiler saw no device activity; ``lead_in_lost`` says how
    many of the session's first events it dropped (:func:`lead_in`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead_in()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events, lost = device_events(prof)
    per = {}                                   # name -> [count, ms]
    for e in events:
        acc = per.setdefault(e.name(), [0, 0.0])
        acc[0] += 1
        acc[1] += e.duration_ns() / 1e6
    busy = sum(ms for _, ms in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][1])[:5]
    return dict(wall_ms=wall, device_busy_ms=busy if per else None,
                idle_share=1 - busy / wall if per else None,
                launches=len(events), lead_in_lost=lost,
                kernels=[dict(name=name[:60], count=n, ms=ms)
                         for name, (n, ms) in top])


@contextlib.contextmanager
def tapped(module, name: str, keep):
    """Within the block, ``module.name`` hands its arguments to
    ``keep(*args, **kw)`` before it runs: a measurement reads a kernel's
    inputs from the path itself instead of rebuilding them."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        keep(*args, **kw)
        return real(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def tap_ranking(fn):
    """Run ``fn()`` with the query path's ranking inputs captured from
    ``index._rank_candidates``.  Returns fn's result, its wall seconds
    and copies (the index updates its tensors in place) of the inputs of
    the last ranking it ran, the one that gave the answer: ``cids, qvecs,
    store, staging, slots, valid``."""
    seen = []

    def keep(state, qvecs, cids, slot, found, cfg, k, staging=None):
        valid = (cids >= 0) & found & (slot >= 0)
        seen.append(dict(cids=cids, qvecs=qvecs, store=state.store.data,
                         staging=staging, slots=torch.where(valid, slot, 0),
                         valid=valid))

    with tapped(index_mod, "_rank_candidates", keep):
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
    return out, secs, {k: None if v is None else v.clone()
                       for k, v in seen[-1].items()}


def bound_ms(n_bytes: float, flops: float):
    """The least time for a call: the larger of its bytes over the memory
    rate and its fp32 operations over the faster fp32-accurate route."""
    tb = n_bytes / PEAK_BYTES * 1e3
    tf = min(flops / PEAK_FP32, 3 * flops / PEAK_TF32) * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def cut_criterion(self_ids, got_ids, cids) -> np.ndarray:
    """Self-queries that miss rank 0 although the ranking budget did not
    cut their id: the dedupe keeps the max_candidates_total smallest ids,
    so a cut leaves a full row of kept ids all smaller than the self id."""
    miss = got_ids[:, 0] != self_ids
    cut = (cids >= 0).all(1) & (self_ids > cids.max(1))
    return miss & ~cut


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


def safe_rows(x: np.ndarray, proj, cfg) -> np.ndarray:
    """Rows whose table and partition projections all lie >= MARGIN from
    zero in float64, so the two float summation orders cannot hash them
    differently."""
    table = proj["table_proj"].double().cpu().numpy()
    part = proj["part_proj"].double().cpu().numpy()
    p = x.astype(np.float64) @ table
    bits = np.where(p >= 0, 1.0, -1.0).reshape(len(x), cfg.L, 32)
    pp = np.einsum("nlm,lmc->nlc", bits, part)
    return (np.abs(p).min(1) >= MARGIN) & (np.abs(pp).min((1, 2)) >= MARGIN)


def safe_vectors(proj, cfg, n, seed):
    """Seeded unit vectors that hash alike on the CPU and on the card."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        x = rng.normal(size=(4 * n, cfg.dim)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        out.extend(x[safe_rows(x, proj, cfg)])
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
    n_int, max_d = compare_traces(cpu, gpu, "trace")
    check(cpu[1]["maint"].count("seal") >= 2 and "merge" in cpu[1]["maint"],
          "trace must seal twice and merge")
    emit(phase="trace", equal=True, integer_leaves=n_int, max_dist_err=max_d,
         maintenance=cpu[1]["maint"], cpu_s=t1 - t0, gpu_s=t2 - t1)


def compare_traces(cpu, gpu, what: str):
    """Answers, host state and every leaf of two runs of one trace: ids,
    flags, logs, stats and integer leaves equal, floats within DIST_TOL.
    Returns (integer leaves compared, max distance error)."""
    check(cpu[1] == gpu[1], f"{what}: host state differs: {cpu[1]} vs "
          f"{gpu[1]}")
    max_d = 0.0
    for (ci, cd), (gi, gd) in zip(cpu[0], gpu[0]):
        check(np.array_equal(ci, gi), f"{what}: query ids differ")
        fin = np.isfinite(cd)
        check(np.array_equal(fin, np.isfinite(gd)),
              f"{what}: inf pattern differs")
        if fin.any():
            max_d = max(max_d, float(np.abs(cd[fin] - gd[fin]).max()))
    check(max_d <= DIST_TOL, f"{what}: distance error {max_d} > {DIST_TOL}")
    n_int = 0

    def leaves(a, b, name):
        nonlocal n_int
        if isinstance(a, dict):
            for k in a:
                leaves(a[k], b[k], f"{name}.{k}")
        elif a is None:
            check(b is None, f"{what}: {name} differs")
        elif a.dtype.kind == "f":
            check(np.allclose(a, b, rtol=0, atol=DIST_TOL),
                  f"{what}: {name} differs")
        else:
            check(np.array_equal(a, b), f"{what}: {name} differs")
            n_int += 1

    for part in ("lsh_forest", "main_forest", "store", "lsh_snaps",
                 "main_snaps", "tombstones", "n_tombstones", "stamp", "cold"):
        leaves(cpu[2][part], gpu[2][part], part)
    return n_int, max_d


# ----------------------------------------------------------------------
# phase 3: a spilling cold-tier trace, CPU vs card vs all-device
# ----------------------------------------------------------------------
def cold_trace_config(**kw) -> PFOConfig:
    """The small arenas of the cold tier's own tests (seals every few
    hundred inserts, a ring of 3); a probe budget every bucket span fits,
    so a fold (merge, compaction) changes no answer."""
    base = dict(dim=16, L=3, C=2, m=2, l=16, t=4, max_nodes_per_tree=48,
                max_leaves_per_tree=64, main_m=3, main_max_nodes_per_tree=128,
                main_max_leaves_per_tree=512, store_capacity=8192,
                max_candidates_per_probe=16, max_candidates_total=192,
                snap_prefix_bits=8, snap_budget_per_probe=64, max_snapshots=3,
                max_tombstones=128, cold_segments=24, cold_cache_slots=96,
                cold_fetch_rounds=8)
    base.update(kw)
    return PFOConfig(**base)


def run_cold_trace(device, proj, cfg, vecs, cold_dir):
    """Waves of inserts with churn, an explicit background compaction,
    deletes of cold-only ids, queries between.  Returns (answers, host
    state, state leaves, compaction-and-delete facts)."""
    idx = PFOIndex(cfg, device=device, proj=proj, cold_dir=cold_dir)
    wave = 400
    ids = np.arange(len(vecs), dtype=np.int32)
    answers = []
    for w in range(6):
        idx.insert(ids[w * wave:(w + 1) * wave], vecs[w * wave:(w + 1) * wave])
        if w >= 1:                                # churn: the wave before
            idx.delete(ids[(w - 1) * wave:(w - 1) * wave + wave // 4])
        if w in (2, 5):
            answers.append(idx.query(vecs[w * 37:w * 37 + 64], 10))
    facts = {}
    if idx.cold is not None:      # the all-device index has no cold tier
        check(idx.cold.compact_start_async(), f"{device}: no compaction")
        idx.cold._worker.join()                   # deterministic install
        idx.state = idx.cold.compact_maybe_install(idx.state)
        facts["compactions"] = idx.cold.counters["compactions"]
    answers.append(idx.query(vecs[1000:1064], 10))
    # ids of wave 0 not deleted yet live only in cold segments, and the
    # compaction flushed the cache: the delete misses, fetches, retries
    cold_only = ids[wave // 4:wave // 4 + 100]
    facts["cold_delete_rounds"] = idx.delete(cold_only)
    answers.append(idx.query(vecs[wave // 4:wave // 4 + 64], 10))
    check(not np.isin(answers[-1][0], cold_only).any(),
          f"{device}: a deleted cold-only id came back")
    answers.append(idx.query(vecs[2000:2064], 10))
    host = dict(flags=idx._flags, rounds=idx.rounds_log,
                maint=idx.maintenance_log, stats=idx.stats(),
                syncs=idx.sync_count)
    return answers, host, convert.state_to_numpy(idx.state), facts


def phase_cold_trace(seed: int):
    cfg = cold_trace_config()
    proj = PFOIndex(cfg, seed=seed, device="cpu").state.proj
    vecs = safe_vectors(proj, cfg, 2400, seed + 1)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cpu = run_cold_trace("cpu", proj, cfg, vecs, f"{tmp}/cpu")
        t1 = time.perf_counter()
        ops.reset_launches()
        gpu = run_cold_trace(DEVICE, proj, cfg, vecs, f"{tmp}/gpu")
        launches = dict(ops.LAUNCHES)
        t2 = time.perf_counter()
    n_int, max_d = compare_traces(cpu[:3], gpu[:3], "cold trace")
    check(cpu[3] == gpu[3], f"cold trace facts differ: {cpu[3]} {gpu[3]}")
    c = gpu[1]["stats"]["cold"]
    check(c["segments_spilled"] >= 2 and c["cold_merges"] >= 1
          and gpu[3]["compactions"] == 1 and gpu[3]["cold_delete_rounds"] >= 2,
          f"cold trace must spill twice, merge, compact and miss on a "
          f"cold-only delete: {c} {gpu[3]}")
    check(launches["gather_rank_staged"] > 0,
          f"cold trace never ranked from the staging arena: {launches}")
    # the same trace through an all-device index whose ring never fills
    hot_cfg = cold_trace_config(max_snapshots=24, max_tombstones=4096,
                                cold_segments=0)
    flat = run_cold_trace(DEVICE, proj, hot_cfg, vecs, None)
    check("merge" not in flat[1]["maint"], "the all-device index merged")
    for (gi, gd), (fi, fd) in zip(gpu[0], flat[0]):
        np.testing.assert_array_equal(gi, fi)
        np.testing.assert_array_equal(gd, fd)
    emit(phase="cold_trace", equal=True, integer_leaves=n_int,
         max_dist_err=max_d, all_device_bit_identical=True,
         maintenance=cpu[1]["maint"], cold=c, facts=gpu[3],
         launches=launches, cpu_s=t1 - t0, gpu_s=t2 - t1)


# ----------------------------------------------------------------------
# phase 4: the stream engine on a small stream, CPU vs card
# ----------------------------------------------------------------------
def stream_ops(vecs: np.ndarray, seed: int, n_prefix: int, n_ops: int):
    """A seeded interleaved stream over ``vecs``: ``n_prefix`` inserts with
    a forced seal after every 100 (the ring fills, so later seals merge
    or spill first), then ``n_ops`` requests: inserts of fresh ids and
    re-inserts of deleted ones, self-queries and queries of vectors never
    stored, deletes of any id issued so far (so deletes repeat), update
    storms, a flush every ~16 requests and a forced seal every ~50.
    Returns ``(kind, *args)`` tuples and ``("flush",)`` / ``("seal",)``."""
    rng = np.random.default_rng(seed)
    fresh_q = len(vecs) - 64                 # the last 64 rows: queries only
    ops = []
    for i in range(n_prefix):
        ops.append(("insert", i, vecs[i]))
        if i % 100 == 99:
            ops += [("flush",), ("seal",)]
    cur = {i: i for i in range(n_prefix)}    # live id -> row of its version
    issued, row = n_prefix, n_prefix
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.35:
            vid = issued if rng.random() < 0.8 else int(rng.integers(issued))
            issued += vid == issued
            ops.append(("update" if vid in cur else "insert", vid, vecs[row]))
            cur[vid], row = row, row + 1
        elif r < 0.65:
            vid = list(cur)[int(rng.integers(len(cur)))]
            q = vecs[cur[vid]] if rng.random() < 0.5 \
                else vecs[fresh_q + int(rng.integers(64))]
            ops.append(("query", q, 10))
        elif r < 0.77:
            vid = int(rng.integers(issued))
            cur.pop(vid, None)
            ops.append(("delete", vid))
        elif r < 0.92:
            vid = list(cur)[int(rng.integers(len(cur)))]
            for _ in range(int(rng.integers(1, 4))):       # update storm
                ops.append(("update", vid, vecs[row]))
                cur[vid], row = row, row + 1
        elif r < 0.98:
            ops.append(("flush",))
        else:
            ops += [("flush",), ("seal",)]
        check(row < fresh_q, "stream_ops ran out of vectors")
    return ops + [("flush",)]


def run_stream_trace(device, proj, cfg, ops, ordering, cold_dir=None):
    """``ops`` through a StreamEngine over a fresh index on ``device``.
    Returns (query answers, host state, state leaves) as
    :func:`compare_traces` reads them; the host state holds every ack,
    the engine's stats and flag counters, the sync count and the logs."""
    idx = PFOIndex(cfg, device=device, proj=proj, cold_dir=cold_dir)
    eng = StreamEngine(idx, StreamConfig(max_batch=64, min_batch=8,
                                         default_k=10, ordering=ordering))
    eng.warmup()
    results = {}
    tickets = []
    for op in ops:
        if op[0] == "flush":
            results.update(eng.flush())
        elif op[0] == "seal":
            eng.seal()
        else:
            tickets.append(getattr(eng, op[0])(*op[1:]))
    answers = [results[t] for t in tickets if not isinstance(results[t], str)]
    counters = eng.obs.snapshot()["counters"]
    host = dict(acks=[results[t] for t in tickets
                      if isinstance(results[t], str)],
                stats=eng.stats(), events=eng.events, syncs=idx.sync_count,
                maint=idx.maintenance_log, flags=idx._flags,
                flag_fired={k: v for k, v in counters.items()
                            if k.startswith("stream.flag_fired")})
    return answers, host, convert.state_to_numpy(idx.state)


def strict_equals_per_request(proj, cfg, vecs):
    """The JAX package's equivalence trace on the card: a strict-order
    engine against the same requests as PFOIndex calls, run by run, on a
    second card index: ids and distances bit-identical."""
    eng = StreamEngine(PFOIndex(cfg, device=DEVICE, proj=proj),
                       StreamConfig(max_batch=64, min_batch=8,
                                    ordering="strict"))
    ref_idx = PFOIndex(cfg, device=DEVICE, proj=proj)
    for i in range(100):
        eng.insert(i, vecs[i])
    q1 = [eng.query(vecs[i], k=5) for i in range(10)]
    for i in range(5):
        eng.delete(i)
    for i in range(5, 8):
        eng.update(i, vecs[100 + i])
    q2 = [eng.query(vecs[100 + i], k=5) for i in range(5, 8)]
    res = eng.flush()
    ref_idx.insert(np.arange(100, dtype=np.int32), vecs[:100])
    r1 = ref_idx.query(vecs[:10], k=5)
    ref_idx.delete(np.arange(5, dtype=np.int32))
    ref_idx.update(np.arange(5, 8, dtype=np.int32), vecs[105:108])
    r2 = ref_idx.query(vecs[105:108], k=5)
    n = 0
    for (ids, dists), tickets in ((r1, q1), (r2, q2)):
        for row, t in enumerate(tickets):
            check(np.array_equal(res[t][0], ids[row])
                  and np.array_equal(res[t][1], dists[row]),
                  "strict engine on the card differs from PFOIndex calls")
            n += 1
    return n


def phase_stream_trace(seed: int):
    """A small interleaved stream through the StreamEngine on the CPU and
    on the card, both orderings, on the hot trace config and on a
    spilling cold one: answers, acks, stats, flag counters, syncs and
    every integer leaf equal, distances within DIST_TOL."""
    out = {}
    t0 = time.perf_counter()
    for name, cfg in (("hot", small_config()),
                      ("cold", cold_trace_config())):
        proj = PFOIndex(cfg, seed=seed, device="cpu").state.proj
        vecs = safe_vectors(proj, cfg, 900, seed + 2)
        for ordering, n_ops in (("strict", 100), ("window", 200)):
            ops = stream_ops(vecs, seed + 3, 400, n_ops)
            with tempfile.TemporaryDirectory() as tmp:
                runs = [run_stream_trace(dev, proj, cfg, ops, ordering,
                                         f"{tmp}/{dev}" if name == "cold"
                                         else None)
                        for dev in ("cpu", DEVICE)]
            what = f"stream trace {name} {ordering}"
            n_int, max_d = compare_traces(*runs, what)
            st = runs[1][1]["stats"]
            check(st["seals"] >= 2 and (st["spills"] if name == "cold"
                                        else st["merges"]) >= 1,
                  f"{what} must seal twice and merge (spill, cold): {st}")
            out[f"{name}_{ordering}"] = dict(
                requests=st["requests"], rounds=st["rounds"],
                rounds_by_kind=st["rounds_by_kind"],
                readbacks=st["readbacks"], seals=st["seals"],
                merges=st["merges"], spills=st["spills"],
                integer_leaves=n_int, max_dist_err=max_d)
    cfg = small_config()
    proj = PFOIndex(cfg, seed=seed, device="cpu").state.proj
    n_strict = strict_equals_per_request(
        proj, cfg, safe_vectors(proj, cfg, 150, seed + 4))
    emit(phase="stream_trace", equal=True, traces=out,
         strict_answers_equal_to_pfoindex_calls=n_strict,
         s=time.perf_counter() - t0)


# ----------------------------------------------------------------------
# phase 6: the hot main path at a realistic size
# ----------------------------------------------------------------------
def exact_oracle(cfg, ids, vecs, q):
    """Exact top-11 of each query among (ids, vecs) through ``BruteForce``,
    i.e. the ported ``pair_dist`` kernel.  Returns host ids and distances
    (Q, 11), the launches it made, the (qn, xn) its pair_dist got and the
    query's seconds."""
    seen = []
    before = dict(ops.LAUNCHES)
    bf = BruteForce(cfg, device=vecs.device)
    bf.insert(ids, vecs)
    with tapped(ops, "pair_dist_sq", lambda qq, xx: seen.append((qq, xx))):
        t0 = time.perf_counter()
        got = bf.query(q, 11)
        secs = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
    check(launches["pair_dist"] == 1, f"BruteForce ran no pair_dist: "
          f"{launches}")
    return got, launches, seen[-1], secs


def plain_oracle_misses(ids, xin, truth, truth_d):
    """The oracle again through pair_dist's plain version, on the inputs
    the kernel got.  Returns (rows whose top-10 id sets differ, rows whose
    10th and 11th distances lie within TIE_TOL); a differing row must be
    a near-tie."""
    qn, xn = xin
    pd = 0.5 * ref.ref_pair_dist(qn, xn)
    plain = ids[torch.topk(-pd, 10, dim=1).indices].cpu().numpy()
    del pd
    differ = np.array([set(plain[i]) != set(truth[i, :10])
                       for i in range(len(plain))])
    near = np.abs(truth_d[:, 10] - truth_d[:, 9]) <= TIE_TOL
    check(not (differ & ~near).any(), f"{int((differ & ~near).sum())} "
          "oracle rows differ from the plain version without a near-tie")
    return int(differ.sum()), int(near.sum())


def error_ratio(query_d, oracle_d, k: int) -> float:
    """Paper Eq. 1 with the paper's penalty: a missing neighbour counts as
    similarity 0 (angular distance 1.0), as ``benchmarks/common.py``."""
    qd = np.where(np.isfinite(query_d[:, :k]), query_d[:, :k], 1.0)
    od = np.maximum(oracle_d[:, :k], 1e-6)
    return float(np.mean(qd / od))


def recall_at(got_ids, truth, k: int = 10) -> np.ndarray:
    return np.array([len(set(got_ids[i]) & set(truth[i, :k])) / k
                     for i in range(len(got_ids))])


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
    t_ins = 0.0
    for b, s in enumerate(range(0, n, batch)):
        t0 = time.perf_counter()
        if s + batch >= n:     # the last batch, traced (its wall time only)
            profile = device_profile(lambda: idx.insert(
                ids[s:s + batch], vecs[s:s + batch]))
            t_ins += profile["wall_ms"] / 1e3
        else:
            idx.insert(ids[s:s + batch], vecs[s:s + batch])
            t_ins += time.perf_counter() - t0
        if b % 64 == 63:
            emit(phase="insert_progress", items=s + batch, s=t_ins,
                 maintenance=len(idx.maintenance_log))
    torch.cuda.synchronize()

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
    (got_ids, got_d), t_q, ranked = tap_ranking(lambda: idx.query(q, 10))
    q_launch = {k: ops.LAUNCHES[k] - before_q[k] for k in before_q}
    # the spread: the same call again, QUERY_REPS times, each timed alone
    # (one reading of a call has moved 9x between runs of the same code)
    q_reps = []
    for _ in range(QUERY_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.query(q, 10)
        torch.cuda.synchronize()
        q_reps.append(time.perf_counter() - t0)

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
    # every id kept, from a full row.  The query's own candidates.
    self_ids = ids[pick].cpu().numpy()
    cids = ranked["cids"][: nq // 2].cpu().numpy()
    rank0 = got_ids[: nq // 2, 0] == self_ids
    check(not cut_criterion(self_ids, got_ids[: nq // 2], cids).any(),
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
    cursors = [[int(c) for c in index_mod.forest_headroom(f)] for f in (
        idx.state.lsh_forest, idx.state.main_forest)]
    check("seal" in idx.maintenance_log,
          "the inserts never sealed the hot forests into the ring: worst "
          f"(leaf, node) cursors LSH / main {cursors}")

    # recall@10 against the exact oracle over the items live at query
    # time (all of them: the deletes came after), held against the
    # oracle's plain version
    (truth, truth_d), oracle_launches, oracle_in, t_oracle = exact_oracle(
        cfg, ids, vecs, q)
    differ, near = plain_oracle_misses(ids, oracle_in, truth, truth_d)
    recall = recall_at(got_ids, truth)
    emit(phase="main_path", items=n, dim=cfg.dim,
         reduced=[f"items {GLOVE_ROWS} -> {n}: leaves the run's time to "
                  "the cold path (and a merge keeps one segment of 2^20 "
                  "entries)"],
         insert_batch=batch, insert_s=t_ins, inserts_per_s=n / t_ins,
         insert_rounds=sum(idx.rounds_log), insert_calls=len(idx.rounds_log),
         seals=idx.maintenance_log.count("seal"),
         merges=idx.maintenance_log.count("merge"),
         queries=nq, query_s=t_q, queries_per_s=nq / t_q,
         query_reps_s=q_reps,
         queries_per_s_reps=[nq / t for t in q_reps],
         queries_per_s_median=float(nq / np.median(q_reps)),
         recall_at_10=float(recall.mean()),
         recall_at_10_fresh=float(recall[nq // 2:].mean()),
         oracle="BruteForce (pair_dist)", oracle_launches=oracle_launches,
         oracle_rows_differing_from_plain=differ,
         oracle_near_tie_rows=near,
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
    hot = dict(ids=ids, vecs=vecs, q=q, got_ids=got_ids, got_d=got_d,
               truth=truth, truth_d=truth_d, oracle_in=oracle_in,
               oracle_launches=oracle_launches["pair_dist"],
               oracle_queries_per_s=nq / t_oracle,
               inserts_per_s=n / t_ins, queries_per_s=nq / t_q,
               candidates_per_query=n_cand, proj=idx.state.proj,
               dead=dead)
    return idx, ranked, launches, hot


# ----------------------------------------------------------------------
# phase 7: the stream engine at glove-100 width, on the hot path's index
# ----------------------------------------------------------------------
STREAM_WARM = 1024          # requests before the measured leg
STREAM_REQUESTS = 8192      # the measured leg (cut for time from 32,768
#                             and 16,384)
STREAM_PER_REQUEST = 128    # the same stream, one PFOIndex call a request
#                             (cut for time)
STREAM_FLUSH = 256          # requests a window (flush_every)
STREAM_MIX = (0.5, 0.25, 0.125, 0.125)  # query / insert / delete / update
STREAM_NOISE = 0.05         # a query's (or write's) noise a coordinate
STREAM_SELF = 0.25          # queries that are a live id's own vector
SYNC_WARNING = "synchronizing CUDA operation"


def stream_workload(hot: dict, hot_ids: np.ndarray, n_req: int, seed: int):
    """``benchmarks/streaming.py``'s ``make_workload`` at the hot path's
    width, over its items: noisy copies of stored vectors, queried (a
    STREAM_SELF share of the queries are live ids' own vectors instead),
    inserted under fresh ids from ITEMS up, or written by updates of the
    hot items; deletes draw from every id issued so far, so they repeat.
    Returns the requests as (kind, id, table row, exact id) and the
    vector table on the card (the items' rows, then the stream's)."""
    ids_np = hot["ids"].cpu().numpy()
    n = len(ids_np)
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    src = torch.randint(0, n, (n_req,), generator=g, device=DEVICE)
    noisy = hot["vecs"][src] + STREAM_NOISE * torch.randn(
        (n_req, hot["vecs"].shape[1]), generator=g, device=DEVICE)
    table = torch.cat([hot["vecs"], noisy])
    row_of = np.full(n + n_req, -1, np.int64)
    row_of[ids_np] = np.arange(n)
    alive = np.zeros(n + n_req, bool)
    alive[ids_np] = True
    alive[hot["dead"].cpu().numpy()] = False
    self_pool = [int(i) for i in hot_ids if alive[i]]
    kinds = rng.choice(4, size=n_req, p=STREAM_MIX)
    reqs, next_id = [], n
    for i, kd in enumerate(kinds):
        if kd == 0:
            j = self_pool[int(rng.integers(len(self_pool)))]
            if rng.random() < STREAM_SELF and alive[j]:
                reqs.append(("query", -1, int(row_of[j]), j))
            else:
                reqs.append(("query", -1, n + i, None))
        elif kd == 1:
            reqs.append(("insert", next_id, n + i, None))
            row_of[next_id], alive[next_id] = n + i, True
            self_pool.append(next_id)
            next_id += 1
        elif kd == 2:
            vid = int(rng.integers(0, next_id))
            reqs.append(("delete", vid, -1, None))
            alive[vid] = False
        else:
            vid = int(hot_ids[int(rng.integers(len(hot_ids)))])
            reqs.append(("update", vid, n + i, None))
            row_of[vid], alive[vid] = n + i, True
    return reqs, table


def as_calls(reqs, host_rows: dict):
    """Requests as ``drive`` tuples: (kind, *args)."""
    out = []
    for kind, vid, row, _ in reqs:
        if kind == "query":
            out.append(("query", host_rows[row], 10))
        elif kind == "delete":
            out.append(("delete", vid))
        else:
            out.append((kind, vid, host_rows[row]))
    return out


class StreamOracle:
    """The window-mode oracle of ``tests/test_stream_engine.py``'s
    ``_check_query``, on the card: every window's writes land in order,
    then each of its queries is held to the live ids' current versions.
    No deleted id, every distance within ORACLE_TOL of the true one, the
    answers sorted, a self-query first unless ``cut_criterion`` says the
    ranking budget cut its id."""

    ORACLE_TOL = 1e-4

    def __init__(self, hot: dict, n_req: int, table: torch.Tensor):
        ids_np = hot["ids"].cpu().numpy()
        n = len(ids_np)
        self.table = table
        self.row_of = np.full(n + n_req, -1, np.int64)
        self.row_of[ids_np] = np.arange(n)
        self.alive = np.zeros(n + n_req, bool)
        self.alive[ids_np] = True
        self.alive[hot["dead"].cpu().numpy()] = False
        self.q_rows, self.a_rows, self.a_live, self.a_d = [], [], [], []
        self.n_self = self.self_rank0 = self.self_cut = 0
        self.n_queries = self.n_answered = 0

    def window(self, reqs, results, cids_rounds):
        """One window: its requests in order, the engine's results by
        request, and the candidate ids of its query rounds."""
        for kind, vid, row, _ in reqs:
            if kind == "delete":
                self.alive[vid] = False
            elif kind != "query":
                self.row_of[vid], self.alive[vid] = row, True
        qi = 0
        for (kind, _, row, exact), res in zip(reqs, results):
            if kind != "query":
                check(res == "ok", f"a {kind} was not acknowledged: {res}")
                continue
            ids, d = res
            live = ids >= 0
            check(len(set(ids[live].tolist())) == int(live.sum()),
                  "an answer repeats an id")
            check(self.alive[ids[live]].all(), "a deleted id came back")
            check((np.diff(d[live]) >= -1e-6).all(), "distances not sorted")
            self.q_rows.append(row)
            self.a_rows.append(np.where(live, self.row_of[np.maximum(ids, 0)],
                                        0))
            self.a_live.append(live)
            self.a_d.append(d)
            self.n_queries += 1
            self.n_answered += int(live.any())
            if exact is not None and self.alive[exact] \
                    and self.row_of[exact] == row:
                self.n_self += 1
                if ids[0] == exact:
                    check(d[0] < 1e-5, "self distance not 0")
                    self.self_rank0 += 1
                else:
                    cids = cids_rounds[qi // STREAM_FLUSH][
                        qi % STREAM_FLUSH].cpu().numpy()
                    check(cut_criterion(np.asarray([exact]), ids[None],
                                        cids[None]).sum() == 0,
                          "a self-query missed rank 0 without its id being "
                          "cut by the ranking budget")
                    self.self_cut += 1
            qi += 1

    def distances(self) -> float:
        """Every reported distance against the true one to the answered
        id's current version (float64, on the card); the largest error."""
        qr = torch.as_tensor(np.asarray(self.q_rows), device=DEVICE)
        ar = torch.as_tensor(np.stack(self.a_rows), device=DEVICE)
        live = torch.as_tensor(np.stack(self.a_live), device=DEVICE)
        got = torch.as_tensor(np.stack(self.a_d), device=DEVICE).double()
        worst = 0.0
        for s in range(0, qr.numel(), 4096):
            q = self.table[qr[s:s + 4096]].double()
            x = self.table[ar[s:s + 4096]].double()
            q = q / q.norm(dim=-1, keepdim=True)
            x = x / x.norm(dim=-1, keepdim=True)
            true = 1.0 - torch.einsum("qd,qkd->qk", q, x)
            err = torch.where(live[s:s + 4096],
                              (got[s:s + 4096] - true).abs(), 0.0)
            worst = max(worst, float(err.max()))
        check(worst <= self.ORACLE_TOL, f"a distance is {worst} from the "
              f"true one to the id's current version (> {self.ORACLE_TOL})")
        return worst


def hist(snap: dict, name: str) -> dict:
    h = snap["histograms"].get(name, {})
    return {k: h.get(k) for k in ("count", "mean", "p50", "p99")}


def phase_stream(args, idx, hot: dict, rows: list):
    """The stream engine over the hot path's ITEMS-item index (reused,
    so no second index is built): a STREAM_WARM warm prefix, then
    STREAM_REQUESTS requests of the streaming benchmark's mix in windows
    of STREAM_FLUSH, with the launch counts set to 0 just before and read
    just after, the flushes under ``torch.cuda.set_sync_debug_mode
    ("warn")``; one more window traced; a 256-query window whose
    lsh_hash and gather_rank inputs are tapped, held and timed; then
    STREAM_PER_REQUEST requests of the same stream as PFOIndex calls."""
    import warnings
    t_phase = time.perf_counter()
    cfg = idx.cfg
    n = hot["ids"].shape[0]
    # the hot items: live ids still in the hot MainTable forest
    tail = hot["ids"][max(0, n - 4 * 4096):]
    _, in_hot = index_mod.forest_lookup_masked(
        idx.state.main_forest, *reversed(index_mod.main_table_keys(tail, cfg)),
        tail, index_mod.main_tree_config(cfg))
    hot_ids = np.setdiff1d(tail[in_hot].cpu().numpy(),
                           hot["dead"].cpu().numpy())
    n_req = STREAM_WARM + STREAM_REQUESTS + STREAM_FLUSH + STREAM_PER_REQUEST
    reqs, table = stream_workload(hot, hot_ids, n_req, args.seed + 11)
    need = sorted({r[2] for r in reqs if r[2] >= 0})
    host_rows = dict(zip(need, table[torch.as_tensor(need, device=DEVICE)]
                         .cpu().numpy()))
    calls = as_calls(reqs, host_rows)
    oracle = StreamOracle(hot, n_req, table)

    eng = StreamEngine(idx, StreamConfig(max_batch=256, min_batch=8,
                                         default_k=10, ordering="window"))
    t0 = time.perf_counter()
    eng.warmup()
    warmup_s = time.perf_counter() - t0
    cids_rounds: list = []         # candidate ids of each query round

    def keep(state, qvecs, cids, *rest, **kw):
        cids_rounds.append(cids)

    def checked(lo: int, hi: int, run):
        """``run(calls[lo:hi])`` (-> {ticket: result}) with the query
        rounds' candidates tapped, then its windows through the oracle."""
        cids_rounds.clear()
        with tapped(index_mod, "_rank_candidates", keep):
            results = run(calls[lo:hi])
        flat = [results[t] for t in sorted(results)]
        check(len(flat) == hi - lo, "a request went unanswered")
        qr = 0
        for w in range(lo, hi, STREAM_FLUSH):
            win = reqs[w:w + STREAM_FLUSH]
            k = -(-sum(r[0] == "query" for r in win) // STREAM_FLUSH)
            oracle.window(win, flat[w - lo:w - lo + len(win)],
                          cids_rounds[qr:qr + k])
            qr += k
        check(qr == len(cids_rounds), "query rounds do not match windows")

    def windows(part):
        return drive(eng, part, flush_every=STREAM_FLUSH)

    checked(0, STREAM_WARM, lambda part: windows(part)[0])

    # the measured leg
    probes = [0]
    real_round_flags = index_mod.round_flags

    def counted_round_flags(*a_, **kw):
        probes[0] += 1
        return real_round_flags(*a_, **kw)

    leg = {}

    def measured(part):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                results, leg["s"], leg["lat"] = windows(part)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        leg["syncs"] = sum(SYNC_WARNING in str(w.message) for w in caught)
        return results

    a, b = STREAM_WARM, STREAM_WARM + STREAM_REQUESTS
    eng.set_obs(Obs())
    before = eng.stats()
    index_mod.round_flags = counted_round_flags
    torch.cuda.synchronize()
    ops.reset_launches()                      # counts start here ...
    try:
        checked(a, b, measured)
    finally:
        index_mod.round_flags = real_round_flags
    launches = dict(ops.LAUNCHES)             # ... and stop here
    after = eng.stats()
    snap = eng.obs.snapshot()
    secs, lat, syncs = leg["s"], leg["lat"], leg["syncs"]
    rounds = after["rounds"] - before["rounds"]
    readbacks = after["readbacks"] - before["readbacks"]
    q_rounds = (after["rounds_by_kind"]["query"]
                - before["rounds_by_kind"]["query"])
    check(readbacks == rounds + probes[0],
          f"readbacks {readbacks} != rounds {rounds} + flag probes "
          f"{probes[0]}")
    check(launches["lsh_hash"] > 0 and launches["gather_rank"] > 0,
          f"a kernel of the stream path was never launched: {launches}")

    # one more window, traced
    a, b = b, b + STREAM_FLUSH
    profile = {}

    def traced_window(part):
        out = {}
        profile.update(device_profile(lambda: out.update(windows(part)[0])))
        return out

    checked(a, b, traced_window)
    max_err = oracle.distances()

    # a window of 256 self-queries: one query round at the 256-row bucket,
    # its lsh_hash and gather_rank inputs tapped
    live_hot = [int(i) for i in hot_ids if oracle.alive[i]][:256]
    check(len(live_hot) == 256, "too few live hot items for the tap window")
    qv = table[torch.as_tensor(oracle.row_of[live_hot], device=DEVICE)]
    seen = {}
    with tapped(ops, "lsh_hash", lambda x, a_, M=32: seen.setdefault(
            "lsh_hash", (x, a_))), \
            tapped(ops, "gather_rank", lambda q, st, sl, va, metric,
                   staging=None: seen.setdefault(
                       "gather_rank", (q, st, sl, va, metric))):
        tap_res = drive(eng, [("query", v, 10) for v in qv.cpu().numpy()],
                        flush_every=STREAM_FLUSH)[0]
    tap_ids = np.stack([tap_res[t][0] for t in sorted(tap_res)])
    check(tap_ids.shape == (256, 10) and (tap_ids[:, 0] >= 0).all(),
          "the tapped window's answers")
    x, a_proj = seen["lsh_hash"]
    check(x.shape[0] == 256, f"lsh_hash tapped at {x.shape[0]} rows")
    hash_row = lsh_hash_at(x, a_proj)
    rank_row = gather_rank_at(*seen["gather_rank"])
    check(rank_row["shape"][0] == 256, "gather_rank tapped off the bucket")
    for row, name, stream_row in ((rows[0], "lsh_hash", hash_row),
                                  (rows[1], "gather_rank", rank_row)):
        check(row["name"] == name, f"kernel row {row['name']} != {name}")
        row["launches_by_path"] = dict(main_path=row["launches"],
                                       stream=launches[name])
        row["stream_bucket"] = dict(stream_row, launches=launches[name])
    del seen, x, a_proj

    # the per-request leg: the same stream, one PFOIndex call a request
    a, b = b, b + STREAM_PER_REQUEST
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for kind, *rest in calls[a:b]:
        if kind == "query":
            idx.query(rest[0][None], rest[1])
        elif kind == "delete":
            idx.delete(np.asarray([rest[0]], np.int32))
        else:
            getattr(idx, kind)(np.asarray([rest[0]], np.int32), rest[1][None])
    torch.cuda.synchronize()
    per_req_s = time.perf_counter() - t0

    lat_ms = np.asarray(lat) * 1e3
    engine_rps = STREAM_REQUESTS / secs
    per_request_rps = STREAM_PER_REQUEST / per_req_s
    emit(phase="stream", items=n, dim=cfg.dim,
         config=dict(max_batch=256, min_batch=8, default_k=10,
                     ordering="window", flush_every=STREAM_FLUSH),
         mix=dict(zip(("query", "insert", "delete", "update"), STREAM_MIX)),
         warm_requests=STREAM_WARM, requests=STREAM_REQUESTS,
         warmup_s=warmup_s, engine_s=secs, engine_rps=engine_rps,
         per_request_requests=STREAM_PER_REQUEST, per_request_s=per_req_s,
         per_request_rps=per_request_rps,
         speedup=engine_rps / per_request_rps,
         flush_ms=dict(p50=float(np.percentile(lat_ms, 50)),
                       p99=float(np.percentile(lat_ms, 99)),
                       mean=float(lat_ms.mean()), flushes=len(lat_ms)),
         e2e_ms={k: hist(snap, f"req.e2e_ms{{kind={k}}}")
                 for k in ("query", "insert", "delete", "update")},
         split_ms={p: hist(snap, f"req.{p}_ms")
                   for p in ("queue_wait", "batch_wait", "service")},
         rounds=rounds,
         rounds_by_kind={k: after["rounds_by_kind"][k]
                         - before["rounds_by_kind"][k]
                         for k in after["rounds_by_kind"]},
         readbacks=readbacks, flag_probes=probes[0],
         readbacks_per_round=readbacks / rounds,
         seals=after["seals"] - before["seals"],
         merges=after["merges"] - before["merges"],
         launches={k: launches[k] for k in ("lsh_hash", "gather_rank")},
         sync_warnings=syncs, query_pickups=q_rounds,
         implicit_syncs=syncs - readbacks - q_rounds,
         implicit_syncs_per_round=(syncs - readbacks - q_rounds)
         / (rounds + q_rounds),
         oracle=dict(queries=oracle.n_queries, answered=oracle.n_answered,
                     self_queries=oracle.n_self,
                     self_rank0=oracle.self_rank0,
                     self_cut_by_budget=oracle.self_cut,
                     max_dist_err=max_err),
         traced_flush=profile, stats=idx.stats(),
         s=time.perf_counter() - t_phase)


# ----------------------------------------------------------------------
# phase 8: checkpoints of the hot path's index and of a small cold one
# ----------------------------------------------------------------------
def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def leaves_equal(a, b) -> int:
    """Every leaf of two states equal (``torch.equal``, same paths and
    dtypes); returns the leaf count."""
    pa, pb = flatten_with_paths(a), flatten_with_paths(b)
    check([p for p, _ in pa] == [p for p, _ in pb], "leaf paths differ")
    for (p, x), (_, y) in zip(pa, pb):
        check(x.dtype == y.dtype and torch.equal(x, y),
              f"leaf {p} differs after the restore")
    return len(pa)


def cold_checkpoint_check(seed: int, tmp: str) -> dict:
    """The stream trace's small cold config with file-backed segments on
    the card: spilled, checkpointed (segments hardlinked), restored,
    queried alike."""
    cfg = cold_trace_config()
    proj = PFOIndex(cfg, seed=seed, device="cpu").state.proj
    vecs = safe_vectors(proj, cfg, 2400, seed + 5)
    idx = PFOIndex(cfg, device=DEVICE, proj=proj, cold_dir=f"{tmp}/seg")
    ids = np.arange(len(vecs), dtype=np.int32)
    for w in range(6):
        idx.insert(ids[w * 400:(w + 1) * 400], vecs[w * 400:(w + 1) * 400])
    idx.delete(ids[:100])
    check(idx.cold.n_cold >= 1, "the small cold index did not spill")
    path = save_index_checkpoint(f"{tmp}/ck", 1, idx)
    man = read_manifest(f"{tmp}/ck", 1)["extra"]["cold_manifest"]
    gids = [e["gid"] for row in man["lsh"] for e in row] \
        + [e["gid"] for e in man["main"]]
    for gid in gids:
        check(os.stat(f"{path}/segments/seg_{gid:08d}.npy").st_ino
              == os.stat(idx.cold.store.path(gid)).st_ino,
              f"segment {gid} was copied, not hardlinked")
    back = load_index_checkpoint(f"{tmp}/ck", 1, cfg, device=DEVICE,
                                 cold_dir=f"{tmp}/seg2")
    q = vecs[::9]
    want, got = idx.query(q, 10), back.query(q, 10)
    check(np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1]),
          "the restored cold index answers differently")
    return dict(segments=idx.cold.n_cold, hardlinked=len(gids),
                queries=len(q), fetches_after_restore=back.cold.counters[
                    "fetches"])


def phase_checkpoint(args, idx, hot: dict, rows: list) -> None:
    """``save_index_checkpoint`` of the hot path's index (after the
    stream phase) into a temp dir and ``load_index_checkpoint`` on the
    card: every leaf equal, the 1,024 hot queries bit-identical, the
    restored queries' launches counted; then the small cold config with
    file-backed segments."""
    t_phase = time.perf_counter()
    cfg, q = idx.cfg, hot["q"]
    want = idx.query(q, 10)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_index_checkpoint(f"{tmp}/hot", 1, idx)
        save_s = time.perf_counter() - t0
        n_bytes = dir_bytes(path)
        codecs = sorted({e["codec"] for e in
                         read_manifest(f"{tmp}/hot", 1)["leaves"]})
        t0 = time.perf_counter()
        back = load_index_checkpoint(f"{tmp}/hot", 1, cfg, seed=args.seed,
                                     device=DEVICE)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        shutil.rmtree(path)
    n_leaves = leaves_equal(idx.state, back.state)
    check(back.n_inserted == idx.n_inserted, "n_inserted not restored")
    ops.reset_launches()                      # counts start here ...
    t0 = time.perf_counter()
    first = back.query(q[:1], 10)
    first_ms = (time.perf_counter() - t0) * 1e3
    got = back.query(q, 10)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)             # ... and stop here
    check(np.array_equal(first[0][0], want[0][0]),
          "the first restored query differs")
    check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
          "the restored index's answers are not bit-identical")
    check(launches["lsh_hash"] > 0 and launches["gather_rank"] > 0,
          f"a kernel of the restored queries was never launched: {launches}")
    for row in rows[:2]:
        row.setdefault("launches_by_path", {})["checkpoint"] = \
            launches[row["name"]]
    del back
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        cold = cold_checkpoint_check(args.seed, tmp)
    emit(phase="checkpoint", items=int(idx.n_inserted), dim=cfg.dim,
         save_s=save_s, load_s=load_s, bytes=n_bytes, codecs=codecs,
         leaves=n_leaves, leaves_equal=True, queries=int(q.shape[0]),
         answers_bit_identical=True, first_query_ms=first_ms,
         launches={k: launches[k] for k in ("lsh_hash", "gather_rank")},
         cold=cold, s=time.perf_counter() - t_phase)


# ----------------------------------------------------------------------
# phase 9: the distributed engine on a one-rank NCCL group
# ----------------------------------------------------------------------
DIST_ITEMS = 8192           # inserts before the mixed leg (cut for time
#                             from 65,536, 32,768 and 16,384)
DIST_REQUESTS = 4096        # the stream phase's mix, windows of STREAM_FLUSH
#                             (cut for time from 8,192)
DIST_BATCH = 4096           # rounds of the insert prefix (and max_batch)


def dist_workload(vecs: torch.Tensor, n_items: int, n_req: int, seed: int):
    """DIST_ITEMS inserts, then the stream phase's mix over them: noisy
    or self queries, inserts of fresh ids, deletes of any id issued so far
    (they repeat), updates; host rows of the card's vectors."""
    rng = np.random.default_rng(seed)
    host = vecs.cpu().numpy()
    dim = host.shape[1]
    calls = [("insert", i, host[i]) for i in range(n_items)]
    kinds = rng.choice(4, size=n_req, p=STREAM_MIX)
    nxt = n_items
    for kd in kinds:
        if kd == 0:
            j = int(rng.integers(nxt))
            x = host[j % len(host)]
            if rng.random() >= STREAM_SELF:
                x = x + STREAM_NOISE * rng.normal(size=dim).astype(
                    np.float32)
            calls.append(("query", x.astype(np.float32), 10))
        elif kd == 1:
            calls.append(("insert", nxt, host[nxt % len(host)]))
            nxt += 1
        elif kd == 2:
            calls.append(("delete", int(rng.integers(nxt))))
        else:
            j = int(rng.integers(n_items))
            x = host[j] + STREAM_NOISE * rng.normal(size=dim).astype(
                np.float32)
            calls.append(("update", j, x.astype(np.float32)))
    return calls


def answers_equal(a: dict, b: dict, tickets) -> dict:
    """Two engines' answers ticket by ticket: acks equal; query ids equal
    with distances within DIST_TOL, or (a near-tie) the sorted distances
    equal within TIE_TOL where the ids differ."""
    ties = n_q = 0
    for ta, tb in tickets:
        x, y = a[ta], b[tb]
        if isinstance(x, str) or isinstance(y, str):
            check(x == y, f"an ack differs: {x} != {y}")
            continue
        n_q += 1
        fin = np.isfinite(y[1])
        check(np.array_equal(np.isfinite(x[1]), fin),
              "answers differ in length")
        check(np.abs(x[1][fin] - y[1][fin]).max(initial=0) <= DIST_TOL,
              "distances differ")
        if not np.array_equal(x[0], y[0]):
            ties += 1
            check(np.abs(x[1][fin] - y[1][fin]).max(initial=0) <= TIE_TOL,
                  "ids differ off a near-tie")
    return dict(queries=n_q, near_tie_rows=ties)


def phase_dist(args, rows: list) -> None:
    """The distributed engine on a one-rank NCCL group (the degenerate
    mesh the JAX package's fast-lane tests use; a multi-rank NCCL run
    needs one process per GPU): a ``DistStreamEngine`` and a
    ``StreamEngine`` on the card with the same projections get the same
    trace — DIST_ITEMS inserts, then DIST_REQUESTS requests of the stream
    mix in windows of STREAM_FLUSH, with one forced seal and one forced
    merge — and answer alike; then a distributed checkpoint round trip.
    The launch counts are set to 0 just before each engine's mixed leg
    and read just after."""
    t_phase = time.perf_counter()
    cfg = main_config()
    with tempfile.TemporaryDirectory() as tmp:
        torch.distributed.init_process_group(
            "nccl", store=torch.distributed.FileStore(f"{tmp}/pg", 1),
            rank=0, world_size=1)
        try:
            out = _dist_run(args, cfg, tmp, rows)
        finally:
            torch.distributed.destroy_process_group()
    emit(phase="dist", **out, s=time.perf_counter() - t_phase)


def _dist_leg(eng, name, prefix, mixed, results, probes, rows,
              warnings) -> dict:
    """One engine of the dist phase: the insert prefix, the forced seal,
    then the mixed leg (the forced merge halfway) timed under the sync
    warnings, the launch counts set to 0 just before and read just
    after."""
    half = len(mixed) // 2
    t0 = time.perf_counter()
    res, _, _ = drive(eng, prefix, flush_every=DIST_BATCH)
    insert_s = time.perf_counter() - t0
    eng.seal()                                  # the forced seal
    results[name].update(res)
    before = eng.stats()
    coll = dict(dist_mod.COLLECTIVES)
    probes[0] = 0
    torch.cuda.synchronize()
    ops.reset_launches()                      # counts start here ...
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            r1, _, lat1 = drive(eng, mixed[:half], flush_every=STREAM_FLUSH)
            eng.merge()                         # the forced merge
            r2, _, lat2 = drive(eng, mixed[half:], flush_every=STREAM_FLUSH)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = dict(ops.LAUNCHES)             # ... and stop here
    after = eng.stats()
    results[name].update(r1)
    results[name].update(r2)
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    rounds = after["rounds"] - before["rounds"]
    q_rounds = (after["rounds_by_kind"]["query"]
                - before["rounds_by_kind"]["query"])
    readbacks = after["readbacks"] - before["readbacks"]
    check(readbacks == rounds + probes[0],
          f"{name}: readbacks {readbacks} != rounds {rounds} + flag probes "
          f"{probes[0]}")
    leg = dict(insert_s=insert_s, inserts_per_s=len(prefix) / insert_s,
               mixed_s=secs, engine_rps=len(mixed) / secs,
               rounds=rounds, query_rounds=q_rounds, readbacks=readbacks,
               flag_probes=probes[0],
               readbacks_per_round=(readbacks - probes[0]) / rounds,
               implicit_syncs_per_round=(syncs - readbacks - q_rounds)
               / (rounds + q_rounds),
               flush_ms_p50=float(np.percentile(
                   np.asarray(lat1 + lat2) * 1e3, 50)),
               seals=after["seals"], merges=after["merges"],
               launches={k: launches[k] for k in ("lsh_hash", "gather_rank")})
    if name == "dist":
        n_coll = {k: dist_mod.COLLECTIVES[k] - coll.get(k, 0)
                  for k in dist_mod.COLLECTIVES}
        leg["collectives"] = n_coll
        leg["collectives_per_round"] = sum(n_coll.values()) / (
            rounds + q_rounds)
        check(launches["lsh_hash"] > 0,
              f"lsh_hash was never launched on the dist path: {launches}")
        rows[0].setdefault("launches_by_path", {})["dist"] = \
            launches["lsh_hash"]
    else:
        check(launches["lsh_hash"] > 0 and launches["gather_rank"] > 0,
              f"a kernel of the single engine never launched: {launches}")
    return leg


def _dist_run(args, cfg, tmp, rows) -> dict:
    import warnings
    mesh = stream_mesh(1)                     # CUDA, NCCL
    check(mesh.backend == "nccl", f"the mesh runs on {mesh.backend}")
    # 4096-row rounds carry the insert prefix; the mixed leg's windows
    # of STREAM_FLUSH requests never fill a bucket past 256
    scfg = StreamConfig(max_batch=DIST_BATCH, min_batch=8, default_k=10,
                        ordering="window")
    dcfg = DistConfig(pfo=cfg, n_model=1)
    deng = DistStreamEngine(dcfg, mesh, scfg, seed=args.seed)
    proj = deng.backend.state.proj
    seng = StreamEngine(PFOIndex(cfg, device=DEVICE, proj=proj), scfg)
    vecs = clustered(DIST_ITEMS + DIST_REQUESTS, cfg.dim, args.seed + 21,
                     torch.device(DEVICE))
    calls = dist_workload(vecs, DIST_ITEMS, DIST_REQUESTS, args.seed + 22)
    del vecs
    t0 = time.perf_counter()
    deng.warmup()
    seng.warmup()
    warmup_s = time.perf_counter() - t0
    prefix, mixed = calls[:DIST_ITEMS], calls[DIST_ITEMS:]
    legs = {}
    results = {"dist": {}, "single": {}}
    probes = [0]

    def counted(fn):
        def run(*a, **kw):
            probes[0] += 1
            return fn(*a, **kw)
        return run

    real_round_flags = index_mod.round_flags
    deng.backend._flags_fn = counted(deng.backend._flags_fn)
    index_mod.round_flags = counted(real_round_flags)
    try:
        for name, eng in (("dist", deng), ("single", seng)):
            legs[name] = _dist_leg(eng, name, prefix, mixed, results, probes,
                                   rows, warnings)
    finally:
        index_mod.round_flags = real_round_flags
    # the tickets of both engines pair up in submission order
    tickets = list(zip(sorted(results["dist"]), sorted(results["single"])))
    check(len(tickets) == len(calls), "a request went unanswered")
    eq = answers_equal(results["dist"], results["single"], tickets)
    for key in ("seals", "merges"):
        check(legs["dist"][key] == legs["single"][key],
              f"{key}: dist {legs['dist'][key]} != single "
              f"{legs['single'][key]}")
    # a distributed checkpoint round trip, answers equal
    probe = [c for c in mixed if c[0] == "query"][:256]
    t0 = time.perf_counter()
    path = save_dist_checkpoint(f"{tmp}/dck", 1, deng.backend)
    save_s = time.perf_counter() - t0
    n_bytes = dir_bytes(path)
    want, _, _ = drive(deng, probe, flush_every=STREAM_FLUSH)
    del seng
    torch.cuda.empty_cache()
    back = DistStreamEngine(dcfg, mesh, scfg, seed=args.seed + 1)
    t0 = time.perf_counter()
    load_dist_checkpoint(f"{tmp}/dck", 1, back.backend)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got, _, _ = drive(back, probe, flush_every=STREAM_FLUSH)
    for a, b in zip(sorted(want), sorted(got)):
        check(np.array_equal(want[a][0], got[b][0])
              and np.array_equal(want[a][1], got[b][1]),
              "the restored dist engine answers differently")
    return dict(items=DIST_ITEMS, requests=DIST_REQUESTS, dim=cfg.dim,
                n_model=1, backend=mesh.backend,
                reduced=[f"items {ITEMS} -> {DIST_ITEMS}: cut for time"],
                mix=dict(zip(("query", "insert", "delete", "update"),
                             STREAM_MIX)),
                warmup_s=warmup_s, legs=legs, equal=True, **eq,
                dist_over_single_rps=legs["dist"]["engine_rps"]
                / legs["single"]["engine_rps"],
                checkpoint=dict(save_s=save_s, load_s=load_s, bytes=n_bytes,
                                queries=len(probe), answers_equal=True))


# ----------------------------------------------------------------------
# phase 10: the LM serving path (ServingEngine with the kNN-LM head)
# ----------------------------------------------------------------------
LM_ARCH = "smollm_135m"
LM_PARITY_ARCHS = ("smollm_135m", "qwen2_7b")   # reduced, CPU == card
#: the kNN-LM example's datastore (examples/knnlm_serving.py:26-28)
LM_EXAMPLE = dict(L=4, C=2, m=2, l=32, t=4, max_candidates_total=128,
                  max_leaves_per_tree=512, main_max_leaves_per_tree=2048,
                  store_capacity=16384)
#: ... at full width, its capacities raised until the fill neither seals
#: nor overflows (PERF.md section 4): a 4,096-row round asks every tree
#: for 2 x 4,096 x L / (L x 16 trees) = 512 leaves and nodes of headroom
#: (the example's 128 nodes sealed every round), and one tree may hold a
#: whole table's memories (hidden states crowd into few buckets)
LM_DATASTORE = dict(LM_EXAMPLE, max_nodes_per_tree=8192,
                    max_leaves_per_tree=40960, store_capacity=1 << 16)
LM_FILL_SEQS = 4         # SyntheticLM sequences in the datastore, of ...
LM_FILL_LEN = 1024       # ... 1,024 tokens: 4,096 memories (a real kNN-LM
#                          datastore holds ~10^8; cut for chip time from
#                          32,768, 16,384 and 8,192)
LM_FILL_BATCH = 8        # sequences a forward pass
LM_INSERT = 4096         # rows an insert call
LM_ROUNDS, LM_REQUESTS, LM_PROMPT, LM_NEW = 3, 4, 16, 16
LM_SERVE = dict(knn_lambda=0.3, knn_k=8)
LM_MEMORIES = 96         # the reduced datastores' memories (CPU == card)
LM_RECALL_SEQS = 8       # held-out sequences whose states query ...
LM_RECALL_PER_SEQ = 32   # ... at 32 positions each: 256 recall queries
MODEL_TOL = 1e-4         # f32 logits, CPU vs card (no TF32)
BF16_TOL = 3e-2          # decode vs forward in bf16 (tests/test_arch_smoke.py)
KNN_TOL = 1e-5           # kNN log-probs, host vs engine


def lm_prompts(vocab: int, seed: int) -> list:
    return [SyntheticLM(vocab, LM_PROMPT, LM_REQUESTS, seed=seed).batch(r)
            ["tokens"] for r in range(LM_ROUNDS)]


def lm_serve(model, params, device, proj, mem, nxt, prompts):
    """The kNN-LM engine over the example's datastore on ``device``,
    holding ``mem`` -> ``nxt``: each round's tokens, the final vocab map,
    stats and state."""
    pcfg = PFOConfig(dim=model.cfg.d_model, **LM_EXAMPLE)
    idx = PFOIndex(pcfg, device=device, proj=proj)
    idx.insert(np.arange(len(mem), dtype=np.int32), mem)
    vmap = np.zeros(pcfg.store_capacity, np.int32)
    vmap[:len(mem)] = nxt
    eng = ServingEngine(model, params, ServeConfig(**LM_SERVE),
                        pfo_index=idx, knn_vocab_map=vmap)
    outs = [eng.generate({"tokens": p}, max_new=LM_NEW)[0] for p in prompts]
    host = dict(tokens=[o.tolist() for o in outs],
                vocab_map=eng.knn_vocab_map.tolist(), stats=idx.stats(),
                syncs=idx.sync_count)
    # compare_traces' layout; the tokens ride in ``host``, no query answers
    return [], host, convert.state_to_numpy(idx.state)


def phase_lm_trace(seed: int) -> dict:
    """Reduced smollm_135m and qwen2_7b in f32, the same weights on the
    CPU and on the card (TF32 off): prefill and decode logits within
    MODEL_TOL; then three rounds of the kNN-LM engine over the example's
    datastore on each, holding the same margin-safe memories (the CPU
    model's hidden states), with every prompt's last hidden state
    margin-safe and within 1e-5 across the two: the tokens, vocab map,
    stats and every integer leaf of the datastores equal."""
    out = {}
    for arch in LM_PARITY_ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  dtype=torch.float32)
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(seed), device="cpu")
        card = convert.params_from_numpy(cfg, convert.params_to_numpy(cpu),
                                         device=DEVICE)
        text = SyntheticLM(cfg.vocab_size, LM_PROMPT, 8, seed=seed).batch(0)
        logits = {}
        for dev, params in (("cpu", cpu), (DEVICE, card)):
            toks = torch.from_numpy(text["tokens"]).to(dev)
            cache = model.init_cache(len(toks), LM_PROMPT + 1, device=dev)
            pl, cache, _ = model.prefill(params, {"tokens": toks}, cache)
            dl, _ = model.decode_step(params, toks[:, :1], cache, LM_PROMPT)
            logits[dev] = (pl.cpu(), dl.cpu())
        err = max(float((a - b).abs().max())
                  for a, b in zip(logits["cpu"], logits[DEVICE]))
        check(err <= MODEL_TOL, f"{arch}: logits CPU vs card {err}")

        pcfg = PFOConfig(dim=cfg.d_model, **LM_EXAMPLE)
        proj = PFOIndex(pcfg, seed=seed, device="cpu").state.proj
        data = SyntheticLM(cfg.vocab_size, 32, 8, seed=seed + 1).batch(0)
        hid, _ = model.forward(cpu, {"tokens": torch.from_numpy(
            data["tokens"])})
        mem = hid.reshape(-1, cfg.d_model).numpy()
        keep = safe_rows(mem, proj, pcfg)
        mem = mem[keep][:LM_MEMORIES]
        nxt = data["labels"].reshape(-1)[keep][:LM_MEMORIES]
        check(len(mem) == LM_MEMORIES, f"{arch}: too few margin-safe states")
        prompts = lm_prompts(cfg.vocab_size, seed + 2)
        gap = 0.0
        for p in prompts:
            h = [model.forward(w, {"tokens": torch.from_numpy(p).to(d)})[0]
                 [:, -1].cpu().numpy() for d, w in (("cpu", cpu),
                                                    (DEVICE, card))]
            gap = max(gap, float(np.abs(h[0] - h[1]).max()))
            check(safe_rows(h[0], proj, pcfg).all(),
                  f"{arch}: a prompt's last state is not margin-safe")
        check(gap <= 1e-5, f"{arch}: prompt states differ by {gap}")
        runs = [lm_serve(model, w, d, proj, mem, nxt, prompts)
                for d, w in (("cpu", cpu), (DEVICE, card))]
        n_int, _ = compare_traces(*runs, f"lm {arch}")
        out[arch] = dict(logits_max_err=err, state_gap=gap,
                         int_leaves_equal=n_int,
                         tokens=runs[0][1]["tokens"][0][0])
    return out


def lm_greedy(model, params, prompt: np.ndarray, n_new: int) -> np.ndarray:
    """The model's greedy continuation by the reference's rule (argmax of
    log_softmax in the logits' dtype, src/repro/serving/engine.py:124,
    132), one prefill and n_new - 1 decode steps."""
    toks = torch.from_numpy(prompt).to(DEVICE)
    cache = model.init_cache(len(prompt), prompt.shape[1] + n_new,
                             device=DEVICE)
    logits, cache, _ = model.prefill(params, {"tokens": toks}, cache)
    out = []
    for i in range(n_new):
        tok = torch.argmax(engine_mod._log_softmax(logits[:, 0]), dim=-1)
        out.append(tok.to(torch.int32))
        if i + 1 < n_new:
            logits, cache = model.decode_step(params, tok[:, None].to(
                torch.int32), cache, prompt.shape[1] + i)
    return torch.stack(out, 1).cpu().numpy()


def host_knn_logits(ids, dists, vocab_map, vocab: int, temp: float):
    """The reference's kNN head on the host, loop for loop
    (src/repro/serving/engine.py:109-119)."""
    logits = np.full((ids.shape[0], vocab), -1e30, np.float32)
    for b in range(ids.shape[0]):
        ok = ids[b] >= 0
        if not ok.any():
            continue
        toks = vocab_map[ids[b][ok]]
        w = np.exp(-temp * dists[b][ok])
        w = w / max(w.sum(), 1e-9)
        for tk, wi in zip(toks, w):
            cur = np.exp(logits[b, tk]) if logits[b, tk] > -1e29 else 0.0
            logits[b, tk] = np.log(cur + wi + 1e-20)
    return logits


def log_softmax_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def decode_start(eng, prompt: np.ndarray):
    """A prefill as ``generate`` runs it (kNN head off): (cache, token)."""
    toks = torch.from_numpy(prompt).to(DEVICE)
    cache = eng.model.init_cache(len(prompt), prompt.shape[1] + LM_NEW,
                                 device=DEVICE)
    logits, cache, _ = eng.prefill_step(eng.params, {"tokens": toks}, cache)
    return cache, eng._next_token(logits[:, 0], None)


def decode_steps(eng, cache, tok, pos: int) -> None:
    """LM_NEW decode steps as ``generate`` runs them, with no sync inside
    (for the sync count and the trace; the steps' times are the
    engine's own, ``serving.decode_step_ms``)."""
    for i in range(LM_NEW):
        logits, cache = eng.decode_step(eng.params, tok[:, None], cache,
                                        pos + i)
        tok = eng._next_token(logits[:, 0], None)


def tap_first(seen: dict, name: str):
    """A ``tapped`` keeper: the arguments of ``name``'s first call in the
    block, tensors cloned (the datastore updates its store in place)."""
    def keep(*args, **kw):
        if name not in seen:
            seen[name] = tuple(a.clone() if torch.is_tensor(a) else a
                               for a in args)
    return keep


def phase_lm(args, card: str, rows: list) -> tuple:
    """The LM serving path at full width: smollm_135m (30 layers, d_model
    576, 9 heads / 3 KV heads, d_ff 1536, vocab 49,152, tied, bf16,
    random weights from a torch.Generator) behind ``ServingEngine`` with
    the PFO kNN-LM head on the port's ``StreamEngine``, over a datastore
    of LM_FILL_SEQS x LM_FILL_LEN memories (the model's hidden state at
    each position of SyntheticLM text -> the next token).  The launch
    counts are set to 0 just before the fill and read after the recall
    oracle.  The kernels' inputs are tapped from the path (the first fill
    call's and the first kNN query's lsh_hash, that query's gather_rank,
    the recall oracle's pair_dist), each held against its plain version
    and timed at those shapes; lsh_hash's and gather_rank's results go
    into their kernel rows (``rows``) as ``lm``.  Returns the launches and
    pair_dist's result at the oracle's shape."""
    import warnings
    t_phase = time.perf_counter()
    seed = args.seed
    t0 = time.perf_counter()
    trace = phase_lm_trace(seed)
    trace_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(LM_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(seed),
                        device=DEVICE)
    n_params = sum(p.numel() for p in params.parameters())
    check(params.embed.dtype == torch.bfloat16 and params.embed.is_cuda,
          "the full-width model is not bf16 on the card")

    # decode == forward at full width
    g = torch.Generator(device=DEVICE).manual_seed(seed + 5)
    toks = torch.randint(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT + 1),
                         generator=g, device=DEVICE, dtype=torch.int32)
    cache = model.init_cache(LM_REQUESTS, LM_PROMPT + 1, device=DEVICE)
    _, cache, _ = model.prefill(params, {"tokens": toks[:, :-1]}, cache)
    dec, _ = model.decode_step(params, toks[:, -1:], cache, LM_PROMPT)
    hidden, _ = model.forward(params, {"tokens": toks})
    full = model.logits(params, hidden[:, -1:])
    dec_err = float((dec.float() - full.float()).abs().max())
    check(torch.allclose(dec.float(), full.float(), rtol=BF16_TOL,
                         atol=BF16_TOL),
          f"full width: decode differs from forward by {dec_err}")
    del cache, hidden

    # the datastore: its fill, with the launch counts from here
    pcfg = PFOConfig(dim=cfg.d_model, **LM_DATASTORE)
    idx = PFOIndex(pcfg, seed=seed, device=DEVICE)
    text = SyntheticLM(cfg.vocab_size, LM_FILL_LEN, LM_FILL_SEQS,
                       seed=seed).batch(0)
    vmap = np.zeros(pcfg.store_capacity, np.int32)
    n_mem = LM_FILL_SEQS * LM_FILL_LEN
    vmap[:n_mem] = text["labels"].reshape(-1)
    mem = []
    fwd_s = ins_s = 0.0
    fill_in, knn_in, oracle_in = {}, {}, []      # the kernels' tapped inputs
    torch.cuda.synchronize()
    ops.reset_launches()                          # counts start here ...
    with tapped(ops, "lsh_hash", tap_first(fill_in, "lsh_hash")):
        for s in range(0, LM_FILL_SEQS, LM_FILL_BATCH):
            t0 = time.perf_counter()
            hid, _ = model.forward(params, {"tokens": torch.from_numpy(
                text["tokens"][s:s + LM_FILL_BATCH]).to(DEVICE)})
            vecs = hid.float().reshape(-1, cfg.d_model)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for r in range(0, len(vecs), LM_INSERT):
                base = s * LM_FILL_LEN + r
                idx.insert(np.arange(base, base + LM_INSERT, dtype=np.int32),
                           vecs[r:r + LM_INSERT])
            torch.cuda.synchronize()
            fwd_s += t1 - t0
            ins_s += time.perf_counter() - t1
            mem.append(vecs)
            del hid
    mem = torch.cat(mem)
    fill_stats = idx.stats()
    check(idx.n_inserted == n_mem, "the fill lost inserts")
    check(fill_stats["overflow_events"] == 0,
          f"the datastore overflowed: {fill_stats}")
    fill_log = list(idx.maintenance_log)

    # serving: LM_ROUNDS rounds of LM_REQUESTS requests, the kNN head's
    # flushes and logits kept
    stream = StreamEngine(idx)
    stream.warmup()
    eng = ServingEngine(model, params, ServeConfig(**LM_SERVE),
                        pfo_stream=stream, knn_vocab_map=vmap)
    prompts = lm_prompts(cfg.vocab_size, seed + 2)
    flushes, knn_calls = [], []       # every flush; (hidden, flush#, out)
    real_flush, real_knn = stream.flush, eng._knn_logits

    def keep_flush():
        flushes.append(real_flush())
        return flushes[-1]

    def keep_knn(hidden, vocab):
        n0 = len(flushes)
        got = real_knn(hidden, vocab)
        knn_calls.append((hidden, n0, got))
        return got

    stream.flush, eng._knn_logits = keep_flush, keep_knn
    before = stream.stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with tapped(ops, "lsh_hash", tap_first(knn_in, "lsh_hash")), \
                tapped(ops, "gather_rank", tap_first(knn_in, "gather_rank")):
            served = [eng.generate({"tokens": p}, max_new=LM_NEW)
                      for p in prompts]
    finally:
        del stream.flush, eng._knn_logits
    serve_s = time.perf_counter() - t0
    after = stream.stats()
    snap = eng.obs.snapshot()
    check(len(knn_calls) == LM_ROUNDS, "the kNN head ran once a round")

    # the kNN log-probs, recomputed on the host from each flush
    knn_err, knn_found = 0.0, 0
    for _, n0, got in knn_calls:
        res = flushes[n0]
        tickets = sorted(res)
        ids = np.stack([res[t][0] for t in tickets])
        dists = np.stack([res[t][1] for t in tickets])
        knn_found += int((ids[:, 0] >= 0).sum())
        want = log_softmax_np(host_knn_logits(
            ids, dists, eng.knn_vocab_map, cfg.vocab_size,
            eng.scfg.knn_temp))
        have = log_softmax_np(got.cpu().numpy())
        knn_err = max(knn_err, float(np.abs(want - have).max()))
    check(knn_found > 0, "no kNN query found a neighbour")
    check(knn_err <= KNN_TOL, f"kNN log-probs differ by {knn_err}")

    # knn_lambda = 0: the engine's tokens are the model's greedy ones
    plain = ServingEngine(model, params, ServeConfig(knn_lambda=0.0))
    p_out, _ = plain.generate({"tokens": prompts[0]}, max_new=LM_NEW,
                              insert_online=False)
    check(np.array_equal(p_out, lm_greedy(model, params, prompts[0],
                                          LM_NEW)),
          "knn_lambda=0: the tokens are not the model's argmax")
    knn_moved = int((p_out[:, 0] != served[0][0][:, 0]).sum())

    # each request's online memory comes back first for its own vector,
    # unless the ranking budget cut its id
    online = []
    for p in prompts:
        c = model.init_cache(LM_REQUESTS, LM_PROMPT + LM_NEW, device=DEVICE)
        online.append(model.prefill(params, {"tokens": torch.from_numpy(
            p).to(DEVICE)}, c)[2].float())
    online = torch.cat(online)
    self_ids = np.arange(n_mem, n_mem + len(online), dtype=np.int32)

    def self_queries():
        tickets = [stream.query(v, k=LM_SERVE["knn_k"])
                   for v in online.cpu().numpy()]
        res = stream.flush()
        return np.stack([res[t][0] for t in tickets])

    got_self, _, ranked = tap_ranking(self_queries)
    missed = cut_criterion(self_ids, got_self,
                           ranked["cids"][:len(self_ids)].cpu().numpy())
    check(not missed.any(), f"{int(missed.sum())} online memories did not "
          "come back first for their own vectors")

    # recall@k of the kNN answers against BruteForce (pair_dist)
    held = SyntheticLM(cfg.vocab_size, 64, LM_RECALL_SEQS,
                       seed=seed + 3).batch(0)["tokens"]
    hq, _ = model.forward(params, {"tokens": torch.from_numpy(held).to(
        DEVICE)})
    pick = np.random.default_rng(seed).choice(64, LM_RECALL_PER_SEQ,
                                              replace=False)
    q = hq[:, torch.as_tensor(pick, device=DEVICE)].float().reshape(
        -1, cfg.d_model)
    tickets = [stream.query(v, k=LM_SERVE["knn_k"]) for v in q.cpu().numpy()]
    res = stream.flush()
    got = np.stack([res[t][0] for t in tickets])
    bf = BruteForce(pcfg, device=DEVICE)
    bf.insert(np.arange(n_mem + len(online), dtype=np.int32),
              torch.cat([mem, online]))
    with tapped(ops, "pair_dist_sq", lambda qq, xx: oracle_in.append(
            (qq, xx))):
        truth, truth_d = bf.query(q, LM_SERVE["knn_k"])
    got_d = np.stack([res[t][1] for t in tickets])
    recall = float(recall_at(got, truth, LM_SERVE["knn_k"]).mean())
    ratio = error_ratio(got_d, truth_d, LM_SERVE["knn_k"])
    launches = dict(ops.LAUNCHES)                 # ... and stop here
    for name in ("lsh_hash", "gather_rank", "pair_dist"):
        check(launches[name] > 0, f"the lm phase launched no {name}: "
              f"{launches}")

    # each kernel against its plain version at the shapes this path gave
    # it (d = 576), timed there, after the counts were read
    x, a_proj = fill_in["lsh_hash"][:2]
    check(list(x.shape) == [LM_INSERT, cfg.d_model],
          f"lsh_hash tapped off the fill's shape: {list(x.shape)}")
    hash_fill = lsh_hash_at(x, a_proj)
    x, a_proj = knn_in["lsh_hash"][:2]
    check(x.shape[1] == cfg.d_model, "the kNN query's lsh_hash tap")
    hash_query = lsh_hash_at(x, a_proj)
    rank_knn = gather_rank_at(*knn_in["gather_rank"][:5])
    check(rank_knn["shape"][1:] == [pcfg.max_candidates_total, cfg.d_model],
          f"gather_rank tapped off the kNN query: {rank_knn['shape']}")
    check(len(oracle_in) == 1, "the recall oracle's pair_dist tap")
    pair_oracle = pair_dist_at(oracle_in[0])
    del fill_in, knn_in, oracle_in, x, a_proj
    for row, name, lm_row in (
            (rows[0], "lsh_hash", dict(fill_insert=hash_fill,
                                       knn_query=hash_query)),
            (rows[1], "gather_rank", dict(knn_query=rank_knn))):
        check(row["name"] == name, f"kernel row {row['name']} != {name}")
        row.setdefault("launches_by_path", {})["lm"] = launches[name]
        row["lm"] = dict(lm_row, launches=launches[name])

    # the syncs no one counted (set_sync_debug_mode) in decode steps with
    # no sync of their own, then the same steps traced
    cache, tok = decode_start(eng, prompts[0])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            decode_steps(eng, cache, tok, LM_PROMPT)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    cache, tok = decode_start(eng, prompts[1])
    traced = device_profile(lambda: decode_steps(eng, cache, tok, LM_PROMPT))
    del cache, tok
    step_ms = hist(snap, "serving.decode_step_ms")
    emit(phase="lm", card=card, arch=LM_ARCH, dtype="bfloat16",
         params=n_params, layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, cpu_vs_card=trace, cpu_vs_card_s=trace_s,
         decode_vs_forward_max_err=dec_err,
         datastore=dict(config=LM_DATASTORE, dim=pcfg.dim, memories=n_mem,
                        fill_stats=fill_stats, fill_maintenance=fill_log,
                        final_stats=idx.stats()),
         fill_s=fwd_s + ins_s, fill_forward_s=fwd_s, fill_insert_s=ins_s,
         inserts_per_s=n_mem / ins_s,
         serve=dict(rounds=LM_ROUNDS, requests=LM_REQUESTS,
                    prompt=LM_PROMPT, new=LM_NEW, **LM_SERVE, s=serve_s,
                    first_tokens=served[0][0][:, 0].tolist()),
         prefill_ms=hist(snap, "serving.prefill_ms"),
         decode_step_ms=step_ms, knn_ms=hist(snap, "serving.knn_ms"),
         decode_tokens_per_s=LM_REQUESTS / (step_ms["mean"] / 1e3),
         readbacks_per_generate=eng.n_readbacks / LM_ROUNDS,
         stream_readbacks_per_generate=(after["readbacks"]
                                        - before["readbacks"]) / LM_ROUNDS,
         implicit_syncs_per_decode_step=syncs / LM_NEW,
         traced_decode_steps=dict(traced, steps=LM_NEW),
         knn_logprob_max_err=knn_err, knn_lambda0_equal=True,
         knn_queries_with_neighbours=knn_found,
         first_tokens_moved_by_knn=knn_moved,
         self_hits=dict(queries=len(self_ids),
                        rank0=int((got_self[:, 0] == self_ids).sum()),
                        cut_by_budget=int((got_self[:, 0] != self_ids)
                                          .sum())),
         recall_at_k=recall, recall_queries=len(q), error_ratio=ratio,
         answers_per_query=float((got >= 0).sum(1).mean()),
         launches={k: launches[k] for k in ("lsh_hash", "gather_rank",
                                            "pair_dist")},
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         s=time.perf_counter() - t_phase)
    return launches, pair_oracle


# ----------------------------------------------------------------------
# phase 11: training (the dense decoder at full width, MoE at full width)
# ----------------------------------------------------------------------
TRAIN_PARITY_ARCHS = ("smollm_135m", "llama4_scout_17b_a16e")  # reduced
TRAIN_PARITY_STEPS = 5
#: lr of the reference's resume test: Adam moves an element by ~lr
#: whatever its gradient's size, so at 1e-2 an embedding row whose
#: gradient nearly cancels moves by the sign of rounding noise
TRAIN_PARITY_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_TOL = 1e-4         # f32 losses, grad norms and params, CPU vs card
TRAIN_ARCH = "smollm_135m"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_CHUNK = 1024, 8, 512
TRAIN_STEPS, TRAIN_CUT = 20, 10
#: the full-width run cycles this many SyntheticLM batches: its next
#: token is a fixed bijection of the current one over all 49,152 ids, so
#: fresh batches teach nothing in 20 steps (the loss stays at ln 49,152,
#: 10.806-10.818, over 40 steps on an H100) while the model fits a few
#: batches it sees again (one batch repeated: 10.81 -> 8.79 in 12 steps)
TRAIN_DATA_BATCHES = 4
#: examples/train_smollm.py's optimizer (lr 6e-4, warmup max(steps // 20, 5))
TRAIN_OPT = dict(lr=6e-4, warmup_steps=5, total_steps=TRAIN_STEPS)
RESUME_TOL = 1e-3        # resumed vs uninterrupted losses (atomics on card)
MOE_ARCH = "llama4_scout_17b_a16e"
MOE_REPEATS = 1          # of its 12 repeats of 4 blocks: 4 of 48 layers
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 64, 16
MOE_DROP_LEN = 256       # one 4 x 256-token prefill: capacity-bound
#: a decode token's router logits are bf16 products whose inputs lie a
#: few bf16 ulps from the forward's (other GEMM shapes round elsewhere),
#: so where the forward's top two logits lie within this many ulps of
#: the top one the two paths may pick different experts (0-4 ulps were
#: seen on an H100)
NEAR_TIE_ULPS = 4


def route_tap(seen: list):
    """A ``tapped`` keeper for ``moe.moe_apply``: each call's routing
    (expert ids and kept pairs, on the host)."""
    def keep(p, cfg, x, *rest):
        with torch.no_grad():
            r = moe_mod.routing(p, cfg, x)
        seen.append(dict(expert=r["expert"].cpu(), keep=r["keep"].cpu(),
                         cap=r["cap"], experts=cfg.n_experts))
    return keep


def gap_tap(seen: list):
    """A ``tapped`` keeper for ``moe.moe_apply``: each call's top-k
    experts a token (sorted by id), and how far the k-th router logit
    lies above the next one, in bf16 ulps at the k-th's magnitude."""
    def keep(p, cfg, x, *rest):
        k = cfg.top_k
        with torch.no_grad():
            logits = moe_mod.dense(x.reshape(-1, x.shape[-1]),
                                   p["router"]).float()
            top = torch.sort(logits, dim=-1, descending=True, stable=True)
            _, exp = torch.frexp(top.values[:, k - 1])
            ulp = torch.ldexp(torch.ones_like(top.values[:, 0]), exp - 8)
            seen.append(dict(
                expert=torch.sort(top.indices[:, :k], dim=-1).values
                .reshape(*x.shape[:2], k).cpu(),
                gap_ulps=((top.values[:, k - 1] - top.values[:, k]) / ulp)
                .reshape(x.shape[:2]).cpu()))
    return keep


def routing_flips(path: list, fwd: list, n_layers: int) -> dict:
    """Where the prefill + decode path routed a token to another expert
    than the forward did.  ``path``: the prefill's calls (one a layer),
    then each decode step's; ``fwd``: the forward's (one a layer).
    Returns the flips (row, position, layer, the forward's gap in ulps)
    and each row's first flipped position (the row's later logits read
    that token's changed keys and values)."""
    flips, first = [], {}
    for li in range(n_layers):
        steps = [path[li]["expert"]] + [
            path[n_layers * (1 + i) + li]["expert"]
            for i in range((len(path) - n_layers) // n_layers)]
        got = torch.cat(steps, dim=1)
        want = fwd[li]["expert"][:, :got.shape[1]]
        for b, t in (got != want).any(-1).nonzero().tolist():
            flips.append((b, t, li, float(fwd[li]["gap_ulps"][b, t])))
            first[b] = min(first.get(b, t), t)
    return dict(flips=flips, first=first)


def train_parity(seed: int) -> dict:
    """TRAIN_PARITY_STEPS ``make_train_step`` steps of each reduced arch
    in f32 on the CPU and on the card (TF32 off), from the same init and
    batches: losses, grad norms and final params within TRAIN_TOL, the
    MoE routing of every call equal."""
    out = {}
    for arch in TRAIN_PARITY_ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  dtype=torch.float32)
        model = build_model(cfg)
        opt_cfg = AdamWConfig(**TRAIN_PARITY_OPT)
        data = SyntheticLM(cfg.vocab_size, 32, 4, seed=seed)
        cpu = model.init(torch.Generator().manual_seed(seed), torch.float32,
                         device="cpu")
        # the card's copy first: a step updates its params in place
        start = {"cpu": cpu, DEVICE: convert.params_from_numpy(
            cfg, convert.params_to_numpy(cpu), device=DEVICE)}
        runs = {}
        for dev, params in start.items():
            step = make_train_step(model, None, opt_cfg, 16)
            opt = adamw_init(opt_cfg, param_dict(params))
            metrics, routes = [], []
            with tapped(moe_mod, "moe_apply", route_tap(routes)):
                for i in range(TRAIN_PARITY_STEPS):
                    batch = {k: torch.from_numpy(v).to(dev)
                             for k, v in data.batch(i).items()}
                    params, opt, m = step(params, opt, batch)
                    metrics.append((float(m["loss"]),
                                    float(m["grad_norm"])))
            runs[dev] = (metrics, routes,
                         [t.cpu() for t in tree_leaves(param_dict(params))])
        (m0, r0, p0), (m1, r1, p1) = runs["cpu"], runs[DEVICE]
        err = max(abs(a - b) / abs(a) for x, y in zip(m0, m1)
                  for a, b in zip(x, y))
        check(err <= TRAIN_TOL, f"{arch}: train metrics CPU vs card {err}")
        perr = max(float((b - a).norm() / a.norm()) for a, b in zip(p0, p1))
        check(perr <= TRAIN_TOL, f"{arch}: params CPU vs card {perr}")
        check(len(r0) == len(r1), f"{arch}: MoE calls differ")
        for a, b in zip(r0, r1):
            check(torch.equal(a["expert"], b["expert"])
                  and torch.equal(a["keep"], b["keep"]),
                  f"{arch}: MoE routing differs CPU vs card")
        out[arch] = dict(losses=[x for x, _ in m1], metric_max_rel_err=err,
                         param_max_rel_err=perr, moe_calls=len(r1))
    return out


@dataclasses.dataclass
class Cycled:
    """A data stream that replays the first ``n`` batches of another,
    still a pure function of the step (a restart replays it)."""
    data: SyntheticLM
    n: int

    def batch(self, step: int) -> dict:
        return self.data.batch(step % self.n)


def train_state_equal(a_params, a_opt, b_params, b_opt) -> int:
    """Every leaf of two train states equal bit for bit; the count."""
    return leaves_equal(train_loop.state_tree(a_params, a_opt),
                        train_loop.state_tree(b_params, b_opt))


def train_full_width(args, tmp: str) -> dict:
    """smollm_135m at its published widths through ``Trainer`` on the
    card: TRAIN_STEPS steps uninterrupted, then a run cut at TRAIN_CUT
    and one resumed from its checkpoint."""
    cfg = configs.get_config(TRAIN_ARCH)
    model = build_model(cfg)
    data = Cycled(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                              seed=args.seed), TRAIN_DATA_BATCHES)

    def trainer(steps, ckpt_every, sub):
        t = Trainer(model, data, TrainConfig(
            steps=steps, ckpt_every=ckpt_every, log_every=10 ** 9,
            ckpt_dir=os.path.join(tmp, sub), loss_chunk=TRAIN_CHUNK,
            seed=args.seed, opt=AdamWConfig(**TRAIN_OPT)))
        check(t.device.type == "cuda", "the trainer left the card")
        return t

    times, gnorms, saves, loads = [], [], [], []

    def timed_steps(t):
        real = t.step_fn

        def step(params, opt, batch):
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            out = real(params, opt, batch)
            e1.record()
            times.append((e0, e1))
            gnorms.append(out[2]["grad_norm"])
            return out
        t.step_fn = step
        return real

    real_save = train_loop.save_train_checkpoint

    def save(ckpt_dir, step, params, opt, extra=None):
        t0 = time.perf_counter()
        path = real_save(ckpt_dir, step, params, opt, extra)
        saves.append(dict(step=step, s=time.perf_counter() - t0,
                          bytes=dir_bytes(path)))
        return path

    torch.cuda.reset_peak_memory_stats()
    train_loop.save_train_checkpoint = save
    try:
        full = trainer(TRAIN_STEPS, TRAIN_STEPS, "full")
        real_step = timed_steps(full)
        t0 = time.perf_counter()
        ref = full.run(resume=False)
        full_s = time.perf_counter() - t0
        step_ms = [e0.elapsed_time(e1) for e0, e1 in times]
        gn = [float(g) for g in gnorms]
        peak = torch.cuda.max_memory_allocated()

        cut = trainer(TRAIN_CUT, TRAIN_CUT, "cut")
        part = cut.run(resume=False)
        real_restore = train_loop.restore_train_checkpoint

        def restore(ckpt_dir, step, params, opt):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = real_restore(ckpt_dir, step, params, opt)
            torch.cuda.synchronize()
            loads.append(dict(step=step, s=time.perf_counter() - t0,
                              leaves_equal=train_state_equal(
                                  got[0], got[1], part["params"],
                                  part["opt"])))
            return got

        train_loop.restore_train_checkpoint = restore
        try:
            resumed = trainer(TRAIN_STEPS, TRAIN_CUT, "cut").run(resume=True)
        finally:
            train_loop.restore_train_checkpoint = real_restore
    finally:
        train_loop.save_train_checkpoint = real_save
    check(len(loads) == 1 and loads[0]["step"] == TRAIN_CUT,
          f"the resumed run did not restore step {TRAIN_CUT}: {loads}")
    losses = ref["losses"]
    check(all(np.isfinite(losses)), f"a loss is not finite: {losses}")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          f"the loss did not fall: {losses}")
    check(np.allclose(part["losses"], losses[:TRAIN_CUT], rtol=RESUME_TOL,
                      atol=0),
          "the cut run's losses differ from the uninterrupted run's")
    resume_err = max(abs(a - b) / abs(b) for a, b in
                     zip(resumed["losses"], losses[TRAIN_CUT:]))
    check(len(resumed["losses"]) == TRAIN_STEPS - TRAIN_CUT
          and resume_err <= RESUME_TOL,
          f"resumed losses differ by {resume_err} (> {RESUME_TOL})")

    # one more step of the uninterrupted run's state: the syncs no one
    # counted, then one traced
    params, opt = ref["params"], ref["opt"]
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in
                data.batch(TRAIN_STEPS + i).items()} for i in range(2)]
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, opt, _ = real_step(params, opt, batches[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    traced = device_profile(lambda: real_step(params, opt, batches[1]))
    n_params = sum(p.numel() for p in ref["params"].parameters())
    steady = sorted(step_ms[1:])
    return dict(
        arch=TRAIN_ARCH, params=n_params, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.vocab_size, seq=TRAIN_SEQ,
        batch=TRAIN_BATCH, loss_chunk=TRAIN_CHUNK, opt=TRAIN_OPT,
        param_dtype="float32", compute_dtype="bfloat16", master=True,
        remat=True, steps=TRAIN_STEPS, losses=losses, grad_norms=gn,
        first_step_ms=step_ms[0],
        step_ms=dict(p50=float(np.percentile(steady, 50)),
                     p99=float(np.percentile(steady, 99)),
                     mean=float(np.mean(steady)), n=len(steady)),
        tokens_per_s=TRAIN_SEQ * TRAIN_BATCH
        / (float(np.percentile(steady, 50)) / 1e3),
        run_s=full_s, resumed_losses=resumed["losses"],
        resume_max_rel_err=resume_err, checkpoint_saves=saves,
        checkpoint_load=loads[0], peak_mem_bytes=peak,
        implicit_syncs_per_step=syncs, traced_step=traced,
        launches_per_step=traced["launches"])


def moe_full_width(args) -> dict:
    """llama4_scout_17b_a16e at its published widths, one repeat of its
    4-block pattern, bf16 weights drawn on the card: prefill, decode
    steps held to a forward over the same tokens, the routing of every
    MoE call; then one capacity-bound prefill's dropped pairs."""
    full = configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=4 * MOE_REPEATS,
                              groups=((full.groups[0][0], MOE_REPEATS),))
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(
        args.seed), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(params.embed.dtype == torch.bfloat16 and params.embed.is_cuda,
          "the MoE model is not bf16 on the card")
    g = torch.Generator(device=DEVICE).manual_seed(args.seed + 7)
    total = MOE_PROMPT + MOE_NEW
    toks = torch.randint(0, cfg.vocab_size, (MOE_BATCH, total), generator=g,
                         device=DEVICE, dtype=torch.int32)

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    pre_routes, dec_routes, drop_routes = [], [], []
    path_gaps, fwd_gaps = [], []
    with torch.no_grad():
        cache = model.init_cache(MOE_BATCH, total, device=DEVICE)
        with tapped(moe_mod, "moe_apply", route_tap(pre_routes)), \
                tapped(moe_mod, "moe_apply", gap_tap(path_gaps)):
            e0 = ev()
            first, cache, _ = model.prefill(
                params, {"tokens": toks[:, :MOE_PROMPT]}, cache)
            e1 = ev()
        logits, step_ev = [first], []
        with tapped(moe_mod, "moe_apply", route_tap(dec_routes)), \
                tapped(moe_mod, "moe_apply", gap_tap(path_gaps)):
            for i in range(MOE_NEW):
                pos = MOE_PROMPT + i
                a = ev()
                out, cache = model.decode_step(
                    params, toks[:, pos:pos + 1], cache, pos)
                step_ev.append((a, ev()))
                logits.append(out)
        torch.cuda.synchronize()
        prefill_ms = e0.elapsed_time(e1)
        dec_ms = sorted(a.elapsed_time(b) for a, b in step_ev)
        del cache
        with tapped(moe_mod, "moe_apply", gap_tap(fwd_gaps)):
            hidden, _ = model.forward(params, {"tokens": toks})
        want = model.logits(params, hidden[:, MOE_PROMPT - 1:]).float()
        got = torch.cat(logits, dim=1).float()
        # per (row, position): max abs and relative error in norm
        abs_err = (got - want).abs().amax(-1).cpu()
        rel_err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).cpu()
        del hidden, want, got, logits, first, out
        long = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_DROP_LEN),
                             generator=g, device=DEVICE, dtype=torch.int32)
        with tapped(moe_mod, "moe_apply", route_tap(drop_routes)):
            model.forward(params, {"tokens": long})
        torch.cuda.synchronize()
    n_moe = 4 * MOE_REPEATS
    check(len(pre_routes) == n_moe and len(dec_routes) == n_moe * MOE_NEW
          and len(drop_routes) == n_moe, "MoE calls missing from the taps")
    # decode == forward: every position whose row routed alike up to it
    # within BF16_TOL (relative in norm, the bf16 rule of the models'
    # parity tests); a token routed to another expert only at a near
    # tie, or in a layer after its first flip (its state had moved)
    fl = routing_flips(path_gaps, fwd_gaps, n_moe)
    for b, t, li, gap in fl["flips"]:
        earlier = any(b2 == b and t2 == t and l2 < li
                      for b2, t2, l2, _ in fl["flips"])
        check(gap <= NEAR_TIE_ULPS or earlier,
              f"MoE at full width: row {b} position {t} layer {li} routed "
              f"apart from the forward {gap} ulps from a tie")
    clean = torch.zeros_like(rel_err, dtype=torch.bool)
    for b in range(MOE_BATCH):
        for j in range(MOE_NEW + 1):
            clean[b, j] = MOE_PROMPT - 1 + j < fl["first"].get(b, total)
    dec_err = float(rel_err[clean].max())
    check(bool(clean[:, 0].all()) and dec_err <= BF16_TOL,
          f"MoE at full width: decode differs from forward by {dec_err} "
          f"(relative in norm) where the routing agreed")
    dec_drops = sum(int((~r["keep"]).sum()) for r in dec_routes)
    check(dec_drops == 0, f"{dec_drops} pairs dropped at decode")

    def per_expert(routes):
        n = torch.zeros(cfg.n_experts, dtype=torch.int64)
        for r in routes:
            n += torch.bincount(r["expert"][r["keep"]],
                                minlength=cfg.n_experts)
        return n.tolist()

    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    return dict(
        arch=MOE_ARCH, params=n_params, layers=cfg.layer_count(),
        published_layers=full.layer_count(), d_model=cfg.d_model,
        experts=cfg.n_experts, top_k=cfg.top_k,
        shared_experts=cfg.n_shared_experts, moe_d_ff=cfg.moe_d_ff,
        vocab=cfg.vocab_size, dtype="bfloat16", init_s=init_s,
        batch=MOE_BATCH, prompt=MOE_PROMPT, new=MOE_NEW,
        prefill_ms=prefill_ms,
        decode_step_ms=dict(p50=float(np.percentile(dec_ms, 50)),
                            p99=float(np.percentile(dec_ms, 99)),
                            mean=float(np.mean(dec_ms))),
        decode_vs_forward=dict(
            rel_err_max=dec_err, positions_held=int(clean.sum()),
            positions=int(clean.numel()),
            max_abs_err_held=float(abs_err[clean].max()),
            rel_err=rel_err.tolist(), routing_flips=fl["flips"]),
        decode_dropped_pairs=dec_drops,
        prefill_capacity=pre_routes[0]["cap"],
        prefill_tokens_per_expert=per_expert(pre_routes),
        decode_tokens_per_expert=per_expert(dec_routes),
        capacity_bound=dict(
            tokens=MOE_BATCH * MOE_DROP_LEN, capacity=drop_routes[0]["cap"],
            dropped_pairs=[int((~r["keep"]).sum()) for r in drop_routes],
            pairs_per_layer=int(drop_routes[0]["keep"].numel())),
        peak_mem_bytes=peak)


def phase_train(args, card: str) -> None:
    """Training: (a) CPU == card on reduced configs, (b) the dense
    decoder at full width through ``Trainer`` with a restart, (c) the MoE
    decoder at full width (depth cut).  No kernel of the six runs here."""
    t_phase = time.perf_counter()
    ops.reset_launches()
    t0 = time.perf_counter()
    parity = train_parity(args.seed)
    parity_s = time.perf_counter() - t0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        dense = train_full_width(args, tmp)
        dense_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe = moe_full_width(args)
    moe_s = time.perf_counter() - t0
    check(not any(ops.LAUNCHES.values()),
          f"the train path launched a PFO kernel: {dict(ops.LAUNCHES)}")
    emit(phase="train", card=card, cpu_vs_card=parity,
         cpu_vs_card_s=parity_s, dense=dict(dense, s=dense_s),
         moe=dict(moe, s=moe_s), s=time.perf_counter() - t_phase)


# ----------------------------------------------------------------------
# phase 12: the remaining block kinds (MLA, RWKV-6, RG-LRU, the encoder)
# ----------------------------------------------------------------------
FAMILY_ARCHS = ("deepseek_v2_236b", "rwkv6_7b", "recurrentgemma_9b",
                "whisper_medium")
#: the reference initialises many of these blocks' leaves to zero (RG-LRU's
#: conv_w = 0 zeroes its whole branch): they are drawn with this std
FAMILY_ZEROS_STD = 0.1
FAMILY_PARITY_T = 12     # tokens of the reduced CPU == card checks
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_NEW = 4, 64, 16
FAMILY_ROUNDS = 2        # served rounds (the first warms the card up)
FAMILY_FILL = (4, 256)   # SyntheticLM sequences x tokens: 1,024 memories
#: a deep recurrent stack's bf16 decode drifts from its forward as it
#: goes (a 4-row product rounds elsewhere than the forward's, and the
#: state carries the difference on): the JAX package's own bf16 decode
#: drifts past 3e-2 at d = 1,024 x 8 layers, where both packages' f32
#: decodes stay within 1e-5 (``python3 tests/test_torch_recurrent.py``),
#: so RWKV-6 and RG-LRU hold decode == forward in f32 (the same weights,
#: unrounded) within this, and report their bf16 drift by step
F32_DECODE_TOL = 1e-3
#: deepseek_v2's decode == forward check runs 4 x (4 + 16) tokens: 480
#: (token, expert) pairs, under the exact-capacity limit (512), so no
#: pair drops in the prefill, the decode steps or the forward (at the
#: served 4 x 64 prompt a prefill drops pairs a longer forward keeps)
FAMILY_MOE_PROMPT = 4


def draw_zero_leaves(model, params, generator: torch.Generator,
                     std: float = FAMILY_ZEROS_STD) -> None:
    """Redraw in place, normal with ``std`` from ``generator``, every leaf
    of ``params`` (``model.init``'s) whose spec initialises it to zero,
    in the spec tree's sorted key order, layer by layer."""
    def walk(spec, leaf):
        if isinstance(spec, ParamSpec):
            if spec.init == "zeros":
                leaf.normal_(0.0, std, generator=generator)
        elif isinstance(spec, dict):
            for k in sorted(spec):
                walk(spec[k], leaf[k])
        else:
            for s, t in zip(spec, leaf):
                walk(s, t)

    tree = param_dict(params)
    with torch.no_grad():
        for key in sorted(model.param_specs):
            if key in GROUP_KEYS:
                for spec, layers in zip(model.param_specs[key], tree[key]):
                    for layer in layers:
                        walk(spec, layer)
            else:
                walk(model.param_specs[key], tree[key])


def family_init(model, seed: int, device):
    """``model.init`` on a generator seeded ``seed`` on ``device``, then
    its zero-init leaves drawn from the same generator."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = model.init(g, device=device)
    draw_zero_leaves(model, params, g)
    return params


def family_config(arch: str):
    """The published config, with deepseek_v2's depth cut to its dense
    layer 0 and one MoE layer (2 of 60: ~5.4 B params, ~11 GB bf16)."""
    full = configs.get_config(arch)
    if arch != "deepseek_v2_236b":
        return full
    (dense, _), (moe, _) = full.groups
    return dataclasses.replace(full, n_layers=2,
                               groups=((dense, 1), (moe, 1)))


def family_features(cfg, batch: int, seed: int, device) -> dict:
    """An encoder-decoder's stub frame embeddings (B, enc_len, d_model),
    drawn from a seeded generator; nothing for a decoder."""
    if cfg.frontend != "audio":
        return {}
    g = torch.Generator(device=device).manual_seed(seed)
    return {"features": torch.randn((batch, cfg.enc_len, cfg.d_model),
                                    generator=g, device=device)}


def cache_tensors(tree) -> list:
    """Every tensor of a cache tree (KV caches, recurrent states, cross
    keys and values), in a fixed order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in cache_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in cache_tensors(v)]
    return []                                   # a cache's host length


def family_parity(seed: int) -> dict:
    """Each reduced family in f32 with its zero-init leaves drawn, the
    same weights on the CPU and on the card (TF32 off): forward, prefill
    and decode logits and every cache and state tensor after the prefill
    within MODEL_TOL; one train step's loss and grad norm within
    TRAIN_TOL (relative) and the MoE routing equal."""
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                                  dtype=torch.float32)
        model = build_model(cfg)
        cpu = family_init(model, seed, "cpu")
        card = convert.params_from_numpy(cfg, convert.params_to_numpy(cpu),
                                         device=DEVICE)
        text = SyntheticLM(cfg.vocab_size, FAMILY_PARITY_T, 2,
                           seed=seed).batch(0)
        got, train = {}, {}
        for dev, params in (("cpu", cpu), (DEVICE, card)):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in text.items()}
            batch.update(family_features(cfg, 2, seed, "cpu"))
            batch = {k: v.to(dev) for k, v in batch.items()}
            inputs = {k: v for k, v in batch.items() if k != "labels"}
            hidden, _ = model.forward(params, inputs)
            cache = model.init_cache(2, FAMILY_PARITY_T + 1, device=dev)
            pl, cache, _ = model.prefill(params, inputs, cache)
            # copies: the decode step writes the KV caches in place
            states = [t.to("cpu", copy=True) for t in cache_tensors(cache)]
            dl, _ = model.decode_step(params, batch["tokens"][:, :1], cache,
                                      FAMILY_PARITY_T)
            got[dev] = [t.cpu() for t in (hidden, pl, dl)] + states
            opt_cfg = AdamWConfig(**TRAIN_PARITY_OPT)
            routes = []
            step = make_train_step(model, None, opt_cfg, 4)
            copy = convert.params_from_numpy(
                cfg, convert.params_to_numpy(params), device=dev)
            with tapped(moe_mod, "moe_apply", route_tap(routes)):
                _, _, m = step(copy, adamw_init(opt_cfg, param_dict(copy)),
                               batch)
            train[dev] = (float(m["loss"]), float(m["grad_norm"]), routes)
        err = max(float((a - b).abs().max())
                  for a, b in zip(got["cpu"], got[DEVICE]))
        check(len(got["cpu"]) == len(got[DEVICE]) and err <= MODEL_TOL,
              f"{arch}: logits or caches CPU vs card {err}")
        (l0, g0, r0), (l1, g1, r1) = train["cpu"], train[DEVICE]
        terr = max(abs(l1 - l0) / abs(l0), abs(g1 - g0) / abs(g0))
        check(terr <= TRAIN_TOL, f"{arch}: train step CPU vs card {terr}")
        check(len(r0) == len(r1) and all(
            torch.equal(a["expert"], b["expert"])
            and torch.equal(a["keep"], b["keep"]) for a, b in zip(r0, r1)),
            f"{arch}: MoE routing differs CPU vs card")
        out[arch] = dict(max_abs_err=err, tensors=len(got[DEVICE]),
                         train_rel_err=terr, loss=l1, moe_calls=len(r1))
    return out


def family_decode_vs_forward(model, params, arch: str, seed: int,
                             tol: float | None = BF16_TOL) -> dict:
    """Prefill, then FAMILY_NEW decode steps over given tokens, against
    one forward over all of them: the relative error in norm of each
    decoded position's logits, held within ``tol`` (None: reported
    only).  For an MoE model only positions whose row routed alike up to
    them are held, and every routing difference must sit at a near tie
    (the llama4 rule of ``moe_full_width``)."""
    cfg = model.cfg
    moe = cfg.n_experts > 0
    prompt = FAMILY_MOE_PROMPT if moe else FAMILY_PROMPT
    total = prompt + FAMILY_NEW
    g = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    toks = torch.randint(0, cfg.vocab_size, (FAMILY_BATCH, total),
                         generator=g, device=DEVICE, dtype=torch.int32)
    feats = family_features(cfg, FAMILY_BATCH, seed + 12, DEVICE)
    path_gaps, fwd_gaps = [], []
    with torch.no_grad(), tapped(moe_mod, "moe_apply", gap_tap(path_gaps)):
        cache = model.init_cache(FAMILY_BATCH, total, device=DEVICE)
        first, cache, _ = model.prefill(
            params, {"tokens": toks[:, :prompt], **feats}, cache)
        logits = [first]
        for i in range(FAMILY_NEW - 1):
            pos = prompt + i
            out, cache = model.decode_step(params, toks[:, pos:pos + 1],
                                           cache, pos)
            logits.append(out)
        del cache
    with torch.no_grad(), tapped(moe_mod, "moe_apply", gap_tap(fwd_gaps)):
        hidden, _ = model.forward(params, {"tokens": toks[:, :-1], **feats})
        want = model.logits(params, hidden[:, prompt - 1:]).float()
    got = torch.cat(logits, dim=1).float()
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).cpu()
    held = torch.ones_like(rel, dtype=torch.bool)
    flips = []
    if moe:
        n_moe = sum(len(p) * r for p, r in cfg.groups if p[0].moe)
        fl = routing_flips(path_gaps, fwd_gaps, n_moe)
        flips = fl["flips"]
        for b, t, li, gap in flips:
            earlier = any(b2 == b and t2 == t and l2 < li
                          for b2, t2, l2, _ in flips)
            check(gap <= NEAR_TIE_ULPS or earlier,
                  f"{arch}: row {b} position {t} layer {li} routed apart "
                  f"from the forward {gap} ulps from a tie")
        for b in range(FAMILY_BATCH):
            for j in range(FAMILY_NEW):
                held[b, j] = prompt - 1 + j < fl["first"].get(b, total)
    err = float(rel[held].max())
    check(bool(held[:, 0].all()) and (tol is None or err <= tol),
          f"{arch}: decode differs from forward by {err} (relative in "
          f"norm, {cfg.dtype})")
    return dict(dtype=str(cfg.dtype).split(".")[-1], rel_err_max=err,
                rel_err_by_step=rel.amax(0).tolist(), tol=tol,
                positions_held=int(held.sum()), positions=int(held.numel()),
                prompt=prompt, routing_flips=flips)


def family_full_width(arch: str, seed: int) -> tuple:
    """One family at its published widths (``family_config``), bf16
    weights drawn on the card with the zero-init leaves drawn too, behind
    ``ServingEngine`` with the PFO kNN-LM head: a datastore of the
    model's own hidden states over SyntheticLM text (one insert call, the
    ``lm`` phase's index config at this d_model), FAMILY_ROUNDS rounds of
    FAMILY_BATCH requests (prompt FAMILY_PROMPT, FAMILY_NEW new tokens;
    whisper with its 1,500 frames), decode == forward, one decode step
    traced.  The launch counts are set to 0 before the datastore's fill
    and read after the served rounds; lsh_hash's and gather_rank's inputs
    are tapped there and held against their plain versions after."""
    cfg = family_config(arch)
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_arch = t0 = time.perf_counter()
    params = family_init(model, seed, DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(params.embed.dtype == torch.bfloat16 and params.embed.is_cuda,
          f"{arch}: the model is not bf16 on the card")

    n_seq, n_tok = FAMILY_FILL
    text = SyntheticLM(cfg.vocab_size, n_tok, n_seq, seed=seed).batch(0)
    pcfg = PFOConfig(dim=cfg.d_model, **LM_DATASTORE)
    idx = PFOIndex(pcfg, seed=seed, device=DEVICE)
    vmap = np.zeros(pcfg.store_capacity, np.int32)
    vmap[:n_seq * n_tok] = text["labels"].reshape(-1)
    fill_in, knn_in = {}, {}
    torch.cuda.synchronize()
    ops.reset_launches()                          # counts start here ...
    t0 = time.perf_counter()
    with torch.no_grad(), \
            tapped(ops, "lsh_hash", tap_first(fill_in, "lsh_hash")):
        hid, _ = model.forward(params, {
            "tokens": torch.from_numpy(text["tokens"]).to(DEVICE),
            **family_features(cfg, n_seq, seed + 1, DEVICE)})
        mem = hid.float().reshape(-1, cfg.d_model)
        del hid
        idx.insert(np.arange(len(mem), dtype=np.int32), mem)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    check(idx.n_inserted == len(mem) and idx.stats()["overflow_events"] == 0,
          f"{arch}: the datastore's fill lost memories")

    stream = StreamEngine(idx)
    stream.warmup()
    eng = ServingEngine(model, params, ServeConfig(**LM_SERVE),
                        pfo_stream=stream, knn_vocab_map=vmap)
    feats = family_features(cfg, FAMILY_BATCH, seed + 2, DEVICE)
    served, prefill_ms, step_ms = [], [], []
    with torch.no_grad(), \
            tapped(ops, "lsh_hash", tap_first(knn_in, "lsh_hash")), \
            tapped(ops, "gather_rank", tap_first(knn_in, "gather_rank")):
        for r in range(FAMILY_ROUNDS):
            eng.obs = Obs()                       # this round's clock only
            prompt = SyntheticLM(cfg.vocab_size, FAMILY_PROMPT, FAMILY_BATCH,
                                 seed=seed + 3).batch(r)["tokens"]
            served.append(eng.generate({"tokens": prompt, **feats},
                                       max_new=FAMILY_NEW))
            snap = eng.obs.snapshot()
            prefill_ms.append(hist(snap, "serving.prefill_ms")["mean"])
            step_ms.append(snap["histograms"]["serving.decode_step_ms"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)                 # ... and stop here
    for name in ("lsh_hash", "gather_rank"):
        check(launches[name] > 0, f"{arch}: no {name} launch: {launches}")
    out, stats = served[-1]
    check(out.shape == (FAMILY_BATCH, FAMILY_NEW)
          and ((0 <= out) & (out < cfg.vocab_size)).all(),
          f"{arch}: generated tokens out of range")
    check(stats["datastore_size"] == len(mem) + FAMILY_ROUNDS * FAMILY_BATCH,
          f"{arch}: online inserts missing: {stats}")

    # one decode step traced: launches and the card's idle share
    with torch.no_grad():
        c = model.init_cache(FAMILY_BATCH, FAMILY_PROMPT + 2, device=DEVICE)
        prompt = torch.from_numpy(prompt).to(DEVICE)
        logits, c, _ = model.prefill(params, {"tokens": prompt, **feats}, c)
        tok = torch.argmax(logits[:, 0], -1).to(torch.int32)[:, None]
        traced = device_profile(lambda: model.decode_step(
            params, tok, c, FAMILY_PROMPT))
        del c
    peak = torch.cuda.max_memory_allocated()

    recurrent = any(b.kind in ("rwkv", "rglru")
                    for pat, _ in cfg.groups for b in pat)
    dvf = [family_decode_vs_forward(model, params, arch, seed,
                                    None if recurrent else BF16_TOL)]
    if recurrent:                     # held in f32 (F32_DECODE_TOL)
        del params, eng
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        model32 = build_model(cfg32)
        params = family_init(model32, seed, DEVICE)
        dvf.append(family_decode_vs_forward(model32, params, arch, seed,
                                            F32_DECODE_TOL))

    # the kNN head's kernels at this d_model, held and timed
    x, a_proj = fill_in["lsh_hash"][:2]
    check(list(x.shape) == [len(mem), cfg.d_model],
          f"{arch}: lsh_hash tapped off the fill's shape {list(x.shape)}")
    kernels = dict(lsh_hash_fill=lsh_hash_at(x, a_proj, rounding=True))
    x, a_proj = knn_in["lsh_hash"][:2]
    kernels["lsh_hash_knn"] = lsh_hash_at(x, a_proj, rounding=True)
    kernels["gather_rank_knn"] = gather_rank_at(*knn_in["gather_rank"][:5])
    check(kernels["gather_rank_knn"]["shape"][2] == cfg.d_model,
          f"{arch}: gather_rank tapped off the kNN query")
    del fill_in, knn_in, x, a_proj, mem, stream, idx, params
    torch.cuda.empty_cache()

    def steps(h):
        return dict(p50=h["p50"], p99=h["p99"], mean=h["mean"],
                    n=h["count"])
    full = configs.get_config(arch)
    return dict(
        arch=arch, params=n_params, layers=cfg.layer_count(),
        published_layers=full.layer_count(), d_model=cfg.d_model,
        vocab=cfg.vocab_size, dtype="bfloat16", zeros_std=FAMILY_ZEROS_STD,
        init_s=init_s, memories=n_seq * n_tok, fill_s=fill_s,
        batch=FAMILY_BATCH, prompt=FAMILY_PROMPT, new=FAMILY_NEW,
        enc_len=cfg.enc_len or None, **LM_SERVE,
        prefill_ms=prefill_ms, decode_step_ms=[steps(h) for h in step_ms],
        decode_vs_forward=dvf, launches_per_decode_step=traced["launches"],
        traced_decode_step=traced, launches=dict(
            lsh_hash=launches["lsh_hash"],
            gather_rank=launches["gather_rank"]),
        first_tokens=out[:, 0].tolist(), peak_mem_bytes=peak,
        kernels=kernels, s=time.perf_counter() - t_arch), launches


def phase_families(args, card: str, rows: list) -> None:
    """The remaining block kinds: (a) the four reduced families CPU ==
    card in f32; (b) each at its published widths (deepseek_v2 cut to 2
    of 60 layers) behind the kNN-LM ``ServingEngine``.  Their kNN heads'
    lsh_hash and gather_rank launches and timings at each d_model go into
    the kernel rows as ``families``."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    parity = family_parity(args.seed)
    emit(phase="families_cpu_vs_card", card=card, results=parity,
         s=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    full, total = {}, {"lsh_hash": 0, "gather_rank": 0}
    for arch in FAMILY_ARCHS:
        full[arch], launches = family_full_width(arch, args.seed)
        for name in total:
            total[name] += launches[name]
        emit(phase="family", card=card, **{k: v for k, v in
                                           full[arch].items()
                                           if k != "kernels"})
    for row in rows[:2]:
        name = row["name"]
        row.setdefault("launches_by_path", {})["families"] = total[name]
        row["families"] = {
            arch: dict({k: v for k, v in f["kernels"].items()
                        if k.startswith(name)},
                       launches=f["launches"][name], d=f["d_model"])
            for arch, f in full.items()}
    emit(phase="families", card=card, archs=list(full),
         kernels={a: f["kernels"] for a, f in full.items()},
         launches=total, s=time.perf_counter() - t_phase)


# ----------------------------------------------------------------------
# phase 13: the LM stack's sharding on a one-rank NCCL DeviceMesh
# ----------------------------------------------------------------------
SHARD_ARCH = "smollm_135m"
SHARD_FILL = (4, 256)        # SyntheticLM sequences x tokens: 1,024 memories
SHARD_REQUESTS, SHARD_PROMPT, SHARD_NEW = 4, 16, 16
SHARD_TOL = 1e-5             # sharded vs unsharded, relative in norm (f32)
SHARD_BF16_ROUNDS = 2        # bf16 rounds a side (the first warms up)
SHARD_TRAIN = (256, 4)       # SyntheticLM tokens x sequences a step
SHARD_TRAIN_STEPS = 3
SHARD_MOE_BATCH, SHARD_MOE_LEN = 4, 64
SHARD_DRYRUN = ("llama4_scout_17b_a16e", "decode_32k")


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def one_rank_mesh():
    """The ``(data, model)`` = (1, 1) DeviceMesh over the one-rank NCCL
    group: every rule resolves to a replicated placement (a mesh axis of
    size 1 is dropped), the same code as on a larger mesh."""
    from torch.distributed.tensor import DeviceMesh
    torch.cuda.set_device(0)
    return DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))


def shard_datastore(d: int, mem: torch.Tensor, labels: np.ndarray,
                    seed: int) -> tuple:
    """A datastore of ``mem`` -> ``labels`` (the ``lm`` phase's index
    config at dimension ``d``) behind a warmed ``StreamEngine``, and its
    vocab map."""
    pcfg = PFOConfig(dim=d, **LM_DATASTORE)
    idx = PFOIndex(pcfg, seed=seed, device=DEVICE)
    idx.insert(np.arange(len(mem), dtype=np.int32), mem)
    vmap = np.zeros(pcfg.store_capacity, np.int32)
    vmap[:len(mem)] = labels
    stream = StreamEngine(idx)
    stream.warmup()
    return stream, vmap


def served_logits(eng, prompt: np.ndarray) -> tuple:
    """One round with no online inserts (so engines sharing a datastore
    see the same one): the tokens, and the logits of every step (the
    prefill's and each decode step's, tapped where the engine picks its
    token)."""
    seen = []
    with torch.no_grad(), tapped(eng, "_next_token",
                                 lambda logits, hidden: seen.append(
                                     logits.float().clone())):
        out, _ = eng.generate({"tokens": prompt}, max_new=SHARD_NEW,
                              insert_online=False)
    return out, seen


def sharded_serving(args, mesh) -> dict:
    """(a) smollm_135m at published widths: one f32 round through the
    sharded engine against the unsharded engine on the same params and
    datastore, then the decode-step clock of both in bf16."""
    from repro_torch.sharding.policy import make_policy
    base = configs.get_config(SHARD_ARCH)
    cfg = dataclasses.replace(base, dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(
        args.seed), torch.float32, device=DEVICE)
    n_seq, n_tok = SHARD_FILL
    text = SyntheticLM(cfg.vocab_size, n_tok, n_seq, seed=args.seed).batch(0)
    with torch.no_grad():
        hid, _ = model.forward(params, {"tokens": torch.from_numpy(
            text["tokens"]).to(DEVICE)})
    mem = hid.float().reshape(-1, cfg.d_model)
    del hid
    stream, vmap = shard_datastore(cfg.d_model, mem,
                                   text["labels"].reshape(-1), args.seed)
    prompt = SyntheticLM(cfg.vocab_size, SHARD_PROMPT, SHARD_REQUESTS,
                         seed=args.seed + 3).batch(0)["tokens"]

    def engine(model, params, policy=None):
        return ServingEngine(model, params, ServeConfig(**LM_SERVE),
                             policy=policy, pfo_stream=stream,
                             knn_vocab_map=vmap)

    want_tok, want = served_logits(engine(model, params), prompt)
    policy = make_policy(mesh, cfg, "serve", param_specs=model.param_specs)
    eng = engine(model, params, policy)
    torch.cuda.synchronize()
    ops.reset_launches()                        # counts start here ...
    got_tok, got = served_logits(eng, prompt)
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in ("lsh_hash", "gather_rank")}
    for name, n in launches.items():          # ... and stop here
        check(n > 0, f"sharded serving: no {name} launch: {launches}")
    check(len(got) == len(want) == SHARD_NEW + 1,
          f"sharded serving: {len(got)} logit steps, {len(want)} unsharded")
    errs = [rel_norm(a, b) for a, b in zip(got, want)]
    check(max(errs) <= SHARD_TOL,
          f"sharded logits off the unsharded ones: {max(errs)}")
    check(np.array_equal(got_tok, want_tok), "sharded tokens differ")
    n_dtensor = sum(1 for t in tree_leaves(param_dict(eng.params))
                    if hasattr(t, "placements"))
    del eng, params, model
    torch.cuda.empty_cache()

    # bf16: the host cost of DTensor dispatch in a decode step
    model = build_model(base)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(
        args.seed), device=DEVICE)
    clock = {}
    for name, pol in (("plain", None), ("policy", make_policy(
            mesh, base, "serve", param_specs=model.param_specs))):
        e = engine(model, params, pol)
        with torch.no_grad():
            for _ in range(SHARD_BF16_ROUNDS):
                e.obs = Obs()
                e.generate({"tokens": prompt}, max_new=SHARD_NEW,
                           insert_online=False)
        h = e.obs.snapshot()["histograms"]["serving.decode_step_ms"]
        clock[name] = dict(p50=h["p50"], p99=h["p99"], mean=h["mean"],
                           n=h["count"])
        del e
    del params, model, stream
    torch.cuda.empty_cache()
    return dict(arch=SHARD_ARCH, memories=len(mem), requests=SHARD_REQUESTS,
                prompt=SHARD_PROMPT, new=SHARD_NEW, f32_max_rel=max(errs),
                tokens_equal=True, dtensor_leaves=n_dtensor,
                launches=launches, bf16_decode_step_ms=clock,
                dtensor_host_cost=clock["policy"]["p50"]
                / max(clock["plain"]["p50"], 1e-9)), launches


def sharded_training(args, mesh, tmp: str) -> dict:
    """(b) smollm_135m at published widths through ``Trainer(policy=)``
    against the unsharded trainer from the same state, then the sharded
    trainer's checkpoint into an unsharded ``Trainer``, bit for bit."""
    from repro_torch.sharding.policy import make_policy
    cfg = configs.get_config(SHARD_ARCH)
    model = build_model(cfg)
    seq, batch = SHARD_TRAIN
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=args.seed)

    def trainer(name, policy=None):
        tcfg = TrainConfig(steps=SHARD_TRAIN_STEPS, ckpt_every=10 ** 6,
                           log_every=10 ** 6, loss_chunk=512,
                           ckpt_dir=os.path.join(tmp, name), seed=args.seed,
                           opt=AdamWConfig(**TRAIN_OPT))
        return Trainer(model, data, tcfg, policy=policy, device=DEVICE)

    # the unsharded steps through the step function (no checkpoint)
    t0 = time.perf_counter()
    plain = trainer("plain")
    params, opt = plain._init_state()
    step = make_train_step(model, None, plain.tcfg.opt,
                           plain.tcfg.loss_chunk)
    losses = []
    for i in range(SHARD_TRAIN_STEPS):
        params, opt, m = step(params, opt, {
            k: torch.from_numpy(v).to(DEVICE)
            for k, v in data.batch(i).items()})
        losses.append(float(m["loss"]))
    want = dict(params=params, opt=opt, losses=losses)
    plain_s = time.perf_counter() - t0
    policy = make_policy(mesh, cfg, "train", param_specs=model.param_specs)
    t0 = time.perf_counter()
    got = trainer("sharded", policy).run(resume=False)
    sharded_s = time.perf_counter() - t0
    a = dict(flatten_with_paths(train_loop.state_tree(want["params"],
                                                      want["opt"])))
    b = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
         for k, v in flatten_with_paths(train_loop.state_tree(
             got["params"], got["opt"]))}
    worst = max(rel_norm(b[k], a[k]) for k in a)
    check(worst <= SHARD_TOL, f"sharded train state off: {worst}")
    # the sharded trainer wrote its last step; an unsharded one reads it
    params, opt = trainer("sharded")._init_state()
    params, opt, _ = train_loop.restore_train_checkpoint(
        os.path.join(tmp, "sharded"), SHARD_TRAIN_STEPS, params, opt)
    back = dict(flatten_with_paths(train_loop.state_tree(params, opt)))
    check(back.keys() == b.keys() and all(torch.equal(back[k], b[k])
                                          for k in b),
          "the sharded checkpoint did not restore bit-equal")
    out = dict(arch=SHARD_ARCH, steps=SHARD_TRAIN_STEPS, batch=batch,
               seq=seq, max_rel_leaf=worst, leaves=len(a),
               losses=got["losses"], plain_losses=want["losses"],
               plain_s=plain_s, sharded_s=sharded_s, restored_bit_equal=True)
    del want, got, params, opt, a, b, back
    torch.cuda.empty_cache()
    return out


def sharded_moe(args, mesh) -> dict:
    """(c) llama4_scout_17b_a16e at published widths, 4 of 48 layers, f32:
    one 4 x 64 prefill through ``moe_impl="gspmd"``, each MoE block's
    input tapped and run again through ``moe_apply_shardmap`` on the
    mesh: rows whose pairs all survived equal, the dropped rows those the
    reference's capacities drop (recounted by the port's plain CPU
    routing of the same block); then the whole prefill with
    ``moe_impl="shardmap"`` on the mesh."""
    from repro_torch.core.dispatch import dispatch_to_trees
    from repro_torch.sharding.policy import (distribute_cache, make_policy,
                                             place_params)
    full = configs.get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=4 * MOE_REPEATS,
                              groups=((full.groups[0][0], MOE_REPEATS),),
                              dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(
        args.seed), torch.float32, device=DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (SHARD_MOE_BATCH, SHARD_MOE_LEN),
                         generator=torch.Generator(device=DEVICE).manual_seed(
                             args.seed + 7), device=DEVICE,
                         dtype=torch.int32)
    taps = []
    with torch.no_grad(), tapped(moe_mod, "moe_apply",
                                 lambda p, c, x, *rest: taps.append((p, x))):
        model.forward(params, {"tokens": toks})
    scfg = dataclasses.replace(cfg, moe_impl="shardmap")
    policy = make_policy(mesh, scfg, "serve", param_specs=model.param_specs)
    blocks = []
    for p, x in taps:
        with torch.no_grad():
            want = moe_mod.moe_apply(p, cfg, x)
            xd = policy.distribute(x, policy.batch_spec())
            pd = {k: policy.distribute(v, (None,) * v.ndim)
                  for k, v in p.items()}
            with policy.context():
                got, info = moe_mod.moe_apply_shardmap(
                    pd, scfg, xd, policy.constrain, return_drops=True)
            got, drop = got.full_tensor(), info["dropped"]
            keep = ~drop
            err = rel_norm(got[keep], want[keep])
            # the plain CPU routing of the same block: S = 1, so a pair
            # drops where its rank in its expert reaches cap2
            n = x.shape[0] * x.shape[1]
            r = moe_mod.routing({"router": p["router"].cpu()}, cfg,
                                x.cpu())
            cap2 = max(8, int(round(n * cfg.top_k / cfg.n_experts * 2.0)))
            _, over = dispatch_to_trees(r["expert"], cfg.n_experts, cap2)
            cpu_drop = torch.zeros(n, dtype=torch.int64).index_add(
                0, r["token"], over.to(torch.int64)) > 0
        check(err <= SHARD_TOL, f"shard_map MoE off on kept rows: {err}")
        check(torch.equal(drop.cpu().reshape(-1), cpu_drop),
              "shard_map MoE dropped other rows than the reference's "
              "capacities do")
        blocks.append(dict(kept_max_rel=err, dropped_rows=int(drop.sum()),
                           cap2=cap2))
    del taps
    smodel = build_model(scfg)
    with torch.no_grad():
        logits, _, _ = engine_mod.make_prefill_step(smodel, policy)(
            place_params(policy, model.param_specs, params),
            {"tokens": policy.distribute(toks, policy.batch_spec())},
            distribute_cache(policy, scfg, smodel.init_cache(
                SHARD_MOE_BATCH, SHARD_MOE_LEN, device=DEVICE)))
    check(bool(torch.isfinite(logits.full_tensor()).all()),
          "the shard_map prefill's logits are not finite")
    del params, model, smodel, logits
    torch.cuda.empty_cache()
    return dict(arch=MOE_ARCH, layers=cfg.layer_count(), batch=SHARD_MOE_BATCH,
                tokens=SHARD_MOE_LEN, dtype="float32", blocks=blocks,
                dropped_rows=sum(b["dropped_rows"] for b in blocks))


def phase_sharded(args, card: str, rows: list) -> None:
    """The LM stack's sharding on a one-rank NCCL DeviceMesh (the same
    code as a larger mesh: every rule resolves to a replicated placement
    there): (a) serving, (b) training and its checkpoint, (c) MoE's
    all_to_all dispatch; (d) one dry-run cell at full width on the fake
    16 x 16 world, in a subprocess on the host's CPU beside them.  The
    sharded head's lsh_hash and gather_rank launches join the kernel
    rows (``launches_by_path["sharded"]``)."""
    t_phase = time.perf_counter()
    arch, shape = SHARD_DRYRUN
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            torch.distributed.init_process_group(
                "nccl", store=torch.distributed.FileStore(f"{tmp}/pg", 1),
                rank=0, world_size=1)
            try:
                mesh = one_rank_mesh()
                t0 = time.perf_counter()
                out["serve"], launches = sharded_serving(args, mesh)
                out["serve"]["s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                out["train"] = sharded_training(args, mesh, tmp)
                out["train"]["s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                out["moe"] = sharded_moe(args, mesh)
                out["moe"]["s"] = time.perf_counter() - t0
            finally:
                torch.distributed.destroy_process_group()
        stdout, stderr = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    recs = [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith("{")]
    check(dry.returncode == 0 and recs and recs[0]["ok"],
          f"the dry-run cell failed: {stdout[-1000:]} {stderr[-2000:]}")
    for row in rows[:2]:
        row.setdefault("launches_by_path", {})["sharded"] = \
            launches[row["name"]]
    emit(phase="sharded", card=card, **out, dryrun=recs[0],
         s=time.perf_counter() - t_phase)


# ----------------------------------------------------------------------
# phase 5: the four example programs, run as a user runs them (beside 2-4)
# ----------------------------------------------------------------------
ROOT = Path(__file__).resolve().parent
EXAMPLES_CKPT = "build/examples_ckpt"   # the train example's, removed after
EXAMPLE_TRAIN_STEPS = (60, 70)   # the second run resumes from step 60
EXAMPLE_TIMEOUT = 600            # seconds one example may take
EXAMPLE_RECALL_TOL = 0.02        # card vs CPU recall@10 of an epoch
EXAMPLE_LOSS_BAND = 0.25         # published width: |loss - ln V| at most
EXAMPLE_SMOKE_FALL = 0.2         # --smoke: the loss falls at least this


def example_module(name: str):
    """``examples/<name>_torch.py`` imported (for its config and sizes;
    nothing runs at import)."""
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# Runs an example as ``__main__`` (``sys.argv`` as the user gives it) and,
# however it ends, writes the kernel launches it made (the process counts
# from 0) and the inputs of its heaviest call of each tapped kernel.
EXAMPLE_RUNNER = """
import json, runpy, sys, torch
from repro_torch.kernels import _build, ops
script, launch_file, inputs_file, *argv = sys.argv[1:]
WORK = {"lsh_hash": lambda x, *r: x.shape[0],
        "gather_rank": lambda q, s, slots, valid, *r: int(valid.sum()),
        "pair_dist_sq": lambda q, x: q.shape[0] * x.shape[0]}
kept = {}

def tap(name, real):
    def wrapper(*args, **kw):
        if args[0].is_cuda:
            work = WORK[name](*args)
            if name not in kept or work > kept[name][0]:
                kept[name] = (work, [a.cpu() if torch.is_tensor(a) else a
                                     for a in args])
        return real(*args, **kw)
    return wrapper

for name in WORK:
    setattr(ops, name, tap(name, getattr(ops, name)))
sys.argv = [script, *argv]
try:
    runpy.run_path(script, run_name="__main__")
finally:
    with open(launch_file, "w") as f:
        json.dump(_build.LAUNCHES, f)
    torch.save({k: v[1] for k, v in kept.items()}, inputs_file)
"""


def run_example(name: str, *argv, env: dict | None = None) -> dict:
    """``examples/<name>_torch.py ARGV`` run as ``__main__`` in a child
    ``python3`` from the checkout's root with ``PYTHONPATH=src``, as its
    docstring says a user runs it (through ``EXAMPLE_RUNNER``, which
    only counts and records the kernels' calls); its wall seconds,
    output, the kernel launches it made and the inputs (on the CPU) of
    its heaviest call of ``lsh_hash``, ``gather_rank`` and
    ``pair_dist_sq`` on the card.  A nonzero exit fails the run."""
    with tempfile.TemporaryDirectory() as tmp:
        log, inputs = (os.path.join(tmp, f) for f in ("launches.json",
                                                      "inputs.pt"))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(env or {}))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXAMPLE_RUNNER,
             f"examples/{name}_torch.py", log, inputs, *argv], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT)
        s = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"examples/{name}_torch.py {' '.join(argv)} exited "
              f"{proc.returncode}: {proc.stdout[-2000:]} "
              f"{proc.stderr[-3000:]}")
        launches = json.loads(Path(log).read_text())
        seen = torch.load(inputs)
    return dict(s=s, out=proc.stdout, launches=launches, inputs=seen)


def parse_lines(pattern: str, out: str) -> list:
    return [m.groups() for m in re.finditer(pattern, out, re.M)]


def examples_quickstart(run: dict) -> dict:
    ids = [json.loads(g[1]) for g in
           parse_lines(r"^q(\d+): ids=(\[[^\]]*\]) d0=", run["out"])]
    lines = run["out"].splitlines()
    check(len(ids) == 5 and all(r[0] == i for i, r in enumerate(ids))
          and "deleted ids 1,2 -> no longer returned." in lines
          and lines[-1] == "done.",
          f"quickstart: its asserts or lines: {run['out'][-2000:]}")
    upd = parse_lines(r"^after update, query\(-v0\): (\[[^\]]*\])",
                      run["out"])
    return dict(s=run["s"], ids=ids, after_update=json.loads(upd[0][0]),
                launches=run["launches"])


def examples_epochs(out: str) -> list:
    return [dict(epoch=int(e), store=int(n), req_s=float(r),
                 recall=float(c), rounds=int(k), seals=int(z))
            for e, n, r, c, k, z in parse_lines(
                r"^epoch (\d+): store=\s*(\d+)\s+(\d+) req/s "
                r"recall@10=([\d.]+) rounds=(\d+) syncs=\d+ seals=(\d+)",
                out)]


def examples_streaming(card_run: dict, cpu_run: dict, epochs: int) -> dict:
    """The stream's recall@10 on the card, epoch by epoch, against the
    same program on the CPU (the same projections: a CPU generator
    seeded 0); they may part only where a hash or a near-tie distance
    moves a query's answer."""
    card, cpu = examples_epochs(card_run["out"]), \
        examples_epochs(cpu_run["out"])
    check(len(card) == epochs and len(cpu) == epochs,
          f"streaming_recsys: {len(card)} / {len(cpu)} epochs printed")
    gaps = [abs(a["recall"] - b["recall"]) for a, b in zip(card, cpu)]
    check(max(gaps) <= EXAMPLE_RECALL_TOL and
          all(e["recall"] > 0 for e in card),
          f"streaming_recsys: recall@10 card {[e['recall'] for e in card]}"
          f" vs CPU {[e['recall'] for e in cpu]}")
    return dict(s=card_run["s"], epochs=card, cpu_recall=[
        e["recall"] for e in cpu], cpu_req_s=[e["req_s"] for e in cpu],
        cpu_s=cpu_run["s"], max_recall_gap=max(gaps),
        launches=card_run["launches"])


def examples_knnlm(run: dict, rounds: int, requests: int) -> dict:
    got = [(int(r), json.loads(t), int(n)) for r, t, n in parse_lines(
        r"^round (\d+): tokens\[0\]=(\[[^\]]*\]) datastore=(\d+)",
        run["out"])]
    sizes = [n for _, _, n in got]
    check(sizes == [requests * (r + 1) for r in range(rounds)],
          f"knnlm_serving: the datastore grew {sizes}, not by {requests} "
          "a round")
    return dict(s=run["s"], tokens0=[t for _, t, _ in got],
                datastore=sizes, launches=run["launches"])


def examples_train_run(run: dict) -> dict:
    """One run of the train example: its closing line and logged steps."""
    ends = parse_lines(r"^loss: ([\d.]+) -> ([\d.]+) over (\d+) steps",
                       run["out"])
    steps = parse_lines(r"^step\s+(\d+) loss ([\d.]+) gnorm (\S+) "
                        r"\((\d+) ms\)", run["out"])
    check(len(ends) == 1 and steps,
          f"train_smollm: its lines: {run['out'][-2000:]}")
    return dict(s=run["s"], first_loss=float(ends[0][0]),
                last_loss=float(ends[0][1]), steps=int(ends[0][2]),
                first_step=int(steps[0][0]),
                logged=[(int(a), float(b)) for a, b, _, _ in steps],
                gnorms=[float(g) for _, _, g, _ in steps],
                logged_ms=[int(c) for *_, c in steps],
                launches=run["launches"])


def params_moved(ckpt_dir: str, a: int, b: int) -> dict:
    """Whether each small parameter leaf (the norms' weights: at most
    2^16 entries) differs between the checkpoints of steps ``a`` and
    ``b`` (a train checkpoint's leaf ``0/...`` is a parameter)."""
    (da, la), (db, lb) = ((_step_dir(ckpt_dir, s), {
        e["path"]: e for e in read_manifest(ckpt_dir, s)["leaves"]})
        for s in (a, b))
    return {p: not np.array_equal(_read_leaf(da, e), _read_leaf(db, lb[p]))
            for p, e in la.items()
            if p.startswith("0/") and np.prod(e["shape"]) <= 1 << 16}


def examples_train(first: dict, second: dict, smoke: dict,
                   vocab: int) -> dict:
    """The train example: at published width, 60 steps from 0 with
    checkpoints at 50 and 60, then a run to 70 that resumes at 60, every
    gradient norm finite and positive, every small parameter leaf moved
    from step 50 to 60, every
    loss finite and within EXAMPLE_LOSS_BAND of ln(vocab) (a uniform
    guess: 30,720 tokens cannot teach the stream's bigram map over
    49,152 ids, so the loss holds there); the loss falls over the
    reduced config's 300 steps (``--smoke``) of the same program."""
    a, b = EXAMPLE_TRAIN_STEPS
    runs = [examples_train_run(r) for r in (first, second)]
    check(runs[0]["steps"] == a and runs[0]["first_step"] == 0,
          f"train_smollm: the first run did not train steps 0-{a - 1}")
    check(runs[1]["first_step"] == a and runs[1]["steps"] == b - a,
          f"train_smollm: the second run did not resume at step {a}")
    losses = [x for r in runs for x in (r["first_loss"], r["last_loss"])] \
        + [x for r in runs for _, x in r["logged"]]
    uniform = float(np.log(vocab))
    check(all(np.isfinite(losses)) and
          max(abs(x - uniform) for x in losses) <= EXAMPLE_LOSS_BAND,
          f"train_smollm: a loss left ln(V) = {uniform} +- "
          f"{EXAMPLE_LOSS_BAND}: {losses}")
    gnorms = [g for r in runs for g in r["gnorms"]]
    check(all(np.isfinite(gnorms)) and min(gnorms) > 0,
          f"train_smollm: a gradient norm not finite or 0: {gnorms}")
    full = ROOT / EXAMPLES_CKPT / "full"
    ckpts = sorted(os.listdir(full))
    check(ckpts == [f"step_{s:08d}" for s in (50, a, b)],
          f"train_smollm: checkpoints {ckpts}")
    moved = params_moved(str(full), 50, a)
    check(moved and all(moved.values()),
          f"train_smollm: parameters unchanged from step 50 to {a}: {moved}")
    small = examples_train_run(smoke)
    check(small["first_step"] == 0 and small["last_loss"] < small[
        "first_loss"] - EXAMPLE_SMOKE_FALL,
          f"train_smollm --smoke: the loss did not fall: {small['logged']}")
    return dict(runs=runs, ln_vocab=uniform, checkpoints=ckpts,
                small_params_moved=moved,
                checkpoint_bytes=dir_bytes(str(full / ckpts[-1])),
                smoke=small)


def examples_kernels(runs: dict) -> dict:
    """Each example's kernels on the card at the inputs of its own
    heaviest call of each (``run_example``'s taps: the most rows hashed,
    the most valid candidates ranked, the largest oracle), held against
    their plain versions and timed; ``{kernel: {example: entry}}``."""
    out = {}
    for ex, run in runs.items():
        seen = {k: [a.to(DEVICE).contiguous() if torch.is_tensor(a) else a
                    for a in v] for k, v in run["inputs"].items()}
        if "lsh_hash" in seen:
            x, a = (t.float() for t in seen["lsh_hash"][:2])
            out.setdefault("lsh_hash", {})[ex] = lsh_hash_at(x, a)
        if "gather_rank" in seen:
            q, store, slots, valid, metric = seen["gather_rank"][:5]
            out.setdefault("gather_rank", {})[ex] = gather_rank_at(
                q.float(), store.float(), slots, valid.bool(), metric)
        if "pair_dist_sq" in seen:
            out.setdefault("pair_dist", {})[ex] = pair_dist_at(
                tuple(t.float() for t in seen["pair_dist_sq"]))
    return out


def start_examples(pool: ThreadPoolExecutor) -> dict:
    """Start the four example programs as a user starts them, each a
    subprocess ``python3 examples/<name>_torch.py`` on the card with the
    kernels built, in three lanes side by side on ``pool``: (1) the
    quickstart, the stream and kNN-LM serving (3 rounds) at their
    defaults, then training of the reduced config (``--smoke``, 300
    steps); (2) training at published width for 60 steps into
    ``build/``, then to 70, resuming from step 60; (3) the stream
    once more with ``--device cpu``, which holds the card's recall.
    They run beside the CPU-vs-card traces (phases 2-4, which time
    nothing) on the host's idle cores; :func:`phase_examples` waits for
    them before any measured leg.  Returns the lanes' futures."""
    a, b = EXAMPLE_TRAIN_STEPS
    ckpt, smoke = (ROOT / EXAMPLES_CKPT / n for n in ("full", "smoke"))
    shutil.rmtree(ROOT / EXAMPLES_CKPT, ignore_errors=True)
    lanes = {
        "card": [("quickstart",), ("streaming_recsys",), ("knnlm_serving",),
                 ("train_smollm", "--smoke", "--ckpt", str(smoke))],
        "train": [("train_smollm", "--steps", str(a), "--ckpt", str(ckpt)),
                  ("train_smollm", "--steps", str(b), "--ckpt", str(ckpt))],
        # the CPU run keeps to two threads, off the card lanes' host cores
        "cpu": [("streaming_recsys", "--device", "cpu")],
    }
    cpu_env = {"OMP_NUM_THREADS": "2"}

    def lane(name):
        t0 = time.perf_counter()
        runs = [run_example(*c, env=cpu_env if name == "cpu" else None)
                for c in lanes[name]]
        return runs, time.perf_counter() - t0
    return {k: pool.submit(lane, k) for k in lanes}


def phase_examples(card: str, lanes: dict) -> dict:
    """Wait for the example programs (:func:`start_examples`) and check
    what they printed; the card runs of the three that launch kernels
    (their launches, counted in each child from 0, and their kernels'
    inputs) are returned for the kernel rows (:func:`examples_rows`)."""
    t_phase = time.perf_counter()
    sr, kn = (example_module(n) for n in ("streaming_recsys",
                                          "knnlm_serving"))
    done = {k: f.result() for k, f in lanes.items()}
    runs = {k: v[0] for k, v in done.items()}
    out = dict(
        quickstart=examples_quickstart(runs["card"][0]),
        streaming_recsys=examples_streaming(runs["card"][1],
                                            runs["cpu"][0], sr.EPOCHS),
        knnlm_serving=examples_knnlm(runs["card"][2], kn.ROUNDS,
                                     kn.REQUESTS),
        train_smollm=examples_train(
            *runs["train"], runs["card"][3],
            configs.get_config("smollm_135m").vocab_size))
    total = {n: sum(r["launches"].get(n, 0) for r in runs["card"] +
                    runs["train"]) for n in _build.LAUNCHES}
    for name in ("lsh_hash", "gather_rank"):
        for ex in ("quickstart", "streaming_recsys", "knnlm_serving"):
            check(out[ex]["launches"].get(name, 0) > 0,
                  f"{ex} launched no {name}")
    check(out["streaming_recsys"]["launches"].get("pair_dist", 0)
          == sr.EPOCHS, "streaming_recsys: an oracle ran without pair_dist")
    trained = runs["train"] + runs["card"][3:]
    check(not any(sum(r["launches"].values()) for r in trained),
          "train_smollm launched an index kernel")
    emit(phase="examples", card=card, **out, launches=total,
         lanes_s={k: v[1] for k, v in done.items()},
         wait_s=time.perf_counter() - t_phase)
    return {ex: dict(launches=r["launches"], inputs=r["inputs"])
            for ex, r in zip(("quickstart", "streaming_recsys",
                              "knnlm_serving"), runs["card"])}


def examples_rows(rows: list, runs: dict) -> dict:
    """The examples' launches into the kernel rows (``examples``: the
    sum, and each example's launches with its kernel held and timed on
    its own inputs, :func:`examples_kernels`); returns pair_dist's."""
    kernels = examples_kernels(runs)
    for row in rows[:2]:
        name = row["name"]
        row.setdefault("launches_by_path", {})["examples"] = sum(
            r["launches"][name] for r in runs.values())
        row["examples"] = {ex: dict(at, launches=runs[ex]["launches"][name])
                           for ex, at in kernels[name].items()}
    return {ex: dict(at, launches=runs[ex]["launches"]["pair_dist"])
            for ex, at in kernels["pair_dist"].items()}


# ----------------------------------------------------------------------
# phase 14: the paper's comparators on the hot path's items and queries
# ----------------------------------------------------------------------
def run_comparator(index, ids, vecs, q, batch: int):
    """Insert (ids, vecs) in batches and answer q once, with the launch
    counts set to 0 just before and read just after.  Returns the answer,
    insert and query seconds, the launches, each query's candidate count
    (the valid entries ``pairwise_rank`` got) and the inputs of the first
    ``rank_dots`` the query ran."""
    ranks, dots = [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for s in range(0, ids.shape[0], batch):
        index.insert(ids[s:s + batch], vecs[s:s + batch])
    torch.cuda.synchronize()
    t_ins = time.perf_counter() - t0
    with tapped(ops, "pairwise_rank",
                lambda qq, cand, valid, metric: ranks.append(valid.sum(1))), \
            tapped(ops, "rank_dots", lambda qq, xx: dots.append(
                None if dots else (qq, xx))):
        t0 = time.perf_counter()
        got = index.query(q, 10)
        t_q = time.perf_counter() - t0
    return got, t_ins, t_q, dict(ops.LAUNCHES), torch.cat(ranks), dots[0]


def phase_serialized(cfg, proj, seed: int):
    """Fig. 7 at the hot config's widths: SerializedPFO (one global order)
    against a dispatched PFOIndex on the same FIG7_ITEMS clustered
    vectors (those that hash alike on the CPU and the card), and the
    serialized forest on the card after the first FIG7_CHECK vectors
    against the same apply on the CPU (the serial apply is the same
    whether it runs in one call or two)."""
    x = clustered(4 * FIG7_ITEMS, cfg.dim, seed + 3, "cpu").numpy()
    vecs = x[safe_rows(x, proj, cfg)][:FIG7_ITEMS]
    check(len(vecs) == FIG7_ITEMS, "too few vectors hash alike")
    ids = np.arange(FIG7_ITEMS, dtype=np.int32)
    head = slice(0, FIG7_CHECK)
    host = SerializedPFO(cfg, device="cpu", proj=proj)
    t0 = time.perf_counter()
    host.insert(ids[head], vecs[head])
    secs_cpu = time.perf_counter() - t0
    ser = SerializedPFO(cfg, device=DEVICE, proj=proj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ser.insert(ids[head], vecs[head])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name, a in host.forest._asdict().items():
        check(torch.equal(a, getattr(ser.forest, name).cpu()),
              f"SerializedPFO: {name} differs between the CPU and the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ser.insert(ids[FIG7_CHECK:], vecs[FIG7_CHECK:])
    torch.cuda.synchronize()
    secs += time.perf_counter() - t0
    # the dispatched apply of the same requests (one warm-up index first)
    PFOIndex(cfg, device=DEVICE, proj=proj).insert(ids, vecs)
    idx = PFOIndex(cfg, device=DEVICE, proj=proj)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rounds = idx.insert(ids, vecs)
    torch.cuda.synchronize()
    t_disp = time.perf_counter() - t0
    # work (requests) against critical-path depth (the longest mailbox)
    xv = torch.from_numpy(vecs).to(DEVICE)
    h = ops.lsh_hash(xv, proj["table_proj"].to(DEVICE), cfg.M)
    trees = (region_ids(h, proj["part_proj"].to(DEVICE), cfg)
             + torch.arange(cfg.L, device=DEVICE)[None] * cfg.n_trees)
    counts = torch.bincount(trees.reshape(-1), minlength=cfg.L * cfg.n_trees)
    work, depth = int(counts.sum()), int(counts.max())
    landed = int(ser.forest.n_items.sum())
    check(landed + int(ser.forest.overflow.sum()) == work,
          f"SerializedPFO: {landed} records landed of {work} requests")
    per_op = secs / work
    return dict(items=FIG7_ITEMS, requests=work, critical_path_depth=depth,
                ideal_speedup=work / depth,
                serialized_insert_s=secs,
                checked_items=FIG7_CHECK,
                serialized_check_s_cpu=secs_cpu,
                dispatched_insert_s=t_disp, dispatched_rounds=rounds,
                serialized_over_dispatched=secs / t_disp,
                parallel_time_est_s=depth * per_op,
                forest_equal_cpu_card=True,
                forest_leaves=landed)


def phase_baselines(args, hot):
    """ZOrderIndex and MultiProbeFlat (the reference's defaults, L = 10)
    on the hot path's items and queries, beside PFO's own answer, scored
    against the hot path's BruteForce oracle; then Fig. 7.  Returns the
    inputs of the kernel rows it feeds: rank_dots' (each comparator's
    first launch: ZOrderIndex's one block and MultiProbeFlat's first of
    its query steps), hamming's (MultiProbeFlat's keys) and each
    comparator's rank_dots launches."""
    cfg = main_config()
    dev = torch.device(DEVICE)
    ids, vecs, q = hot["ids"], hot["vecs"], hot["q"]
    n, nq = ids.shape[0], q.shape[0]
    proj = {k: v.detach() for k, v in hot["proj"].items()}
    truth, truth_d = hot["truth"][:, :10], hot["truth_d"][:, :10]

    def scores(got_ids, got_d):
        rec = recall_at(got_ids, truth)
        return dict(recall_at_10=float(rec.mean()),
                    recall_at_10_fresh=float(rec[nq // 2:].mean()),
                    error_ratio=error_ratio(got_d, truth_d, 10),
                    error_ratio_fresh=error_ratio(got_d[nq // 2:],
                                                  truth_d[nq // 2:], 10))

    out = dict(pfo=dict(inserts_per_s=hot["inserts_per_s"],
                        queries_per_s=hot["queries_per_s"],
                        candidates_per_query=hot["candidates_per_query"],
                        **scores(hot["got_ids"], hot["got_d"])))
    feeds = {}
    for name, cls in (("zorder", ZOrderIndex), ("multiprobe", MultiProbeFlat)):
        index = cls(cfg, device=dev, proj=proj)
        (got_ids, got_d), t_ins, t_q, launches, n_cand, dots = run_comparator(
            index, ids, vecs, q, 4096)
        check(launches["rank_dots"] >= 1, f"{name} ran no rank_dots: "
              f"{launches}")
        check(got_ids.shape == (nq, 10) and np.array_equal(
            got_ids >= 0, np.isfinite(got_d)), f"{name}: answer shape")
        out[name] = dict(inserts_per_s=n / t_ins, insert_s=t_ins,
                         queries_per_s=nq / t_q, query_s=t_q,
                         candidates_per_query=float(n_cand.float().mean()),
                         candidates_max=int(n_cand.max()),
                         launches=launches, **scores(got_ids, got_d))
        feeds[name] = launches["rank_dots"]
        feeds[name + "_dots_in"] = dots
        if name == "multiprobe":
            # the stored items' keys, topped up to HAMMING_KEYS with
            # fresh vectors of the same distribution
            more = max(0, HAMMING_KEYS - n)
            keyed = torch.cat([vecs[:HAMMING_KEYS], clustered(
                more, cfg.dim, args.seed + 7, dev)]) if more else \
                vecs[:HAMMING_KEYS]
            feeds["keys"] = (index._buckets(q)[1], index._buckets(keyed)[1])
            out[name]["bucket_fill_max"] = int(index.bucket_fill.max())
        del index
    out["bruteforce"] = dict(queries_per_s=hot["oracle_queries_per_s"],
                             candidates_per_query=n,
                             pair_dist_launches=hot["oracle_launches"])
    out["serialized"] = phase_serialized(cfg, {k: v.cpu() for k, v in
                                               proj.items()}, args.seed)
    emit(phase="baselines", items=n, queries=nq, dim=cfg.dim, L=cfg.L,
         **out)
    return feeds


# ----------------------------------------------------------------------
# phase 15: the cold path at glove-100 width
# ----------------------------------------------------------------------
COLD_TOMBSTONES = 1 << 17
COLD_BUDGET = 256


def cold_config() -> PFOConfig:
    """main_config()'s widths (d 100, L 10, C 4, m 4, l 128, 512 ranked
    candidates) with the package's default arenas: LSH segments of
    256 x 1024 and MainTable segments of 64 x 4096 entries, 262,144 each.
    The store holds 2^18 vectors and spills below 2^16 free; the cold
    tier keeps 6 segments a tier and caches L x 6 of them, since at this
    segment size every Bloom filter matches every query (all 4096
    12-bit prefixes are occupied)."""
    return PFOConfig(dim=100, max_snapshots=3, store_capacity=1 << 18,
                     store_low_watermark=1 << 16,
                     max_tombstones=COLD_TOMBSTONES, cold_segments=6,
                     cold_cache_slots=60, cold_fetch_rounds=8,
                     snap_budget_per_probe=COLD_BUDGET)


def state_bytes(x) -> int:
    """Device bytes held by an index state (NamedTuples, dicts, tensors)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(map(state_bytes, x.values()))
    if hasattr(x, "_fields"):
        return sum(map(state_bytes, x))
    return 0


def phase_cold_main(args):
    cfg = cold_config()
    dev = torch.device(DEVICE)
    n, wave, nq = COLD_ITEMS, COLD_WAVE, QUERIES
    data = clustered(n + nq, cfg.dim, args.seed + 7, dev)
    vecs, fresh = data[:n], data[n:]
    g = torch.Generator(device=dev).manual_seed(args.seed + 8)
    ids = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    alive = torch.ones(n, dtype=torch.bool, device=dev)       # by row
    tmp = tempfile.TemporaryDirectory()      # file-backed segments (flash)
    idx = PFOIndex(cfg, seed=args.seed, device=dev, cold_dir=tmp.name)
    n_waves = (n + wave - 1) // wave
    torch.cuda.synchronize()
    ops.reset_launches()                      # counts start here ...
    t_ins = t_del = 0.0
    for w in range(n_waves):
        rows = slice(w * wave, (w + 1) * wave)
        t0 = time.perf_counter()
        if w == n_waves - 1:   # the last insert, traced (its wall time only)
            profile = device_profile(lambda: idx.insert(ids[rows],
                                                        vecs[rows]))
            t_ins += profile["wall_ms"] / 1e3
        else:
            idx.insert(ids[rows], vecs[rows])
            t_ins += time.perf_counter() - t0
        if w >= 2:                 # churn: a third of the wave two back
            gone = slice((w - 2) * wave, (w - 2) * wave + wave // 3)
            t0 = time.perf_counter()
            idx.delete(ids[gone])
            t_del += time.perf_counter() - t0
            alive[gone] = False
        if w % 32 == 31:
            log = idx.maintenance_log
            emit(phase="cold_insert_progress", items=(w + 1) * wave,
                 insert_s=t_ins, churn_delete_s=t_del,
                 **{m: log.count(m) for m in ("seal", "spill", "merge",
                                              "cold_compact")},
                 compactions=idx.cold.counters["compactions"],
                 cold_segments=idx.cold.n_cold)
    torch.cuda.synchronize()
    live_rows = alive.nonzero().squeeze(1)
    n_live = int(live_rows.numel())

    # self-queries of items that live only in cold segments: live, and
    # found neither in the hot forest nor in the device ring
    early = live_rows[live_rows < n // 4]
    early = early[torch.randperm(early.numel(), generator=g,
                                 device=dev)[:8 * (nq + DELETES)]]
    _, hot_or_ring = index_mod._main_lookup(idx.state, ids[early], cfg)
    cold_rows = early[~hot_or_ring]
    check(cold_rows.numel() >= nq // 2 + DELETES,
          f"only {cold_rows.numel()} cold-only items found")
    self_rows = cold_rows[: nq // 2]
    del_rows = cold_rows[nq // 2: nq // 2 + DELETES]
    q = torch.cat([vecs[self_rows], fresh[: nq - nq // 2]])
    torch.cuda.synchronize()
    (got_ids, got_d), t_q, ranked = tap_ranking(lambda: idx.query(q, 10))
    q_stats = idx.stats()["cold"]
    alive_id = torch.zeros(n, dtype=torch.bool, device=dev)
    alive_id[ids[alive].long()] = True         # live at query time, by id
    alive_id = alive_id.cpu().numpy()

    t0 = time.perf_counter()
    del_rounds = idx.delete(ids[del_rows])
    torch.cuda.synchronize()
    t_cold_del = time.perf_counter() - t0
    alive[del_rows] = False
    after_ids, _ = idx.query(vecs[del_rows[:nq]], 10)
    launches = dict(ops.LAUNCHES)              # ... and stop here
    stats = idx.stats()

    # checks of what came out
    check(got_ids.shape == (nq, 10) and np.isfinite(got_d[got_ids >= 0]).all()
          and np.array_equal(got_ids >= 0, np.isfinite(got_d)),
          "query output shape or finiteness")
    check((np.diff(np.where(np.isfinite(got_d), got_d, 9.0), axis=1)
           >= 0).all(), "distances not sorted")
    check(alive_id[got_ids[got_ids >= 0]].all(),
          "a query returned an id deleted by the churn")
    dead_np = ids[del_rows].cpu().numpy()
    check(not np.isin(after_ids, dead_np).any()
          and alive_id[after_ids[after_ids >= 0]].all(),
          "a deleted id came back")
    c = stats["cold"]
    check(n_live >= 2 * cfg.store_capacity,
          f"live items {n_live} < 2 x store_capacity")
    check(c["segments_spilled"] >= 2 and c["compactions"] >= 1
          and c["cold_merges"] >= 1,
          f"the cold path must spill twice, compact and merge: {c}")
    check(c["incomplete_query_rounds"] == 0,
          f"{c['incomplete_query_rounds']} incomplete query rounds")
    check(launches["gather_rank_staged"] > 0 and launches["lsh_hash"] > 0,
          f"a kernel of the cold path was never launched: {launches}")
    check(stats["overflow_events"] == 0, "arena overflow")

    # self-queries: rank 0, or cut by the ranking budget (the query's own
    # candidates)
    cids = ranked["cids"][: nq // 2].cpu().numpy()
    self_ids = ids[self_rows].cpu().numpy()
    bad = cut_criterion(self_ids, got_ids[: nq // 2], cids)
    rank0 = got_ids[: nq // 2, 0] == self_ids
    in_cand = (cids == self_ids[:, None]).any(1)

    # recall@10 against the exact oracle over the items live at query time
    (truth, _), oracle_launches, oracle_in, _ = exact_oracle(
        cfg, ids[live_rows], vecs[live_rows], q)
    recall = recall_at(got_ids, truth)
    staged = q_stats["staged_ranked"]
    emit(phase="cold_path", items=n, live_items=n_live, dim=cfg.dim,
         reduced=[f"items {GLOVE_ROWS} -> {n}: cut for time"],
         config={k: getattr(cfg, k) for k in (
             "L", "C", "m", "l", "max_candidates_total", "max_snapshots",
             "store_capacity", "store_low_watermark", "max_tombstones",
             "cold_segments", "cold_cache_slots", "cold_fetch_rounds",
             "snap_budget_per_probe", "snap_prefix_bits")},
         segment_caps=[index_mod._snap_cfg_lsh(cfg).snapshot_capacity,
                       index_mod._snap_cfg_main(cfg).snapshot_capacity],
         device_state_bytes=state_bytes(idx.state),
         device_cold_bytes=state_bytes(idx.state.cold),
         device_allocated_bytes=torch.cuda.memory_allocated(),
         insert_wave=wave, insert_s=t_ins, inserts_per_s=n / t_ins,
         churn_delete_s=t_del, insert_rounds=sum(idx.rounds_log),
         maintenance={m: idx.maintenance_log.count(m) for m in (
             "seal", "spill", "merge", "cold_compact")},
         queries=nq, query_s=t_q, queries_per_s=nq / t_q,
         recall_at_10=float(recall.mean()),
         recall_at_10_fresh=float(recall[nq // 2:].mean()),
         oracle="BruteForce (pair_dist)", oracle_launches=oracle_launches,
         self_rank0_rate=float(rank0.mean()),
         self_in_candidates_rate=float(in_cand.mean()),
         self_missed_not_cut=int(bad.sum()),
         read_amplification=(q_stats["vec_fetch_bytes"]
                             / (staged * cfg.dim * 4) if staged else None),
         fetches_per_query_round=q_stats["fetches_per_query_round"],
         staging_hit_rate=q_stats["vec_staging_hit_rate"],
         query_cold_stats=q_stats,
         cold_deletes=DELETES, cold_delete_rounds=del_rounds,
         cold_delete_s=t_cold_del, sync_count=idx.sync_count,
         launches=launches, stats=stats, last_insert_profile=profile)
    check(not bad.any(), f"{int(bad.sum())} self-queries missed rank 0 "
          "without their id being cut by the ranking budget")
    idx.cold._discard_worker()           # no fold may read the files now
    del idx
    tmp.cleanup()
    return ranked, launches, oracle_launches["pair_dist"], oracle_in


# ----------------------------------------------------------------------
# phase 16: each kernel against its plain version, timed, with its bound
# ----------------------------------------------------------------------
def hash_flips(x, a, rounding: bool = False) -> dict:
    """lsh_hash's bits on the card against its plain version and against
    the float64 projection's signs: ``far`` counts the bits that differ
    where the projection lies outside the near-zero band, ``near`` the
    bits that differ from the plain version inside it, out of ``in_band``
    non-zero projections there.

    The band is MARGIN, or with ``rounding`` FLIP_SIGMAS units of an
    fp32 dot product's typical rounding error, one unit being sqrt(d) *
    2^-24 * sqrt(sum_i (x_i a_i)^2), where that is wider: at d = 5,120
    over hidden states of norm ~70 any fp32 product is off by more than
    MARGIN.  A kernel that rounds its operands to bf16 (1xTF32) is off by
    ~2^-9 (2^-11) sqrt(sum_i (x_i a_i)^2), 20-50x (6-13x) the band at d =
    5,120 to 1,024, and flips bits far outside it.  ``plain_err`` is the plain
    version's largest error in units, which the band must clear."""
    n, words = x.shape[0], a.shape[1] // 32
    got = ops.lsh_hash(x, a)
    plain = ref.ref_lsh_hash(x, a)
    proj64 = x.double() @ a.double()
    band, plain_err = torch.full_like(proj64, MARGIN), None
    if rounding:
        unit = (x.double().square() @ a.double().square()).sqrt() * (
            x.shape[1] ** 0.5 * 2.0 ** -24)
        band = torch.clamp_min(FLIP_SIGMAS * unit, MARGIN)
        plain_err = float(((x.float() @ a.float()).double() - proj64).abs()
                          .div(unit.clamp_min(1e-300)).max())
    inside = proj64.abs() < band
    near = inside.reshape(n, words, 32)
    shifts = torch.arange(31, -1, -1, device=x.device)
    diff = (((got ^ plain)[..., None] >> shifts) & 1).bool()
    truth = ((((proj64 >= 0).reshape(n, words, 32).long()
               << shifts).sum(-1) ^ got)[..., None] >> shifts) & 1
    far = int((diff & ~near).sum()) + int((truth.bool() & ~near).sum())
    # a padded zero row projects to exactly 0 on every route: not counted
    return dict(far=far, near=int((diff & near).sum()),
                in_band=int((inside & (proj64 != 0)).sum()),
                plain_err=plain_err)


def lsh_hash_at(x, a, rounding: bool = False) -> dict:
    """lsh_hash on one batch of the path's vectors, through
    ``lsh_hash_cuda``: its bit flips against the plain version (near
    zero as ``hash_flips`` takes it), its times (in turns with
    ``torch.matmul``) and its bound."""
    flips = hash_flips(x, a, rounding)
    far, near = flips["far"], flips["near"]
    n = x.shape[0]
    check(far == 0, f"lsh_hash: {far} bit flips away from zero at {n} rows")
    if rounding:
        # an fp32-accurate kernel flips a band's bit only at its floor
        # (both it and the plain version err by ~1 unit of FLIP_SIGMAS);
        # operands rounded to bf16 flip about half of them
        check(flips["plain_err"] < FLIP_SIGMAS,
              f"lsh_hash: the plain version errs by {flips['plain_err']} "
              f"units, past the band's {FLIP_SIGMAS}")
        check(near <= flips["in_band"] // 4 + 1,
              f"lsh_hash: {near} flips of {flips['in_band']} in the band")
    d, p = a.shape
    b_ms, b_by = bound_ms(4 * d * p + 4 * n * d + 8 * n * (p // 32),
                          2 * n * d * p)
    plain = cuda_ms(lambda: ref.ref_lsh_hash(x, a))
    ms, lib_ms = paired_ms(lambda: lsh_hash_cuda(x, a),
                           lambda: torch.matmul(x, a))
    return dict(shape=[n, d, p], far_flips=far, near_zero_flips=near,
                in_band=flips["in_band"], plain_err_units=flips["plain_err"],
                band_units=FLIP_SIGMAS if rounding else None, ms=ms,
                kernel_ms=kernel_ms(lambda: lsh_hash_cuda(x, a)),
                plain_ms=plain, library_ms=lib_ms,
                library_kernel_ms=kernel_ms(lambda: torch.matmul(x, a)),
                bound_ms=b_ms, bound_by=b_by)


def gather_rank_at(q, store, slots, valid, metric: str) -> dict:
    """gather_rank on one query round's own ranking inputs, held against
    its plain version, with its times through ``gather_rank_cuda`` and
    its bound; the library call ranks the pre-gathered block."""
    slots = slots.to(torch.int32)
    got = ops.gather_rank(q, store, slots, valid, metric)
    plain = ref.ref_gather_rank(q, store, slots, valid, metric)
    check(torch.equal(torch.isinf(got), torch.isinf(plain)),
          "gather_rank: +inf pattern differs")
    fin = torch.isfinite(plain)
    err = float((got[fin] - plain[fin]).abs().max()) if fin.any() else 0.0
    torch.testing.assert_close(got, plain, rtol=RANK_TOL, atol=RANK_TOL)
    qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)
    nq, c = slots.shape
    d = store.shape[1]
    angular = metric == "angular"
    n_valid = int(valid.sum())
    n_rows = int(torch.unique(slots[valid]).numel())   # store rows needed
    b_ms, b_by = bound_ms(4 * (nq * d + n_rows * d + 2 * nq * c) + nq * c,
                          4 * n_valid * d)
    block = store[slots.long()]                       # (Q, C, d) gathered
    return dict(
        max_abs_err=err, shape=[nq, c, d], valid_candidates=n_valid,
        distinct_rows=n_rows,
        ms=cuda_ms(lambda: gather_rank_cuda(qn, store, slots, valid,
                                            angular)),
        kernel_ms=kernel_ms(lambda: gather_rank_cuda(qn, store, slots, valid,
                                                     angular)),
        plain_ms=cuda_ms(lambda: ref.ref_gather_rank(q, store, slots, valid,
                                                     metric)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.bmm(block, qn[:, :, None])))


def phase_kernels(idx, ranked, launches):
    cfg, st = idx.cfg, idx.state
    rows = []

    # lsh_hash at the insert batch's shape, (4096, d) x (d, L*32), and at
    # the query batch's, (1024, d) x (d, L*32), through lsh_hash_cuda
    a = st.proj["table_proj"].contiguous()
    insert, query = (lsh_hash_at(clustered(n, cfg.dim, seed,
                                           st.store.data.device), a)
                     for n, seed in ((4096, 12345), (1024, 12346)))
    rows.append(dict(
        name="lsh_hash", route="cuda", design="3xtf32-mma",
        source="src/repro_torch/kernels/csrc/lsh_hash.cu",
        replaces="src/repro/kernels/lsh_hash.py:64",
        launches=launches["lsh_hash"], max_abs_err=insert["far_flips"],
        near_zero_flips=insert["near_zero_flips"], shape=insert["shape"],
        ms=insert["ms"], kernel_ms=insert["kernel_ms"],
        timed="through lsh_hash_cuda, in turns with torch.matmul; "
              "kernel_ms: torch.profiler's kernel time",
        plain_ms=insert["plain_ms"], bound_ms=insert["bound_ms"],
        bound_by=insert["bound_by"], library_ms=insert["library_ms"],
        library_kernel_ms=insert["library_kernel_ms"],
        library_call="torch.matmul(x, a)", query_batch=query))

    # gather_rank on the hot query's own ranking inputs
    q, store, valid = ranked["qvecs"], ranked["store"], ranked["valid"]
    slots = ranked["slots"].to(torch.int32)
    row = gather_rank_at(q, store, slots, valid, cfg.metric)
    # a yardstick: the same reads folded into 20,000 rows (8 MB), so all
    # but the first touch of each hit the L2 and every read still crosses
    # from the L2 to the SMs
    qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)
    pool = slots.remainder(L2_POOL_ROWS)
    pool_ms = cuda_ms(lambda: gather_rank_cuda(qn, store, pool, valid, True))
    rows.append(dict(
        name="gather_rank", route="cuda", design=GATHER_DESIGN,
        source="src/repro_torch/kernels/csrc/gather_rank.cu",
        replaces="src/repro/kernels/gather_rank.py:112",
        launches=launches["gather_rank"], **row, l2_pool_ms=pool_ms,
        timed="through gather_rank_cuda; kernel_ms: torch.profiler's "
              "kernel time; l2_pool_ms: slots folded into "
              f"{L2_POOL_ROWS} rows"))
    return rows


def pair_dist_at(xin) -> dict:
    """pair_dist on one oracle's own (unit) inputs, held against its plain
    version, with its times and bound.  The kernel, its plain version and
    the library call are each timed from the vectors alone: the kernel
    through ``pair_dist_cuda``, the wrapper the path runs, whose one
    launch sums the norms too."""
    qn, xn = xin
    got = pair_dist_cuda(qn, xn)
    plain = ref.ref_pair_dist(qn, xn)
    err = float((got - plain).abs().max())
    torch.testing.assert_close(got, plain, rtol=PAIR_TOL, atol=PAIR_TOL)
    del got, plain
    nq, d = qn.shape
    n = xn.shape[0]
    b_ms, b_by = bound_ms(4 * (nq * d + n * d + nq * n),
                          2 * nq * n * d + 3 * nq * n + 2 * (nq + n) * d)
    return dict(
        max_abs_err=err, shape=[nq, n, d],
        ms=cuda_ms(lambda: pair_dist_cuda(qn, xn)),
        kernel_ms=kernel_ms(lambda: pair_dist_cuda(qn, xn), iters=5),
        plain_ms=cuda_ms(lambda: ref.ref_pair_dist(qn, xn), iters=5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.cdist(qn, xn).square(), iters=5))


def pair_dist_row(hot: dict, cold: dict, lm: dict, examples: dict,
                  launches: dict) -> dict:
    """pair_dist at its launches on the paths, from :func:`pair_dist_at`:
    the hot oracle's 1024 queries against ITEMS items (the row's own
    numbers, measured before the cold path runs), the cold oracle's
    against the cold path's live items, N % 4 != 0 (``cold_oracle``), the
    LM datastore's recall oracle at d = 576 (``lm_oracle``) and the
    streaming example's last oracle (``examples_oracle``).  ``launches``
    counts it by path."""
    return dict(
        name="pair_dist", route="cuda", design="3xtf32-mma",
        source="src/repro_torch/kernels/csrc/pair_dist.cu",
        replaces="src/repro/kernels/pair_dist.py:56",
        launches=sum(launches.values()), launches_by_path=launches,
        **hot,
        timed="through pair_dist_cuda, norms included; kernel_ms: "
              "torch.profiler's kernel time",
        library_call="torch.cdist(q, x).square()",
        cold_oracle=cold, lm_oracle=dict(lm, launches=launches["lm"]),
        examples_oracle=examples)


def rank_dots_at(xin) -> dict:
    """rank_dots on one comparator's own (unit) block, held against its
    plain version, with its times and bound.  The kernel is timed through
    ``rank_dots_cuda`` in turns with ``torch.bmm`` on the same block."""
    qn, x = xin
    got = rank_dots_cuda(qn, x)
    plain = ref.ref_rank_dots(qn, x)
    err = float((got - plain).abs().max())
    torch.testing.assert_close(got, plain, rtol=RANK_TOL, atol=RANK_TOL)
    del got, plain
    nq, c, d = x.shape
    ms, lib_ms = paired_ms(lambda: rank_dots_cuda(qn, x),
                           lambda: torch.bmm(x, qn[:, :, None]))
    b_ms, b_by = bound_ms(4 * (nq * d + nq * c * d + nq * c), 2 * nq * c * d)
    return dict(
        max_abs_err=err, shape=[nq, c, d], ms=ms,
        kernel_ms=kernel_ms(lambda: rank_dots_cuda(qn, x)),
        plain_ms=cuda_ms(lambda: ref.ref_rank_dots(qn, x)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def rank_dots_row(zorder: dict, multiprobe: dict, launches: dict) -> dict:
    """rank_dots at both of its launch shapes on the path, from
    :func:`rank_dots_at`: ZOrderIndex's one (Q, 2*window, d) block (the
    row's own numbers) and MultiProbeFlat's first query step, (Q / 4,
    ~10,000, d) (``multiprobe_launch``).  ``launches`` counts it by
    path."""
    return dict(
        name="rank_dots", route="cuda", design=DOTS_DESIGN,
        source="src/repro_torch/kernels/csrc/rank_dots.cu",
        replaces="src/repro/kernels/rank_candidates.py:52",
        launches=sum(launches.values()), launches_by_path=launches,
        **zorder,
        timed="through rank_dots_cuda, in turns with torch.bmm; "
              "kernel_ms: torch.profiler's kernel time",
        library_call="torch.bmm(x, q[:, :, None])",
        multiprobe_launch=multiprobe)


def hamming_row(keys) -> dict:
    """hamming on MultiProbeFlat's own keys: its 1024 query keys against
    HAMMING_KEYS keys of stored items (the first of them, topped up with
    fresh vectors when the hot path holds fewer; W = L words).  Nothing on
    any path calls it (the JAX package only names it), so its launches
    are this row's own.  Timed through ``hamming_cuda`` on the int64
    keys, its range check included; ``kernel_ms`` is the kernel alone."""
    a, b = keys
    before = ops.LAUNCHES["hamming"]
    got = ops.hamming(a, b)
    launches = ops.LAUNCHES["hamming"] - before
    plain = ref.ref_hamming(a, b)
    exact = torch.equal(got, plain)
    check(exact, "hamming: differs from its plain version")
    del got, plain
    nq, w = a.shape
    n = b.shape[0]
    ms = cuda_ms(lambda: hamming_cuda(a, b))
    k_ms = kernel_ms(lambda: hamming_cuda(a, b), iters=5, only="hamming")
    # a yardstick: the same (Q, N) int32 bytes written with no work
    out = torch.empty((nq, n), dtype=torch.int32, device=a.device)
    fill_ms = cuda_ms(lambda: out.fill_(1))
    del out
    # 32-bit xor, popcount and add per word, at the card's fp32 op rate
    # (the table has no integer rate outside the tensor cores)
    b_ms, b_by = bound_ms(4 * (nq * w + n * w + nq * n), 3 * nq * n * w)
    return dict(
        name="hamming", route="cuda", design=HAMMING_DESIGN,
        source="src/repro_torch/kernels/csrc/hamming.cu",
        replaces="src/repro/kernels/hamming.py:43",
        launches=launches, launches_from="this row (no path calls it)",
        max_abs_err=0 if exact else None, shape=[nq, n, w], ms=ms,
        kernel_ms=k_ms, fill_ms=fill_ms,
        timed="through hamming_cuda on the int64 keys, its range check "
              "(a reduction over each operand's high words, one readback) "
              "included; kernel_ms: torch.profiler's time of the hamming "
              "kernel alone; fill_ms: the output's bytes written by "
              "torch's fill_",
        plain_ms=cuda_ms(lambda: ref.ref_hamming(a, b), iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        library_call="none: no single PyTorch call computes it")


def staged_row(ranked, launches, metric: str) -> dict:
    """gather_rank_staged on the cold query's own ranking inputs; plus
    the bit-identity of a store row ranked through the staging arena."""
    q, store, staging, valid = (ranked[k] for k in ("qvecs", "store",
                                                    "staging", "valid"))
    slots = ranked["slots"].to(torch.int32)
    got = ops.gather_rank(q, store, slots, valid, metric, staging=staging)
    plain = ref.ref_gather_rank(q, store, slots, valid, metric,
                                staging=staging)
    check(torch.equal(torch.isinf(got), torch.isinf(plain)),
          "gather_rank_staged: +inf pattern differs")
    fin = torch.isfinite(plain)
    err = float((got[fin] - plain[fin]).abs().max()) if fin.any() else 0.0
    torch.testing.assert_close(got, plain, rtol=RANK_TOL, atol=RANK_TOL)
    n_store, d = store.shape
    nq, c = slots.shape
    is_staged = slots >= n_store
    n_valid = int(valid.sum())
    n_staged = int((valid & is_staged).sum())
    check(n_staged > 0, "the cold query ranked nothing from staging")
    qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-9)
    angular = metric == "angular"

    # bit-identity: every candidate pointed at a store row, then half of
    # them addressed through a staging arena holding copies of the rows
    hot = torch.where(is_staged, slots % n_store, slots)
    perm = torch.randperm(n_store, device=store.device)
    arena = torch.empty_like(store)
    arena[perm] = store
    mixed = torch.where(torch.arange(c, device=store.device) % 2 == 1,
                        n_store + perm[hot.long()].to(torch.int32), hot)
    bit_equal = torch.equal(
        gather_rank_cuda(qn, store, hot, valid, angular),
        gather_rank_staged_cuda(qn, store, arena, mixed, valid, angular))
    check(bit_equal, "a row ranked through the staging arena differs from "
          "the same row ranked from the store")
    del arena

    n_rows = int(torch.unique(slots[valid]).numel())   # both arenas
    ms = cuda_ms(lambda: gather_rank_staged_cuda(qn, store, staging, slots,
                                                 valid, angular))
    k_ms = kernel_ms(lambda: gather_rank_staged_cuda(qn, store, staging,
                                                     slots, valid, angular))
    b_ms, b_by = bound_ms(4 * (nq * d + n_rows * d + 2 * nq * c) + nq * c,
                          4 * n_valid * d)
    sl = slots.long()
    block = torch.where(is_staged[..., None],
                        staging[(sl - n_store).clamp(0, staging.shape[0] - 1)],
                        store[sl.clamp_max(n_store - 1)])   # (Q, C, d)
    return dict(
        name="gather_rank_staged", route="cuda", design=GATHER_DESIGN,
        source="src/repro_torch/kernels/csrc/gather_rank.cu",
        replaces="src/repro/kernels/gather_rank.py:144",
        launches=launches["gather_rank_staged"], max_abs_err=err,
        bit_identical_to_store=bit_equal, shape=[nq, c, d],
        staging_rows=int(staging.shape[0]), valid_candidates=n_valid,
        staged_candidates=n_staged, distinct_rows=n_rows,
        ms=ms, kernel_ms=k_ms,
        timed="through gather_rank_staged_cuda; kernel_ms: "
              "torch.profiler's kernel time",
        plain_ms=cuda_ms(lambda: ref.ref_gather_rank(
            q, store, slots, valid, metric, staging=staging)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.bmm(block, qn[:, :, None])))


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
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 products must not run in TF32 (the plain versions)")
    t0 = time.perf_counter()
    build_s = _build.build()
    emit(phase="build", torch=torch.__version__, cuda=torch.version.cuda,
         card=card, nvcc_s=build_s, build_s=time.perf_counter() - t0,
         ptxas=_build.ptxas_report())
    try:
        with ThreadPoolExecutor(3) as pool:
            lanes = start_examples(pool)
            phase_trace(args.seed)
            phase_cold_trace(args.seed)
            phase_stream_trace(args.seed)
            ex_runs = phase_examples(card, lanes)
    finally:
        shutil.rmtree(ROOT / EXAMPLES_CKPT, ignore_errors=True)
    idx, ranked, launches, hot = phase_main(args)
    rows = phase_kernels(idx, ranked, launches)
    phase_stream(args, idx, hot, rows)
    phase_checkpoint(args, idx, hot, rows)
    del idx, ranked
    torch.cuda.empty_cache()
    phase_dist(args, rows)
    torch.cuda.empty_cache()
    lm_launches, lm_pair = phase_lm(args, card, rows)
    torch.cuda.empty_cache()
    phase_train(args, card)
    torch.cuda.empty_cache()
    phase_families(args, card, rows)
    torch.cuda.empty_cache()
    phase_sharded(args, card, rows)
    torch.cuda.empty_cache()
    ex_pair = examples_rows(rows, ex_runs)
    hot_pair = pair_dist_at(hot["oracle_in"])
    feeds = phase_baselines(args, hot)
    pair_launches = dict(hot_oracle=hot["oracle_launches"],
                         lm=lm_launches["pair_dist"],
                         examples=sum(e["launches"]
                                      for e in ex_pair.values()))
    rows.append(rank_dots_row(
        rank_dots_at(feeds["zorder_dots_in"]),
        rank_dots_at(feeds["multiprobe_dots_in"]),
        dict(zorder=feeds["zorder"], multiprobe=feeds["multiprobe"])))
    rows.append(hamming_row(feeds["keys"]))
    del hot, feeds
    torch.cuda.empty_cache()
    ranked, cold_launches, pair_launches["cold_oracle"], cold_in = \
        phase_cold_main(args)
    rows.insert(2, staged_row(ranked, cold_launches, cold_config().metric))
    del ranked
    torch.cuda.empty_cache()
    rows.insert(3, pair_dist_row(hot_pair, pair_dist_at(cold_in), lm_pair,
                                 ex_pair, pair_launches))
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 products ran in TF32 during the run")
    emit(kernels=rows)
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
