"""Multi-pod dry-run: build and run one step of every (arch x shape x
mesh) cell on a fake world, allocating nothing.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  For
each runnable cell (``repro_torch.configs.shapes.runnable_cells``):

  * a ``fake``-backend process group of 256 (16 x 16) or 512
    (2 x 16 x 16) ranks in this one process, this process rank 0, and the
    production DeviceMesh over it (``launch.mesh``);
  * the cell's params, optimizer state, batch and cache as DTensors
    placed by the arch's ``ShardingPolicy``, their local blocks fake
    tensors (``FakeTensorMode``: shapes and dtypes, no storage);
  * one train / prefill / decode step under ``analysis.cost.analyze_step``
    — success proves that DTensor can place every op of the step (the
    counterpart of ``.lower().compile()``), and the record carries what
    rank 0 would run: product FLOPs, an upper bound on its memory
    traffic, its collectives by kind and bytes, its argument and output
    bytes (local blocks) and its peak of live step outputs.

The fake group's collectives move no data, so values are meaningless;
shapes, placements and counts are exact.  A failed cell is recorded
with ``ok: false`` and its error, and the run goes on; the exit code is
1 if any cell failed.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm_135m --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single --out dry.jsonl
  python -m repro_torch.launch.dryrun --pfo          # PFO dist rounds
  python -m repro_torch.launch.dryrun --reduced --mesh single \
      --cells smollm_135m:train_4k,rwkv6_7b:long_500k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist

from .. import configs
from ..analysis.cost import analyze_step, local_bytes
from ..configs.shapes import SHAPES, cache_len, input_specs, runnable_cells
from ..models import transformer as tfm
from ..models.attention import KVCache, MLACache
from ..models.common import map_specs
from ..models.registry import build_model
from ..optim import AdamWConfig, adamw_init
from ..serving.engine import make_decode_step, make_prefill_step
from ..sharding.policy import distribute_cache, make_policy, place_tree
from ..train.loop import make_train_step
from .mesh import make_production_mesh


def fake_world(n: int) -> None:
    """A ``fake``-backend default group of ``n`` ranks in this process
    (rank 0); an existing group of another size is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


@contextlib.contextmanager
def _strided_index_math_on_host():
    """DTensor works out a strided split's local indices with tensor ops
    (an ``arange``, split, read back); under ``FakeTensorMode`` they have
    no values to read.  They index the mesh, not the model's data, so
    they run on real host tensors here (a no-op where DTensor has no
    such method)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    cls = getattr(placement_types, "_StridedShard", None)
    real = getattr(cls, "local_shard_size_and_offset", None)
    if real is None:
        yield
        return

    def on_host(self, *args, **kwargs):
        with unset_fake_temporarily():
            return real(self, *args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = real


def _with_length(cache, n: int):
    """The cache tree with every KV cache's filled prefix set to ``n``."""
    if isinstance(cache, (KVCache, MLACache)):
        return cache._replace(length=n)
    if isinstance(cache, dict):
        return {k: _with_length(v, n) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_with_length(v, n) for v in cache]
    return cache


def build_cell(arch: str, shape: str, mesh, *, reduced: bool = False,
               overrides: dict | None = None):
    """``(step, args)`` of one cell, every tensor placed; run it under
    ``FakeTensorMode`` to allocate nothing."""
    cfg = configs.get_config(arch, reduced=reduced)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    model = build_model(cfg)
    cell = SHAPES[shape]
    names = mesh.mesh_dim_names
    n_batch = 1
    for i, a in enumerate(names):
        if a in ("pod", "data"):
            n_batch *= mesh.size(i)
    small_batch = cell.global_batch < n_batch
    mode = "train" if cell.kind == "train" else "serve"
    policy = make_policy(mesh, cfg, mode, param_specs=model.param_specs,
                         small_batch=small_batch)
    dtype = torch.bfloat16 if not reduced else torch.float32
    tree = tfm.unstack_layers(map_specs(
        model.param_specs, lambda s: torch.empty(s.shape, dtype=dtype)))
    params = place_tree(policy, model.param_specs, tree)
    specs = input_specs(cfg, shape, reduced=reduced)
    batch = {k: policy.distribute(torch.zeros(s.shape, dtype=s.dtype),
                                  policy.batch_spec())
             for k, s in specs.items()}

    if cell.kind == "train":
        opt_cfg = AdamWConfig(use_master=(arch != "deepseek_v2_236b"))
        step = make_train_step(model, policy, opt_cfg, loss_chunk=512)
        opt = adamw_init(opt_cfg, params)
        return step, (params, opt, batch)

    clen = cache_len(shape, reduced)
    b = batch["tokens"].shape[0]
    cache = distribute_cache(policy, cfg, model.init_cache(
        b, clen, dtype=torch.bfloat16, device="cpu"))
    if cell.kind == "prefill":
        return make_prefill_step(model, policy), (params, batch, cache)
    # decode the cache's last position
    decode = make_decode_step(model, policy)
    return decode, (params, batch["tokens"], _with_length(cache, clen - 1),
                    clen - 1)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             reduced: bool = False, overrides: dict | None = None) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod)}
    if overrides:
        rec["overrides"] = overrides
    t0 = time.time()
    with FakeTensorMode(), _strided_index_math_on_host():
        step, args = build_cell(arch, shape, mesh, reduced=reduced,
                                overrides=overrides)
        out, st = analyze_step(step, *args)
    rec.update({
        "ok": True,
        "build_s": round(time.time() - t0, 1),
        "flops": st.flops,
        "bytes_accessed": st.bytes_accessed,
        "argument_bytes": local_bytes(args),
        "output_bytes": local_bytes(out),
        "peak_bytes": st.peak_bytes,
        "collective_bytes": dict(st.collective_bytes),
        "collective_total": st.collective_total,
    })
    return rec


def _pfo_mesh(multi_pod: bool):
    """The distributed index's ``StreamMesh`` on the fake world: 16 model
    shards, the rest data replicas (pod x data when multi-pod)."""
    from torch.distributed.tensor import DeviceMesh
    from ..sharding.policy import StreamMesh
    n = 512 if multi_pod else 256
    dm = DeviceMesh("cpu", torch.arange(n).reshape(n // 16, 16),
                    mesh_dim_names=("data", "model"))
    d_idx, shard = dm.get_coordinate()
    return StreamMesh(n_model=16, n_data=n // 16, shard=shard,
                      data_index=d_idx, device=torch.device("cpu"),
                      model_group=dm.get_group("model"),
                      data_group=dm.get_group("data"),
                      world_group=dist.group.WORLD, backend="fake")


def run_pfo(multi_pod: bool, reduced: bool = False) -> dict:
    """The distributed PFO query and insert rounds on the mesh: the
    reference's ``run_pfo`` config (dim 512, L 8, store 2^22, 16 model
    shards; ``reduced``: store 2^16, 512 queries)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..core import DistConfig, PFOConfig
    from ..core.distributed import dist_init_state, make_dist_insert, \
        make_dist_query
    fake_world(512 if multi_pod else 256)
    mesh = _pfo_mesh(multi_pod)
    cfg = PFOConfig(dim=512, L=8, C=5, m=4, l=64, t=4,
                    max_nodes_per_tree=512, max_leaves_per_tree=4096,
                    main_m=8, main_max_nodes_per_tree=512,
                    main_max_leaves_per_tree=16384,
                    store_capacity=1 << (16 if reduced else 22),
                    max_candidates_total=512)
    dcfg = DistConfig(pfo=cfg, n_model=16)
    n = 512 if reduced else 4096
    rec = {"arch": "pfo_index", "shape": f"q{n}_u{n}",
           "mesh": _mesh_name(multi_pod)}
    t0 = time.time()
    with FakeTensorMode():
        state = dist_init_state(dcfg, mesh, seed=0)
        q = torch.zeros((n, cfg.dim))
        ids = torch.zeros((n,), dtype=torch.int32)
        act = torch.ones((n,), dtype=torch.bool)
        qfn = make_dist_query(dcfg, mesh, k=10)
        _, qst = analyze_step(qfn, state, q)
        ifn = make_dist_insert(dcfg, mesh, capacity=n // 16 * 2)
        _, ist = analyze_step(ifn, state, ids, q, act)
    rec.update({
        "ok": True,
        "build_s": round(time.time() - t0, 1),
        "state_bytes_per_shard": local_bytes(state),
        "query_flops": qst.flops,
        "insert_flops": ist.flops,
        "query_collectives": dict(qst.collective_bytes),
        "insert_collectives": dict(ist.collective_bytes),
        "query_peak_bytes": qst.peak_bytes,
    })
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--pfo", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--moe-impl", default=None)
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch:shape cells to run")
    args = ap.parse_args(argv)
    overrides = {"moe_impl": args.moe_impl} if args.moe_impl else None

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    if args.cells:
        cells = [tuple(c.split(":")) for c in args.cells.split(",")]
    elif args.all:
        cells = runnable_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for a, s in runnable_cells()
                 if a == configs.ALIASES.get(args.arch, args.arch)]

    sink = open(args.out, "a") if args.out else None
    ok = fail = 0
    for mp in meshes:
        jobs = ([("pfo", None)] if args.pfo else []) + cells
        for arch, shape in jobs:
            try:
                if arch == "pfo":
                    rec = run_pfo(mp, reduced=args.reduced)
                else:
                    rec = run_cell(arch, shape, mp, reduced=args.reduced,
                                   overrides=overrides)
                ok += 1
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": "pfo_index" if arch == "pfo" else arch,
                       "shape": shape, "mesh": _mesh_name(mp), "ok": False,
                       "error": f"{type(e).__name__}: {e}"[:2000],
                       "trace": traceback.format_exc()[-2000:]}
                fail += 1
            print(json.dumps({k: v for k, v in rec.items()
                              if k != "trace"}), flush=True)
            if sink:
                sink.write(json.dumps(rec) + "\n")
                sink.flush()
    if sink:
        sink.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    print(f"# dry-run complete: {ok} ok, {fail} failed", file=sys.stderr)
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
