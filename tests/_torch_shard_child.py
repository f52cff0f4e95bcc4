"""One rank of the port's sharded LM checks, on gloo CPU ranks.

    python tests/_torch_shard_child.py RANK WORLD STORE_FILE WORK_DIR

``tests/test_torch_sharding.py`` starts WORLD (4) of these processes
with a ``FileStore`` path under its ``tmp_path`` (no network).
``WORK_DIR`` holds what the parent wrote with the JAX package: each
config's weights, batch and JAX outputs (``<case>.pkl``) and the JAX
``moe_apply_shardmap`` outputs (``moe_<case>.pkl``); the checks write
their checkpoints under it.  Every rank, on a ``(data, model)`` DeviceMesh
of (2, 2) and of (1, 4):

* serving: each config's prefill and 4 decode steps (f32) through
  ``make_prefill_step`` / ``make_decode_step`` with the serve policy,
  params, batch and cache placed, against the unsharded port on the same
  weights (1e-5 relative in norm) and the JAX package's logits (the
  model tests' 1e-4); the count of split leaves (local numel below
  global) on each grid;
* training: 3 steps of reduced smollm and of llama4 with
  ``moe_impl="shardmap"`` through the train policy, every leaf of the
  params and the optimizer state within 1e-5 of the unsharded port's;
* the layout: each rank's block of every param (train policy) and of a
  batch equals the slice that the JAX layout gives its mesh position, on
  the (2, 2) grid and on the (2, 2, 1) ``(pod, data, model)`` grid;
* ``moe_apply_shardmap`` on the (1, 4) grid against the JAX package's
  (1e-5), the same output rows dropped;
* ``analysis.analyze_step`` of a row-parallel product on (1, 4): one
  all-reduce of the output's bytes;
* elastic restore: a train checkpoint saved on (2, 2) restores bit-equal
  on (1, 4) and (in the parent) into one unsharded process; a JAX-written
  train checkpoint restores into the (2, 2) trainer, every leaf equal.

Prints one ``TORCH_SHARD_RESULT <json>`` line; exit code 0 == every
check held.  Imports nothing of JAX.
"""
import dataclasses
import json
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DeviceMesh, DTensor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro_torch import configs, convert                # noqa: E402
from repro_torch.checkpoint.ckpt import flatten_with_paths  # noqa: E402
from repro_torch.data import SyntheticLM                # noqa: E402
from repro_torch.models import moe as tmoe              # noqa: E402
from repro_torch.models.registry import build_model     # noqa: E402
from repro_torch.models.transformer import param_dict   # noqa: E402
from repro_torch.optim import AdamWConfig               # noqa: E402
from repro_torch.optim.adamw import tree_leaves         # noqa: E402
from repro_torch.serving.engine import (make_decode_step,  # noqa: E402
                                        make_prefill_step)
from repro_torch.sharding.policy import (distribute_cache,  # noqa: E402
                                         make_policy, mesh_axes,
                                         place_params)
from repro_torch.train import TrainConfig, Trainer      # noqa: E402
from repro_torch.train.loop import (restore_train_checkpoint,  # noqa: E402
                                    save_train_checkpoint, state_tree)

torch.set_num_threads(1)

#: one config a block family, named as the parent names them
CASES = {
    "smollm": ("smollm_135m", {}),
    "llama4_gspmd": ("llama4_scout_17b_a16e", {}),
    "llama4_shardmap": ("llama4_scout_17b_a16e", {"moe_impl": "shardmap"}),
    "deepseek_v2": ("deepseek_v2_236b", {}),
    "rwkv6": ("rwkv6_7b", {}),
    "recurrentgemma": ("recurrentgemma_9b", {}),
    "whisper": ("whisper_medium", {}),
}
GRIDS = ((2, 2), (1, 4))
SERVE_TOL = 1e-5
JAX_TOL = 1e-4                # tests/test_torch_models.py's f32 tolerance
TRAIN_TOL = 1e-5
TRAIN_STEPS = 3


def case_cfg(case: str):
    arch, over = CASES[case]
    return dataclasses.replace(configs.get_config(arch, reduced=True),
                               dtype=torch.float32, **over)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_of(grid, names=("data", "model")) -> DeviceMesh:
    return DeviceMesh("cpu", torch.arange(4).reshape(grid),
                      mesh_dim_names=names)


def split_leaves(tree) -> int:
    """Leaves whose local block is smaller than the whole."""
    return sum(1 for t in tree_leaves(tree) if isinstance(t, DTensor)
               and t.to_local().numel() < t.numel())


def _serve(model, params, batch, nxts, prefill, decode, place=None):
    cfg = model.cfg
    front = cfg.frontend_len if cfg.frontend == "patch" else 0
    t = batch["tokens"].shape[1] + front
    cache = model.init_cache(batch["tokens"].shape[0], t + len(nxts),
                             device="cpu")
    if place is not None:
        cache, batch = place(cache, batch)
    out = {}
    logits, cache, _ = prefill(params, batch, cache)
    out["prefill"] = full(logits)
    for i, nxt in enumerate(nxts):
        tok = torch.from_numpy(nxt)
        if place is not None:
            _, tok = place(None, tok)
        logits, cache = decode(params, tok, cache, t + i)
        out[f"decode {i}"] = full(logits)
    return out


def check_serving(work: str, mesh, res: dict) -> None:
    grid = "x".join(str(s) for s in mesh.shape)
    for case in CASES:
        with open(os.path.join(work, f"{case}.pkl"), "rb") as f:
            d = pickle.load(f)
        cfg = case_cfg(case)
        model = build_model(cfg)
        params = convert.params_from_numpy(cfg, d["params"])
        batch = {k: torch.from_numpy(v) for k, v in d["batch"].items()}
        want = _serve(model, params, batch, d["nxts"], model.prefill,
                      model.decode_step)
        pol = make_policy(mesh, cfg, "serve", param_specs=model.param_specs)
        sp = place_params(pol, model.param_specs, params)

        def place(cache, b, pol=pol, cfg=cfg):
            if cache is not None:
                cache = distribute_cache(pol, cfg, cache)
            if isinstance(b, dict):
                return cache, {k: pol.distribute(v, pol.batch_spec())
                               for k, v in b.items()}
            return cache, pol.distribute(b, pol.batch_spec())

        got = _serve(model, sp, batch, d["nxts"],
                     make_prefill_step(model, pol),
                     make_decode_step(model, pol), place)
        errs = {k: rel(got[k], want[k]) for k in want}
        jerr = {k: float((want[k] - torch.from_numpy(d["jax"][k])).abs()
                         .max()) for k in d["jax"]}
        # a (2, 2) grid may split nothing at these widths (heads that do
        # not divide): the (1, 4) grid must
        n_split = split_leaves(param_dict(sp))
        res["serve"][f"{case}@{grid}"] = {
            "max_rel": max(errs.values()), "jax_max_abs": max(jerr.values()),
            "split_leaves": n_split}
        assert max(errs.values()) <= SERVE_TOL, (case, grid, errs)
        assert max(jerr.values()) <= JAX_TOL, (case, grid, jerr)
        if mesh.shape == (1, 4):
            assert n_split > 0, (case, grid)


#: AdamW divides each gradient element by its own running scale, so a
#: rounding-level difference in a near-zero element's gradient (the
#: sharded sums run in another order) moves that param by up to ``lr``;
#: this lr keeps three such moves inside the tolerance
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def _trainer(cfg, work, name, policy=None, steps=TRAIN_STEPS):
    tcfg = TrainConfig(steps=steps, ckpt_every=10**6, log_every=10**6,
                       ckpt_dir=os.path.join(work, name), loss_chunk=8,
                       opt=AdamWConfig(**TRAIN_OPT))
    # the shard_map MoE's batch: 2 x 4 tokens, so its local capacity
    # cap2 cannot overflow on either grid (see the parent's PROMPT)
    seq, batch = (4, 2) if cfg.moe_impl == "shardmap" else (16, 4)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=3)
    return Trainer(build_model(cfg), data, tcfg, policy=policy,
                   device="cpu")


def _state_leaves(params, opt):
    return [full(t).detach() for t in tree_leaves(state_tree(params, opt))]


def check_training(work: str, mesh, res: dict) -> None:
    grid = "x".join(str(s) for s in mesh.shape)
    rank = dist.get_rank()
    for case in ("smollm", "llama4_shardmap"):
        cfg = case_cfg(case)
        ref = _trainer(cfg, work, f"plain_{case}_{rank}")
        want = ref.run(resume=False)
        pol = make_policy(mesh, cfg, "train",
                          param_specs=build_model(cfg).param_specs)
        tr = _trainer(cfg, work, f"shard_{case}_{grid}", pol)
        got = tr.run(resume=False)
        a = dict(flatten_with_paths(state_tree(want["params"], want["opt"])))
        b = dict(flatten_with_paths(state_tree(got["params"], got["opt"])))
        errs = {k: rel(full(b[k]), a[k]) for k in a}
        worst = max(errs.values())
        if worst > TRAIN_TOL and dist.get_rank() == 0:
            print(sorted(errs.items(), key=lambda kv: -kv[1])[:8])
        res["train"][f"{case}@{grid}"] = {
            "max_rel_leaf": worst,
            "split_leaves": split_leaves(param_dict(got["params"])),
            "losses": [got["losses"], want["losses"]]}
        assert worst <= TRAIN_TOL, (case, grid, worst)


def _jax_offset(grid_sizes: dict, coords: dict, spec, shape) -> list:
    """The JAX layout's block of a tensor: per dim, the (start, stop)
    that mesh position ``coords`` holds (axes of an entry major to
    minor, as a NamedSharding splits)."""
    out = []
    for dim, entry in zip(shape, spec):
        if entry is None:
            out.append((0, dim))
            continue
        group = (entry,) if isinstance(entry, str) else entry
        idx, n = 0, 1
        for a in group:
            idx = idx * grid_sizes[a] + coords[a]
            n *= grid_sizes[a]
        out.append((idx * dim // n, (idx + 1) * dim // n))
    return out


def check_layout(mesh, res: dict) -> None:
    """Every param leaf (train policy: TP and FSDP) and a batch, each
    rank's block against the JAX layout's slice of the full tensor."""
    names = mesh.mesh_dim_names
    sizes = mesh_axes(mesh)
    coords = dict(zip(names, mesh.get_coordinate()))
    n = 0
    for case in ("smollm", "llama4_gspmd", "deepseek_v2"):
        cfg = case_cfg(case)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(1), device="cpu")
        pol = make_policy(mesh, cfg, "train", param_specs=model.param_specs)
        sp = place_params(pol, model.param_specs, params)
        for full_t, t in zip(tree_leaves(param_dict(params)),
                             tree_leaves(param_dict(sp))):
            n += 1
            want = full_t
            # the leaf's spec, recovered from its placements
            spec = [None] * t.ndim
            for mi, p in enumerate(t.placements):
                if p.is_shard():
                    d = p.dim
                    spec[d] = (spec[d] or ()) + (names[mi],)
            for (lo, hi), d in zip(_jax_offset(sizes, coords, spec,
                                               t.shape), range(t.ndim)):
                want = want.narrow(d, lo, hi - lo)
            assert torch.equal(t.to_local(), want), (case, t.placements)
        tok = torch.arange(8 * 4).reshape(8, 4)
        pol = make_policy(mesh, cfg, "train")
        bt = pol.distribute(tok, pol.batch_spec())
        spec = pol.batch_spec() + (None,)
        want = tok
        for (lo, hi), d in zip(_jax_offset(sizes, coords, spec, tok.shape),
                               range(2)):
            want = want.narrow(d, lo, hi - lo)
        assert torch.equal(bt.to_local(), want)
    res["layout"]["x".join(map(str, mesh.shape))] = n


def check_moe(work: str, mesh, res: dict) -> None:
    """The block under ``moe_apply_shardmap`` against the JAX package's
    own on a (1, 4) host mesh."""
    for case in ("llama4", "deepseek_v2", "llama4_skewed"):
        with open(os.path.join(work, f"moe_{case}.pkl"), "rb") as f:
            d = pickle.load(f)
        cfg = dataclasses.replace(
            configs.get_config(d["arch"], reduced=True),
            dtype=torch.float32, moe_impl="shardmap",
            **d.get("overrides", {}))
        p = {k: torch.from_numpy(v) for k, v in d["params"].items()}
        x = torch.from_numpy(d["x"])
        pol = make_policy(mesh, cfg, "train",
                          param_specs=build_model(cfg).param_specs)
        blk_specs = tmoe.moe_param_specs(cfg)
        dp = {k: pol.distribute(v, pol.param_spec(blk_specs[k].shape,
                                                  blk_specs[k].axes))
              for k, v in p.items()}
        xd = pol.distribute(x, pol.batch_spec())
        with pol.context():
            y, info = tmoe.moe_apply_shardmap(dp, cfg, xd, pol.constrain,
                                              return_drops=True)
        y = full(y)
        err = float((y - torch.from_numpy(d["y"])).abs().max())
        dropped = info["dropped"].numpy()
        res["moe"][case] = {"max_abs": err, "dropped": int(dropped.sum())}
        assert err <= 1e-5, (case, err)
        # the JAX run's dropped rows: where its shard_map output leaves
        # the no-drop block's
        np.testing.assert_array_equal(dropped, d["dropped"])
        if case == "llama4_skewed":
            assert dropped.any(), "the skewed input must drop pairs"


def check_elastic(work: str, rank: int, res: dict) -> None:
    """Save on (2, 2), restore on (1, 4): every leaf bit-equal; a
    JAX-written train checkpoint into the (2, 2) trainer."""
    cfg = case_cfg("smollm")
    spec = build_model(cfg).param_specs
    m22, m14 = mesh_of((2, 2)), mesh_of((1, 4))
    tr = _trainer(cfg, work, "elastic", make_policy(m22, cfg, "train",
                                                    param_specs=spec))
    got = tr.run(resume=False)
    save_train_checkpoint(os.path.join(work, "elastic"), 99, got["params"],
                          got["opt"])
    want = _state_leaves(got["params"], got["opt"])
    # for the parent's restore into one process (every rank gathers)
    state = {path: full(t).detach().numpy() for path, t in
             flatten_with_paths(state_tree(got["params"], got["opt"]))}
    if rank == 0:
        with open(os.path.join(work, "elastic_state.pkl"), "wb") as f:
            pickle.dump(state, f)
    tr2 = _trainer(cfg, work, "elastic", make_policy(m14, cfg, "train",
                                                     param_specs=spec))
    params, opt = tr2._init_state()
    params, opt, _ = restore_train_checkpoint(
        os.path.join(work, "elastic"), 99, params, opt)
    back = _state_leaves(params, opt)
    assert all(torch.equal(a, b) for a, b in zip(back, want))
    assert split_leaves(param_dict(params)) > 0
    # the JAX package's train checkpoint, written by the parent
    with open(os.path.join(work, "jax_ckpt.pkl"), "rb") as f:
        jd = pickle.load(f)
    tr3 = _trainer(cfg, work, "elastic", make_policy(m22, cfg, "train",
                                                     param_specs=spec))
    params, opt = tr3._init_state()
    params, opt, _ = restore_train_checkpoint(jd["dir"], jd["step"], params,
                                              opt)
    got = {path: full(t).detach().numpy() for path, t in
           flatten_with_paths(state_tree(params, opt))}
    assert got.keys() == jd["leaves"].keys()
    for path, a in got.items():
        assert np.array_equal(a, jd["leaves"][path]), path
    res["elastic"] = {"leaves": len(want), "jax_leaves": len(got)}


def check_cost(mesh, res: dict) -> None:
    """A row-parallel product on the (1, 4) grid: ``analyze_step`` sees
    one all-reduce of the (8, 32) f32 output and the local product's
    FLOPs."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.analysis import analyze_step
    g = torch.Generator().manual_seed(5)
    x = torch.randn(8, 64, generator=g)
    w = torch.randn(64, 32, generator=g)
    xd = distribute_tensor(x, mesh, [Replicate(), Shard(1)],
                           src_data_rank=None)
    wd = distribute_tensor(w, mesh, [Replicate(), Shard(0)],
                           src_data_rank=None)
    y, st = analyze_step(lambda a, b: torch.matmul(a, b).redistribute(
        mesh, [Replicate(), Replicate()]), xd, wd)
    assert torch.allclose(y.to_local(), x @ w, rtol=1e-5, atol=1e-5)
    res["cost"] = st.to_dict()
    assert dict(st.collective_bytes) == {"all-reduce": 8 * 32 * 4}, \
        st.collective_bytes
    assert st.flops == 2 * 8 * 32 * (64 // 4), st.flops


def main():
    rank, world, store_file, work = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    res = {"serve": {}, "train": {}, "layout": {}, "moe": {}, "seconds": {}}
    ok = True
    try:
        t0 = time.perf_counter()
        for grid in GRIDS:
            mesh = mesh_of(grid)
            check_serving(work, mesh, res)
            res["seconds"][f"serve {grid}"] = time.perf_counter() - t0
            check_training(work, mesh, res)
            res["seconds"][f"train {grid}"] = time.perf_counter() - t0
        check_layout(mesh_of((2, 2)), res)
        check_layout(mesh_of((2, 2, 1), ("pod", "data", "model")), res)
        check_moe(work, mesh_of((1, 4)), res)
        check_cost(mesh_of((1, 4)), res)
        res["seconds"]["moe"] = time.perf_counter() - t0
        check_elastic(work, rank, res)
        res["seconds"]["total"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 — reported in the result line
        import traceback
        ok = False
        res["error"] = f"{type(e).__name__}: {e}"
        res["trace"] = traceback.format_exc()[-3000:]
    res["ok"] = ok
    print("TORCH_SHARD_RESULT " + json.dumps(res), flush=True)
    dist.destroy_process_group()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
