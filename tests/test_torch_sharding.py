"""The port's LM sharding (``repro_torch.sharding.policy`` on DTensor,
``moe_apply_shardmap``, sharded serving, training and the elastic
restore) against the JAX package, on the CPU.

* The rule tables, with no devices: for all ten configs at published
  widths, on the 16 x 16 and 2 x 16 x 16 production meshes, in train
  mode, serve mode and serve mode with ``small_batch``, the port's
  ``param_spec`` / ``cache_spec`` / ``act_spec`` give the JAX package's
  ``PartitionSpec`` entries for every leaf (the JAX policy built on a
  stub mesh that has no devices; its cache trees from ``jax.eval_shape``
  of ``init_cache``, the port's on the meta device), and
  ``estimate_param_bytes`` is equal.
* Four gloo ranks in subprocesses (``tests/_torch_shard_child.py``, a
  ``FileStore`` under ``tmp_path``): sharded serving and training equal
  the unsharded port (and serving the JAX package) on (2, 2) and (1, 4)
  grids, the layout of each rank's blocks is the JAX layout's,
  ``moe_apply_shardmap`` equals the JAX package's own ``shard_map`` run
  (a subprocess on four host devices) with the same rows dropped, a
  train checkpoint moves between meshes and packages, and
  ``analysis.analyze_step`` reports a row-parallel product's one
  all-reduce.  This module writes
  the JAX side's inputs and outputs for the children.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models.registry import build_model as jax_build
from repro.sharding import policy as jpol
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.optim import AdamWConfig as JAdamWConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro_torch import configs
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.data import SyntheticLM
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.sharding import policy as tpol
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.loop import restore_train_checkpoint, state_tree
from _torch_shard_child import CASES, TRAIN_OPT
from test_torch_models import B, T, _pair, _batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
MODES = [("train", False), ("serve", False), ("serve", True)]


# ======================================================================
# the rule tables, with no devices
# ======================================================================
def _jax_specs(tree) -> list:
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _port_specs(tree, out=None) -> list:
    """Spec leaves in ``jax.tree`` order (dict keys sorted, NamedTuple
    fields in order); a cache's host-int ``length`` skipped."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _port_specs(tree[k], out)
    elif isinstance(tree, list) or hasattr(tree, "_fields"):
        for v in tree:
            _port_specs(v, out)
    elif isinstance(tree, tuple):
        out.append(tree)
    return out


def _jax_cache_axes(jcfg, jcache) -> list:
    """The JAX cache tree's logical axes, leaf by leaf."""
    return jax.tree.leaves(
        jpol.cache_logical_axes(jcfg, jcache),
        is_leaf=lambda x: isinstance(x, tuple) and bool(x)
        and all(isinstance(e, str) for e in x))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_rule_tables_match_jax(arch):
    jm = jax_build(jax_configs.get_config(arch))
    tm = build_model(configs.get_config(arch))
    assert jpol.estimate_param_bytes(jm.param_specs) == \
        tpol.estimate_param_bytes(tm.param_specs)
    n = 0
    for mesh, (names, shape) in MESHES.items():
        jmesh = types.SimpleNamespace(axis_names=names,
                                      devices=np.empty(shape, object))
        tmesh = tpol.MeshShape(names, shape)
        for mode, small in MODES:
            jp = jpol.make_policy(jmesh, jm.cfg, mode,
                                  param_specs=jm.param_specs,
                                  small_batch=small)
            tp = tpol.make_policy(tmesh, tm.cfg, mode,
                                  param_specs=tm.param_specs,
                                  small_batch=small)
            want = _jax_specs(jp.param_pspecs(jm.param_specs))
            got = _port_specs(tp.param_pspecs(tm.param_specs))
            assert got == want, (mesh, mode, small)
            n += len(got)
            # activations: every logical axis the models name
            for axes in (("batch", "seq", "embed"), ("batch", "seq", "ffn"),
                         ("batch", "seq", "vocab"),
                         ("batch", "seq", "heads", "head_dim"),
                         ("batch", "seq", "kv_heads", "head_dim"),
                         ("experts", "exp_capacity", "embed"),
                         ("experts", "exp_capacity", "ffn")):
                shp = (256, 4096, 48, 128)[:len(axes)]
                assert tp.act_spec(shp, axes) == \
                    tuple(jp.act_spec(shp, axes)), (axes, mode)
            assert tp.batch_spec() == tuple(jp.batch_spec())
            if mode == "train":
                continue
            bsz, clen = (1, 524288) if small else (128, 32768)
            jc = jax.eval_shape(lambda: jm.init_cache(bsz, clen,
                                                      jnp.bfloat16))
            jspecs = _jax_specs(jpol.cache_pspecs(jp, jm.cfg, jc))
            jaxes = _jax_cache_axes(jm.cfg, jc)
            tcache = tfm.init_cache(tm.cfg, bsz, clen, torch.bfloat16,
                                    "meta")
            got = tpol.cache_pspecs(tp, tm.cfg, tcache)
            # the JAX tree stacks a group's layers: its leaves, less the
            # ``layers`` entry (and its ``length`` leaves), once a layer
            want = []
            for g, (pat, rep) in enumerate(jm.cfg.groups):
                k = len(_jax_specs(jpol.cache_pspecs(jp, jm.cfg, [jc[g]])))
                lo = sum(len(_jax_specs(jpol.cache_pspecs(jp, jm.cfg,
                                                          [jc[i]])))
                         for i in range(g))
                per = [s[1:] for s, a in zip(jspecs[lo:lo + k],
                                             jaxes[lo:lo + k])
                       if a != ("layers",)]
                want += per * rep
            assert _port_specs(got) == want, (mesh, mode, small)
            n += len(want)
    print(f"{arch}: {n} leaf specs equal")


def test_placements_follow_the_mesh_order():
    """A spec entry becomes Shard on each mesh dim it names, but a dim of
    size 1; a dim split over (pod, data) names them in the mesh's order
    (pod-major)."""
    from torch.distributed.tensor import Replicate, Shard
    pol = tpol.make_policy(tpol.MeshShape(("pod", "data", "model"),
                                          (2, 2, 2)),
                           configs.get_config("smollm_135m", reduced=True),
                           "train")
    assert pol.batch_spec() == (("pod", "data"),)
    assert pol.placements(pol.batch_spec()) == (Shard(0), Shard(0),
                                                Replicate())
    assert pol.placements((None, "model")) == (Replicate(), Replicate(),
                                               Shard(1))
    one = tpol.make_policy(tpol.MeshShape(("data", "model"), (1, 1)),
                           configs.get_config("smollm_135m"), "serve")
    assert one.placements(one.batch_spec()) == (Replicate(), Replicate())


# ======================================================================
# four ranks in subprocesses
# ======================================================================
#: prompt lengths: the shard_map MoE case's prompt is short enough that
#: the reference's local capacity ``cap2`` cannot overflow on either grid
#: (S ranks each send an expert at most n_loc * k <= cap2 / S rows), so
#: the unsharded block (which drops nothing) is its reference; dropping
#: is held against the JAX package's shard_map below
PROMPT = {"llama4_shardmap": 4}


def _jax_forward(jm, jp, batch) -> dict:
    """The JAX package's last-position logits of the prompt."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    hidden, _ = jm.forward(jp, jb)
    return {"prefill": np.asarray(jm.logits(jp, hidden[:, -1:]))}


def _write_cases(work: str) -> None:
    for case, (arch, over) in CASES.items():
        jcfg, jm, jp, tm, _ = _pair(arch, "f32")
        rng = np.random.default_rng(7)
        batch = _batch(jcfg, rng, PROMPT.get(case, T))
        nxts = [rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
                for _ in range(4)]
        jax_out = _jax_forward(jm, jp, batch)
        with open(os.path.join(work, f"{case}.pkl"), "wb") as f:
            pickle.dump({"params": jax.tree.map(np.asarray, jp),
                         "batch": batch, "nxts": nxts, "jax": jax_out}, f)


MOE_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["REPRO_PALLAS"] = "off"
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro import compat, configs
from repro.models import moe as moe_mod
from repro.models.common import init_params

work = sys.argv[1]
mesh = jax.make_mesh((1, 4), ("data", "model"))
for case, arch, skew in (("llama4", "llama4_scout_17b_a16e", 0.0),
                         ("deepseek_v2", "deepseek_v2_236b", 0.0),
                         ("llama4_skewed", "llama4_scout_17b_a16e", 4.0)):
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              dtype=jnp.float32)
    mp = jax.tree.map(np.asarray, init_params(
        moe_mod.moe_param_specs(cfg), jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    if skew:
        # every token leans on expert 0: the local mailboxes overflow
        mp = dict(mp)
        r = mp["router"].copy()
        r[:, 0] += skew * np.sign(x.mean((0, 1)))
        mp["router"] = r
    jp = jax.tree.map(jnp.asarray, mp)
    with compat.set_mesh(mesh):
        y = np.asarray(jax.jit(lambda p, v: moe_mod.moe_apply_shardmap(
            p, cfg, v))(jp, jnp.asarray(x)))
    full = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    ref = np.asarray(jax.jit(lambda p, v: moe_mod.moe_apply(p, full, v))(
        jp, jnp.asarray(x)))
    scale = np.abs(ref).max()
    dropped = np.abs(y - ref).max(-1) > 1e-5 * scale
    with open(os.path.join(work, f"moe_{case}.pkl"), "wb") as f:
        pickle.dump({"arch": arch, "params": mp, "x": x, "y": y,
                     "dropped": dropped}, f)
print("OK")
"""


def _write_moe(work: str) -> None:
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", MOE_SCRIPT, work], env=env,
                         capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert "OK" in out.stdout, out.stderr[-3000:]


ELASTIC_OPT = TRAIN_OPT


def _write_jax_ckpt(work: str) -> None:
    """A JAX ``Trainer``'s checkpoint of reduced smollm, and its leaves."""
    cfg = jax_configs.get_config("smollm_135m", reduced=True)
    d = os.path.join(work, "jax_ckpt")
    jt = JTrainConfig(steps=2, ckpt_every=2, log_every=1000, ckpt_dir=d,
                      loss_chunk=8, opt=JAdamWConfig(**ELASTIC_OPT))
    out = JTrainer(jax_build(cfg), JSyntheticLM(cfg.vocab_size, 16, 4,
                                                seed=1), jt).run(
        resume=False)
    tree = jax.tree.map(np.asarray, (out["params"], out["opt"]))
    with open(os.path.join(work, "jax_ckpt.pkl"), "wb") as f:
        pickle.dump({"dir": d, "step": 2,
                     "leaves": dict(flatten_with_paths(tree))}, f)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("shard"))
    _write_cases(work)
    _write_moe(work)
    _write_jax_ckpt(work)
    store = os.path.join(work, "store")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_shard_child.py"),
         str(r), "4", store, work], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        line = [ln for ln in out.splitlines()
                if ln.startswith("TORCH_SHARD_RESULT ")]
        assert line, err[-3000:]
        results.append(json.loads(line[0].split(" ", 1)[1]))
    for r in results:
        assert r["ok"], r.get("trace", r)
    print(json.dumps(results[0], indent=1))
    return work, results


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_serving_equals_unsharded(four_ranks, case):
    _, results = four_ranks
    for r in results:
        for grid in ("2x2", "1x4"):
            got = r["serve"][f"{case}@{grid}"]
            assert got["max_rel"] <= 1e-5 and got["jax_max_abs"] <= 1e-4
        assert r["serve"][f"{case}@1x4"]["split_leaves"] > 0
    print(case, {g: results[0]["serve"][f"{case}@{g}"] for g in ("2x2",
                                                                 "1x4")})


@pytest.mark.parametrize("case", ["smollm", "llama4_shardmap"])
def test_sharded_training_equals_unsharded(four_ranks, case):
    _, results = four_ranks
    for r in results:
        for grid in ("2x2", "1x4"):
            got = r["train"][f"{case}@{grid}"]
            assert got["max_rel_leaf"] <= 1e-5
        assert r["train"][f"{case}@1x4"]["split_leaves"] > 0


@pytest.mark.parametrize("grid", ["2x2", "2x2x1"])
def test_blocks_follow_the_jax_layout(four_ranks, grid):
    _, results = four_ranks
    assert all(r["layout"][grid] > 0 for r in results)


@pytest.mark.parametrize("case", ["llama4", "deepseek_v2", "llama4_skewed"])
def test_moe_shardmap_matches_jax_shard_map(four_ranks, case):
    _, results = four_ranks
    for r in results:
        assert r["moe"][case]["max_abs"] <= 1e-5
    if case == "llama4_skewed":
        assert results[0]["moe"][case]["dropped"] > 0
    print(case, results[0]["moe"][case])


def test_row_parallel_product_reports_one_all_reduce(four_ranks):
    """``analyze_step`` on a (1, 4) gloo grid: a row-parallel (8, 64) x
    (64, 32) f32 product brought to every rank is one all-reduce of
    8 x 32 x 4 bytes, and a quarter of the product's FLOPs a rank."""
    _, results = four_ranks
    for r in results:
        assert r["cost"]["collective_bytes"] == {"all-reduce": 1024.0}
        assert r["cost"]["flops"] == 2 * 8 * 32 * 16
    print(results[0]["cost"])


def test_elastic_restore_into_one_process(four_ranks):
    """The (2, 2) grid's checkpoint into an unsharded CPU trainer: every
    leaf bit-equal to the sharded run's state."""
    work, results = four_ranks
    assert all(r["elastic"]["jax_leaves"] > 0 for r in results)
    with open(os.path.join(work, "elastic_state.pkl"), "rb") as f:
        want = pickle.load(f)
    cfg = dataclasses.replace(configs.get_config("smollm_135m",
                                                 reduced=True),
                              dtype=torch.float32)
    tr = Trainer(build_model(cfg), SyntheticLM(cfg.vocab_size, 16, 4),
                 TrainConfig(opt=AdamWConfig(**ELASTIC_OPT)), device="cpu")
    params, opt = tr._init_state()
    params, opt, _ = restore_train_checkpoint(
        os.path.join(work, "elastic"), 99, params, opt)
    got = {p: t.detach().numpy()
           for p, t in flatten_with_paths(state_tree(params, opt))}
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], path)
