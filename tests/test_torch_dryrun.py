"""The port's dry-run (``python -m repro_torch.launch.dryrun``) on the
fake 256-rank world, and its shape cells against the JAX package's.

One subprocess runs, at reduced widths on the 16 x 16 mesh, one cell of
every arch — each step kind at least once (train, prefill, decode and
``long_500k`` for an arch in ``LONG_OK``) — and the distributed PFO
rounds (``--pfo``).  Every cell reports ``ok: true``, and its
``argument_bytes`` equals the local shard bytes that the arch's policy
gives every param, optimizer leaf, batch and cache tensor (computed
here from the rule table on a device-free ``MeshShape``, the cache tree
on the meta device).  ``runnable_cells`` and ``skip_reason`` equal the
JAX package's.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import shapes as jshapes
from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import build_model
from repro_torch.sharding.policy import (MeshShape, cache_pspecs,
                                         layer_specs, make_policy,
                                         mesh_axes)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [
    ("smollm_135m", "train_4k"),
    ("llama4_scout_17b_a16e", "long_500k"),
    ("deepseek_v2_236b", "decode_32k"),
    ("nemotron_4_15b", "prefill_32k"),
    ("deepseek_coder_33b", "decode_32k"),
    ("qwen2_7b", "prefill_32k"),
    ("pixtral_12b", "decode_32k"),
    ("whisper_medium", "prefill_32k"),
    ("rwkv6_7b", "long_500k"),
    ("recurrentgemma_9b", "decode_32k"),
]
MESH = MeshShape(("data", "model"), (16, 16))


@pytest.fixture(scope="module")
def records():
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced",
         "--mesh", "single", "--pfo",
         "--cells", ",".join(f"{a}:{s}" for a, s in CELLS)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    recs = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    assert "dry-run complete" in out.stderr, out.stderr[-3000:]
    return {(r["arch"], r["shape"]): r for r in recs}, out.returncode


def _spec_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _spec_leaves(v)
    else:
        yield tree


def _local(shape, spec, itemsize: int) -> int:
    sizes = mesh_axes(MESH)
    n = math.prod(shape)
    for entry in spec:
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            n //= sizes[a]
    return n * itemsize


def _cache_leaves(tree, specs):
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k in tree:
            yield from _cache_leaves(tree[k], specs[k])
    elif isinstance(tree, (list, tuple)):
        for a, b in zip(tree, specs):
            yield from _cache_leaves(a, b)


def expected_argument_bytes(arch: str, shape: str) -> int:
    """What the dry-run's rank 0 holds of its step's arguments: f32
    params (and, training, f32 moments, an f32 master copy unless
    deepseek_v2, a 0-d int32 step), the batch split by the batch rule,
    the bf16 cache by the cache rules."""
    cfg = configs.get_config(arch, reduced=True)
    model = build_model(cfg)
    cell = shapes.SHAPES[shape]
    mode = "train" if cell.kind == "train" else "serve"
    pol = make_policy(MESH, cfg, mode, param_specs=model.param_specs,
                      small_batch=cell.global_batch < 16)
    per_param = sum(_local(s.shape, pol.param_spec(s.shape, s.axes), 4)
                    for s in _spec_leaves(layer_specs(model.param_specs)))
    total = per_param
    if mode == "train":
        total += per_param * (2 + (arch != "deepseek_v2_236b")) + 4
    specs = shapes.input_specs(cfg, shape, reduced=True)
    if cell.kind == "decode":
        specs = {"tokens": specs["tokens"]}
    for s in specs.values():
        total += _local(s.shape, pol.batch_spec(),
                        torch.empty((), dtype=s.dtype).element_size())
    if mode == "serve":
        b = specs["tokens"].shape[0]
        cache = tfm.init_cache(cfg, b, shapes.cache_len(shape, True),
                               torch.bfloat16, "meta")
        for t, spec in _cache_leaves(cache, cache_pspecs(pol, cfg, cache)):
            total += _local(t.shape, spec, t.element_size())
    return total


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dry_run_cell(records, arch, shape):
    recs, _ = records
    rec = recs[(arch, shape)]
    assert rec["ok"], rec.get("error")
    assert rec["mesh"] == "16x16"
    assert rec["argument_bytes"] == expected_argument_bytes(arch, shape)
    assert rec["flops"] > 0 and rec["collective_total"] > 0
    print(json.dumps(rec))


def test_dry_run_covers_every_kind():
    kinds = {shapes.SHAPES[s].kind for _, s in CELLS}
    assert kinds == {"train", "prefill", "decode"}
    assert {a for a, s in CELLS if s == "long_500k"} <= shapes.LONG_OK
    assert {a for a, _ in CELLS} == set(configs.ARCH_IDS)


def test_dry_run_pfo(records):
    recs, code = records
    rec = recs[("pfo_index", "q512_u512")]
    assert rec["ok"], rec.get("error")
    assert rec["state_bytes_per_shard"] > 0
    assert rec["query_collectives"] and rec["insert_collectives"]
    assert code == 0
    print(json.dumps(rec))


def test_shape_cells_match_jax():
    assert shapes.runnable_cells() == jshapes.runnable_cells()
    for a in configs.ARCH_IDS:
        for s in shapes.SHAPES:
            assert shapes.skip_reason(a, s) == jshapes.skip_reason(a, s)
            assert shapes.cache_len(s, True) == jshapes.cache_len(s, True)
    assert shapes.LONG_OK == jshapes.LONG_OK
    for name, cell in shapes.SHAPES.items():
        assert (cell.seq_len, cell.global_batch, cell.kind) == (
            jshapes.SHAPES[name].seq_len, jshapes.SHAPES[name].global_batch,
            jshapes.SHAPES[name].kind)


@pytest.mark.parametrize("arch", ["smollm_135m", "pixtral_12b",
                                  "whisper_medium"])
def test_input_specs_match_jax(arch):
    from repro import configs as jconfigs
    from repro_torch.data.pipeline import make_batch_specs
    for shape in shapes.SHAPES:
        for reduced in (False, True):
            got = shapes.input_specs(configs.get_config(arch, reduced),
                                     shape, reduced=reduced)
            want = jshapes.input_specs(jconfigs.get_config(arch, reduced),
                                       shape, reduced=reduced)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert make_batch_specs(configs.get_config(arch), shape) == \
            shapes.input_specs(configs.get_config(arch), shape)
    meta = shapes.meta_inputs(shapes.input_specs(
        configs.get_config(arch), "train_4k"))
    assert all(t.device.type == "meta" for t in meta.values())
