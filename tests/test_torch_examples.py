"""The port's four example programs against the JAX package's on the CPU.

``examples/{quickstart,streaming_recsys,knnlm_serving,train_smollm}_torch.py``
are the port's counterparts of the JAX package's example scripts.  Each
puts its body in ``run(device, ...)``, which returns what it prints; the
JAX side is built here from the JAX script's own configuration and seeds
(the scripts themselves are not run: they take minutes).

- quickstart: on the JAX index's projections, the ids equal and the
  distances within 1e-5 before and after the update and the delete, and
  the dispatch rounds and stats equal;
- streaming_recsys and knnlm_serving: ``tests/test_torch_examples_serving.py``
  (a file of their own, so each file stays near a minute and a half on
  one core: most of the time is the JAX side compiling its steps);
- train_smollm: reduced, on the CPU, 40 steps then a resume to 45 in a
  temp dir: the loss falls and the resume starts at the saved step; a
  JAX checkpoint of the same config resumes with the JAX weights, one of
  another config is refused.  (``tests/test_torch_train.py`` holds
  ``Trainer`` against the JAX package step by step.)

Besides: ``python examples/quickstart_torch.py --device cpu`` exits 0,
and each example without ``--device`` and without a card raises naming
``--device cpu``; ``chip_smoke.py``'s ``examples`` phase reads the
examples' printed lines as they print them.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.core import PFOConfig as JaxPFOConfig
from repro.core import PFOIndex as JaxIndex
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models.registry import build_model as jax_build
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro_torch import convert
from repro_torch.train import loop as train_loop

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

NAMES = ("quickstart", "streaming_recsys", "knnlm_serving", "train_smollm")
DIST_TOL = 1e-5


def _jax_proj(index) -> dict:
    return convert.proj_from_numpy(jax.tree.map(np.asarray, index.state.proj))


# ----------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------
def _jax_quickstart(cfg):
    """examples/quickstart.py's steps on the JAX index."""
    rng = np.random.default_rng(0)
    index = JaxIndex(JaxPFOConfig(**dataclasses.asdict(cfg)), seed=0)
    n = 5000
    vecs = rng.normal(size=(n, cfg.dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    rounds = [index.insert(np.arange(s, s + 1000, dtype=np.int32),
                           vecs[s:s + 1000]) for s in range(0, n, 1000)]
    stats = index.stats()
    queries = vecs[:5] + rng.normal(size=(5, cfg.dim)).astype(np.float32) * .02
    query = index.query(queries, k=5)
    index.update(np.array([0], np.int32), -vecs[:1])
    after_update = index.query(-vecs[:1], k=3)
    index.delete(np.array([1, 2], np.int32))
    after_delete = index.query(vecs[1:3], k=3)
    return dict(rounds=rounds, stats=stats, query=query,
                after_update=after_update, after_delete=after_delete,
                proj=_jax_proj(index))


def test_quickstart_matches_jax():
    qs = chip_smoke.example_module("quickstart")
    ref = _jax_quickstart(qs.config())
    got = qs.run("cpu", proj=ref["proj"])
    assert got["rounds"] == ref["rounds"]
    assert got["stats"] == {k: int(v) for k, v in ref["stats"].items()}
    for key in ("query", "after_update", "after_delete"):
        (jids, jd), (tids, td) = ref[key], got[key]
        np.testing.assert_array_equal(tids, np.asarray(jids), err_msg=key)
        np.testing.assert_allclose(td, np.asarray(jd), rtol=0,
                                   atol=DIST_TOL, err_msg=key)


# ----------------------------------------------------------------------
# train_smollm
# ----------------------------------------------------------------------
TRAIN_STEPS, RESUME_STEPS = 40, 45


def test_train_smollm_resumes(tmp_path, capsys):
    tr = chip_smoke.example_module("train_smollm")
    ckpt = str(tmp_path / "ckpt")
    first = tr.run("cpu", smoke=True, steps=TRAIN_STEPS, ckpt=ckpt)
    printed = chip_smoke.examples_train_run(
        dict(s=0.0, out=capsys.readouterr().out, launches={}))
    losses = first["losses"]
    assert printed["steps"] == TRAIN_STEPS and printed["first_step"] == 0
    assert [x for _, x in printed["logged"]] == [
        round(losses[i], 4) for i, _ in printed["logged"]]
    assert first["start"] == 0 and len(losses) == TRAIN_STEPS
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses
    assert sorted(os.listdir(ckpt)) == [f"step_{TRAIN_STEPS:08d}"]
    second = tr.run("cpu", smoke=True, steps=RESUME_STEPS, ckpt=ckpt)
    assert chip_smoke.examples_train_run(dict(
        s=0.0, out=capsys.readouterr().out, launches={}))["first_step"] \
        == TRAIN_STEPS
    assert second["start"] == TRAIN_STEPS
    assert len(second["losses"]) == RESUME_STEPS - TRAIN_STEPS
    assert np.isfinite(second["losses"]).all()
    assert all(np.isfinite(printed["gnorms"])) and min(printed["gnorms"]) > 0
    moved = chip_smoke.params_moved(ckpt, TRAIN_STEPS, RESUME_STEPS)
    assert moved and all(moved.values()), moved
    assert not any(chip_smoke.params_moved(ckpt, TRAIN_STEPS,
                                           TRAIN_STEPS).values())


def _jax_train_checkpoint(arch: str, ckpt: str, step: int):
    """A JAX train checkpoint of ``arch`` (reduced) at ``step``, of the
    state the JAX ``Trainer`` starts from."""
    cfg = jax_configs.get_config(arch, reduced=True)
    model = jax_build(cfg)
    trainer = JaxTrainer(model, JaxSyntheticLM(cfg.vocab_size, 16, 2),
                         JaxTrainConfig(steps=step, ckpt_dir=ckpt,
                                        opt=JaxAdamWConfig()))
    params, opt = trainer._init_state()
    jax_save_checkpoint(ckpt, step, (params, opt), {"loss": 0.0})
    return params


def test_train_smollm_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    tr = chip_smoke.example_module("train_smollm")
    ckpt = str(tmp_path / "jax")
    params = _jax_train_checkpoint("smollm_135m", ckpt, 3)
    restored = []
    real = train_loop.restore_train_checkpoint

    def restore(*a):
        out = real(*a)
        restored.append(jax.tree.map(np.array,
                                     convert.params_to_numpy(out[0])))
        return out
    monkeypatch.setattr(train_loop, "restore_train_checkpoint", restore)
    out = tr.run("cpu", smoke=True, steps=5, ckpt=ckpt)
    assert out["start"] == 3 and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    want = jax.tree.leaves(jax.tree.map(np.asarray, params))
    have = jax.tree.leaves(restored[0])
    assert len(want) == len(have)
    for w, h in zip(want, have):
        np.testing.assert_array_equal(np.asarray(h), w)


def test_train_smollm_refuses_another_configs_checkpoint(tmp_path):
    tr = chip_smoke.example_module("train_smollm")
    ckpt = str(tmp_path / "qwen2")
    _jax_train_checkpoint("qwen2_7b", ckpt, 3)
    with pytest.raises((ValueError, KeyError), match="checkpoint"):
        tr.run("cpu", smoke=True, steps=5, ckpt=ckpt)


# ----------------------------------------------------------------------
# the command lines
# ----------------------------------------------------------------------
def test_quickstart_runs_as_a_script():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "examples/quickstart_torch.py", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    printed = chip_smoke.examples_quickstart(
        dict(s=0.0, out=out.stdout, launches={}))
    assert [r[0] for r in printed["ids"]] == list(range(5))
    assert printed["after_update"][0] == 0


@pytest.mark.parametrize("name", NAMES)
def test_without_a_card_names_device_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        chip_smoke.example_module(name).main([])
