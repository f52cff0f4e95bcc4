"""The port's training path (``lm_loss``, AdamW, the train step, the
``Trainer`` with its checkpoints, ``launch/train.py``) against the JAX
package's on the CPU.

Weights are drawn by the JAX package and carried across with
``convert.params_from_numpy``; data comes from the same seeded
``SyntheticLM``.  In float32: ``lm_loss`` within 1e-5 relative on every
ported dense config (pixtral with patches), remat on and off; gradients
within 1e-4 relative in norm, leaf by leaf; the schedule and AdamW's
update within 1e-6; five train steps (losses, grad norms, final params
and moments) within 1e-4.  In bfloat16 compute the loss and gradients
within 3e-2 relative in norm and nearer the JAX bf16 run than its f32
run (``test_torch_models.py``'s rule).  Counterparts of
``tests/test_train_ckpt.py``: the loss falls, an exact resume, train
checkpoints crossing between the packages leaf for leaf, a half-written
step directory ignored.  Reduced llama4 (MoE) is held in
``test_torch_moe.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.models.registry import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro.train import make_train_step as jax_train_step
from repro_torch import configs, convert
from repro_torch.checkpoint import latest_step
from repro_torch.checkpoint.ckpt import flatten_with_paths, read_manifest
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import param_dict, stack_layers
from repro_torch.optim import adamw as tadamw
from repro_torch.train import TrainConfig, Trainer, make_train_step
from repro_torch.train.loop import restore_train_checkpoint, state_tree

torch.set_num_threads(1)

DENSE = ["smollm_135m", "qwen2_7b", "nemotron_4_15b", "deepseek_coder_33b",
         "pixtral_12b"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
OPT_TOL = 1e-6
STEP_TOL = 1e-4
BF16_TOL = 3e-2
B, TEXT, CHUNK = 2, 30, 4      # 30 // 4 = 7 does not divide 30: 6 chunks


def _pair(arch, dtype="f32", seed=0):
    jcfg = jax_configs.get_config(arch, reduced=True)
    tcfg = configs.get_config(arch, reduced=True)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jcfg = dataclasses.replace(jcfg, dtype=jdt)
    tcfg = dataclasses.replace(tcfg, dtype=tdt)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(seed), jnp.float32)
    tp = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, TEXT)).astype(
        np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, TEXT)).astype(
        np.int32)}
    if cfg.frontend == "patch":
        b["patches"] = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)
                                  ).astype(np.float32)
    return b


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def _rel(got, want) -> float:
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _leaves(tree) -> dict:
    """path -> leaf of a port (torch) or numpy tree, by the checkpoint
    paths of the JAX package."""
    return dict(flatten_with_paths(tree))


def _jax_tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ======================================================================
# lm_loss and its gradients
# ======================================================================
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_loss_matches_jax(arch, remat):
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg)
    want = float(jm.loss(jp, _jb(batch), remat=remat, loss_chunk=CHUNK))
    got = tm.loss(tp, _tb(batch), remat=remat, loss_chunk=CHUNK)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= LOSS_TOL * abs(want)
    # random init: the loss sits near ln(vocab), as the reference's smoke
    assert abs(want - np.log(tm.cfg.vocab_size)) < 2.0


def _jax_grads(jm, jp, batch, remat=True):
    return jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, remat=remat, loss_chunk=CHUNK)))(jp)


@pytest.mark.parametrize("arch", DENSE)
def test_grads_match_jax(arch):
    """The module's own parameters, with ``requires_grad_()`` turned on,
    take the reference's gradients through the checkpointed layers and
    loss chunks."""
    jm, jp, tm, tp = _pair(arch)
    batch = _batch(tm.cfg, seed=1)
    jloss, jg = _jax_grads(jm, jp, _jb(batch))
    tp.requires_grad_(True)
    loss = tm.loss(tp, _tb(batch), remat=True, loss_chunk=CHUNK)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    got = _leaves(stack_layers(tadamw.tree_map(lambda p: p.grad,
                                               param_dict(tp))))
    want = _leaves(_jax_tree_np(jg))
    assert got.keys() == want.keys()
    for path in want:
        assert _rel(got[path], want[path]) <= GRAD_TOL, path


def test_bf16_loss_and_grads_nearer_jax_bf16():
    """bf16 compute on float32 params (the trainer's setup): the port's
    loss and gradients within 3e-2 of the JAX package's bf16 run, leaf
    by leaf in norm, and, summed, nearer it than the JAX f32 run."""
    jm16, jp, tm16, tp = _pair("smollm_135m", "bf16", seed=3)
    jm32 = jax_build(dataclasses.replace(jm16.cfg, dtype=jnp.float32))
    batch = _batch(tm16.cfg, seed=2)
    l16, g16 = _jax_grads(jm16, jp, _jb(batch))
    l32, g32 = _jax_grads(jm32, jp, _jb(batch))
    tp.requires_grad_(True)
    loss = tm16.loss(tp, _tb(batch), remat=True, loss_chunk=CHUNK)
    loss.backward()
    loss = loss.detach()
    got = _leaves(stack_layers(tadamw.tree_map(lambda p: p.grad,
                                               param_dict(tp))))
    w16, w32 = _leaves(_jax_tree_np(g16)), _leaves(_jax_tree_np(g32))
    near = abs(float(loss) - float(l16)) / abs(float(l16))
    far = abs(float(loss) - float(l32)) / abs(float(l32))
    assert near <= BF16_TOL
    for path in w16:
        assert got[path].dtype == torch.float32, path
        err = _rel(got[path], w16[path])
        assert err <= BF16_TOL, f"{path}: {err}"
        near += err
        far += _rel(got[path], w32[path])
    assert near < far, f"{near} from the JAX bf16 run, {far} from its f32"


# ======================================================================
# the schedule and AdamW
# ======================================================================
def test_cosine_schedule_shape():
    cfg = tadamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)

    def at(s):
        return float(tadamw.cosine_schedule(cfg, torch.tensor(
            s, dtype=torch.int32)))
    assert at(0) == 0.0
    assert abs(at(10) - 1.0) < 1e-6
    assert at(100) == pytest.approx(0.1, rel=1e-3)


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 7), (5, 5)])
def test_cosine_schedule_matches_jax(warmup, total):
    kw = dict(lr=6e-4, warmup_steps=warmup, total_steps=total,
              min_lr_frac=0.1)
    steps = np.arange(0, total + 6, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.cosine_schedule(
        jadamw.AdamWConfig(**kw), s))(jnp.asarray(steps)))
    got = tadamw.cosine_schedule(tadamw.AdamWConfig(**kw),
                                 torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=OPT_TOL, atol=0)


def _opt_tree(rng, dtype=np.float32):
    return {"a": rng.normal(size=(4, 5)).astype(dtype),
            "b": {"c": rng.normal(size=(7,)).astype(dtype),
                  "d": rng.normal(size=(3, 2, 2)).astype(dtype)},
            "groups": [{"w": rng.normal(size=(2, 3, 3)).astype(dtype)}]}


def _to_torch(tree, dtype=None):
    return tadamw.tree_map(lambda a: torch.from_numpy(np.array(a)).to(
        dtype or torch.float32), tree)


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("grad_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_master", [True, False],
                         ids=["master", "no_master"])
def test_adamw_update_matches_jax(use_master, grad_dtype, clip):
    """Three updates on the same params and gradients (bf16 gradients
    carry the same bits in both packages): params, moments, master, step,
    grad norm and lr within 1e-6."""
    rng = np.random.default_rng(4)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              clip_norm=1.0 if clip else 1e6, use_master=use_master)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), tadamw.AdamWConfig(**kw)
    params = _opt_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    jo, to = jadamw.adamw_init(jcfg, jp), tadamw.adamw_init(tcfg, tp)
    for i in range(3):
        g = _opt_tree(rng)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16 if
                                                grad_dtype == "bf16"
                                                else jnp.float32), g)
        tg = tadamw.tree_map(lambda a: torch.from_numpy(np.array(
            jnp.asarray(a, jnp.float32))).to(
            torch.bfloat16 if grad_dtype == "bf16" else torch.float32),
            jax.tree.map(np.asarray, jg))
        jp, jo, jmet = jadamw.adamw_update(jcfg, jg, jo, jp)
        tp, to, tmet = tadamw.adamw_update(tcfg, tg, to, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=OPT_TOL, err_msg=k)
        assert (float(jmet["grad_norm"]) > kw["clip_norm"]) == clip
    assert int(to.step) == int(jo.step) == 3 and to.step.dtype == torch.int32
    for name, got, want in (("params", tp, jp), ("m", to.m, jo.m),
                            ("v", to.v, jo.v),
                            ("master", to.master, jo.master)):
        if want is None:
            assert got is None
            continue
        for a, b in zip(tadamw.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=OPT_TOL,
                                       atol=OPT_TOL, err_msg=name)


def test_adamw_moves_params_against_grad():
    cfg = tadamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                             total_steps=10)
    params = {"w": torch.ones((4,))}
    opt = tadamw.adamw_init(cfg, params)
    new, opt, metrics = tadamw.adamw_update(cfg, {"w": torch.ones((4,))},
                                            opt, params)
    assert (new["w"] < 1.0).all()
    assert float(metrics["grad_norm"]) == pytest.approx(2.0)


# ======================================================================
# the train step against the JAX package's
# ======================================================================
def _jax_steps(jm, jp, opt_cfg, data, n, loss_chunk=8):
    step = jax_train_step(jm, None, opt_cfg, loss_chunk)
    jp = jax.tree.map(jnp.copy, jp)          # the step donates its inputs
    opt = jadamw.adamw_init(opt_cfg, jp)
    out = []
    for i in range(n):
        jp, opt, met = step(jp, opt, _jb(data.batch(i)))
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return jp, opt, out


def _port_steps(tm, tp, opt_cfg, data, n, loss_chunk=8):
    step = make_train_step(tm, None, opt_cfg, loss_chunk)
    opt = tadamw.adamw_init(opt_cfg, param_dict(tp))
    embed, out = tp.embed, []
    for i in range(n):
        got, opt, met = step(tp, opt, _tb(data.batch(i)))
        assert got is tp and tp.embed is embed and not embed.requires_grad
        out.append((float(met["loss"]), float(met["grad_norm"])))
    return opt, out


STEP_KW = dict(lr=1e-2, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("use_master", [True, False],
                         ids=["master", "no_master"])
def test_train_steps_match_jax(use_master):
    """Five steps from the same converted init on the same batches:
    loss and grad norm at every step, then every param and moment leaf,
    within 1e-4; the module is updated in place."""
    jm, jp, tm, tp = _pair("smollm_135m")
    kw = dict(STEP_KW, use_master=use_master)
    data = SyntheticLM(tm.cfg.vocab_size, 32, 4, seed=5)
    jp, jopt, want = _jax_steps(jm, jp, jadamw.AdamWConfig(**kw), data, 5)
    opt, got = _port_steps(tm, tp, tadamw.AdamWConfig(**kw), data, 5)
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=0)
    mine = _leaves(state_tree(tp, opt))
    ref = _leaves((_jax_tree_np(jp), jax.tree.map(np.asarray, jopt)))
    assert mine.keys() == ref.keys()
    for path in ref:
        assert _rel(mine[path], ref[path]) <= STEP_TOL, path


def test_bf16_grad_steps_nearer_jax_bf16_grads():
    """``grad_dtype="bf16"`` differentiates with respect to a bf16 copy
    of the params, so each gradient is rounded to bf16 and a rounding
    that falls the other way moves the next steps (the JAX package's own
    bf16-gradient run leaves its f32 one by ~1e-3 in five steps).  Held
    as bf16 is: five steps' losses, grad norms and final params within
    3e-2 of the JAX bf16-gradient run, and, summed, nearer it than the
    JAX f32-gradient run."""
    jm, jp0, tm, tp = _pair("smollm_135m")
    data = SyntheticLM(tm.cfg.vocab_size, 32, 4, seed=5)
    runs = {g: _jax_steps(jm, jp0, jadamw.AdamWConfig(**STEP_KW,
                                                      grad_dtype=g), data, 5)
            for g in ("bf16", "f32")}
    _, got = _port_steps(tm, tp, tadamw.AdamWConfig(**STEP_KW,
                                                    grad_dtype="bf16"),
                         data, 5)
    mine = _leaves(tp.tree())
    near = far = 0.0
    for g, (jp, _, want) in runs.items():
        err = [abs(a - b) / abs(b) for x, y in zip(got, want)
               for a, b in zip(x, y)]
        ref = _leaves(_jax_tree_np(jp))
        err += [_rel(mine[p], ref[p]) for p in ref]
        if g == "bf16":
            assert max(err) <= BF16_TOL, max(err)
            near = sum(err)
        else:
            far = sum(err)
    assert near < far, f"{near} from the JAX bf16-gradient run, {far} " \
        "from its f32 one"


# ======================================================================
# the Trainer and its checkpoints (tests/test_train_ckpt.py's)
# ======================================================================
def _tcfg(tmp, steps, **kw):
    opt = kw.pop("opt", dict(lr=1e-3, warmup_steps=2, total_steps=40))
    return TrainConfig(steps=steps, ckpt_every=kw.pop("ckpt_every", 10),
                       log_every=1000, ckpt_dir=str(tmp), loss_chunk=16,
                       opt=tadamw.AdamWConfig(**opt), **kw)


def test_training_reduces_loss(tmp_path):
    cfg = configs.get_config("smollm_135m", reduced=True)
    data = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=8)
    tcfg = _tcfg(tmp_path / "ck", 100, ckpt_every=1000,
                 opt=dict(lr=1e-2, warmup_steps=10, total_steps=100,
                          weight_decay=0.0))
    out = Trainer(build_model(cfg), data, tcfg, device="cpu").run(
        resume=False)
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 1.0, (first, last)


def test_checkpoint_restart_exact_resume(tmp_path):
    """Stop at step 10, restart: the final params and optimizer state
    equal an uninterrupted run's."""
    cfg = configs.get_config("smollm_135m", reduced=True)
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, seq_len=32, global_batch=4)
    ref = Trainer(model, data, _tcfg(tmp_path / "a", 20),
                  device="cpu").run(resume=False)
    Trainer(model, data, _tcfg(tmp_path / "b", 10), device="cpu").run(
        resume=False)
    assert latest_step(str(tmp_path / "b")) == 10
    out = Trainer(model, data, _tcfg(tmp_path / "b", 20), device="cpu").run(
        resume=True)
    assert len(out["losses"]) == 10
    np.testing.assert_allclose(out["losses"], ref["losses"][10:], rtol=1e-6)
    a = _leaves(state_tree(ref["params"], ref["opt"]))
    b = _leaves(state_tree(out["params"], out["opt"]))
    assert a.keys() == b.keys()
    for path in a:
        np.testing.assert_allclose(_np(b[path]), _np(a[path]), rtol=1e-6,
                                   atol=1e-6, err_msg=path)


def _manifest(ckpt_dir, step):
    return {e["path"]: (e["dtype"], e["shape"])
            for e in read_manifest(ckpt_dir, step)["leaves"]}


@pytest.mark.parametrize("use_master", [True, False],
                         ids=["master", "no_master"])
def test_train_checkpoints_cross_between_packages(tmp_path, use_master):
    """A JAX ``Trainer``'s checkpoint restores into the port leaf for leaf
    (bit for bit), and the port's into the JAX package's ``(params,
    opt)``; both write the same leaf paths, dtypes and shapes
    (``master=None`` writes no leaves)."""
    arch = "smollm_135m"
    jcfg = jax_configs.get_config(arch, reduced=True)
    tcfg = configs.get_config(arch, reduced=True)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=40,
               use_master=use_master)
    jdata = SyntheticLM(jcfg.vocab_size, 32, 4, seed=1)
    jt = JTrainConfig(steps=2, ckpt_every=2, log_every=1000,
                      ckpt_dir=str(tmp_path / "jax"), loss_chunk=16,
                      opt=jadamw.AdamWConfig(**opt))
    jout = JTrainer(jax_build(jcfg), jdata, jt).run(resume=False)

    # JAX -> port
    model = build_model(tcfg)
    params = model.init(torch.Generator().manual_seed(9), torch.float32,
                        device="cpu")
    state = tadamw.adamw_init(tadamw.AdamWConfig(**opt), param_dict(params))
    params, state, extra = restore_train_checkpoint(str(tmp_path / "jax"), 2,
                                                    params, state)
    assert int(state.step) == 2 and (state.master is None) != use_master
    got = _leaves(state_tree(params, state))
    want = _leaves((_jax_tree_np(jout["params"]),
                    jax.tree.map(np.asarray, jout["opt"])))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(_np(got[path]), want[path], path)
    assert extra["loss"] == pytest.approx(jout["losses"][-1])

    # port -> JAX: a port run's checkpoint, read by the JAX package
    tout = Trainer(model, jdata, _tcfg(tmp_path / "port", 2, ckpt_every=2,
                                       opt=opt), device="cpu").run(
        resume=False)
    assert _manifest(str(tmp_path / "port"), 2) == _manifest(
        str(tmp_path / "jax"), 2)
    like = jax.tree.map(jnp.zeros_like, (jout["params"], jout["opt"]))
    (jp, jo), _ = jax_restore(str(tmp_path / "port"), 2, like)
    back = _leaves((_jax_tree_np(jp), jax.tree.map(np.asarray, jo)))
    mine = _leaves(state_tree(tout["params"], tout["opt"]))
    for path in mine:
        np.testing.assert_array_equal(back[path], _np(mine[path]), path)


def test_half_written_step_dir_is_ignored(tmp_path):
    """A crashed writer's step directory (no manifest) is never resumed
    from: the trainer picks up the last complete step."""
    cfg = configs.get_config("smollm_135m", reduced=True)
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, seq_len=16, global_batch=2)
    Trainer(model, data, _tcfg(tmp_path, 2, ckpt_every=1),
            device="cpu").run(resume=False)
    os.makedirs(tmp_path / "step_00000007")
    with open(tmp_path / "step_00000007" / "leaf_00000.npz", "wb") as f:
        f.write(b"partial")
    assert latest_step(str(tmp_path)) == 2
    out = Trainer(model, data, _tcfg(tmp_path, 3, ckpt_every=1),
                  device="cpu").run(resume=True)
    assert len(out["losses"]) == 1 and latest_step(str(tmp_path)) == 3


def test_opt_state_crosses_with_convert():
    """``convert.opt_from_numpy`` / ``opt_to_numpy`` carry the JAX
    package's ``OptState`` (stacked layers) exactly, both ways."""
    jm, jp, tm, tp = _pair("pixtral_12b")
    oc = jadamw.AdamWConfig()
    _, jo, _ = _jax_steps(jm, jp, oc, SyntheticLM(tm.cfg.vocab_size, 24, 2),
                          1)
    opt = convert.opt_from_numpy(jax.tree.map(np.asarray, jo))
    assert len(opt.m["groups"][0]) == tm.cfg.groups[0][1]
    back = convert.opt_to_numpy(opt)
    flat_a, tdef_a = jax.tree.flatten(jax.tree.map(np.asarray, jo._asdict()))
    flat_b, tdef_b = jax.tree.flatten(back)
    assert tdef_a == tdef_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_launch_train_cli(tmp_path, capsys):
    out = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                             "--seq", "16", "--batch", "2", "--ckpt",
                             str(tmp_path), "--no-resume"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert latest_step(str(tmp_path)) == 3
    assert "final loss" in capsys.readouterr().out
    assert out["slow_steps"] == []

