"""RWKV-6 (``repro_torch.models.rwkv6``) and RG-LRU
(``repro_torch.models.rglru``) and the reduced ``rwkv6_7b`` and
``recurrentgemma_9b`` (RG-LRU with local attention) against the JAX
package on the CPU.

The reference initialises most of these blocks' small leaves to zero
(RWKV-6's token-shift mixes, decay lora, bonus ``u``; RG-LRU's conv,
``Lambda`` and gate biases), and with ``conv_w = 0`` the RG-LRU branch
outputs exactly 0: every leaf here is drawn from seeded numpy, the
zero-init ones with std 0.1.  The blocks: a 12-token prefill from the
zero state, then from the carried state another prefill and decode
steps, outputs and states within 1e-5 in float32; a sequence run in two
parts through the carried state equals one pass (1e-5); in bfloat16
within 3e-2 of the JAX package's bf16 run, relative in norm, and nearer
it than its f32 run; RWKV's data-dependent token shift and RG-LRU's
temporal conv give the reference's bf16 bits.  The models through
``tests/_torch_families.py``: prefill + decode == forward (3e-2),
``lm_loss`` and every gradient leaf, greedy generation; and a train
checkpoint of rwkv6 crosses between the packages leaf for leaf.

Run as a script, it prints how far each package's bf16 decode drifts
from its own forward in a deeper stack (:func:`decode_drift`)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/test_torch_recurrent.py
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro import configs as jax_configs
from repro.checkpoint import restore_checkpoint as jax_restore
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.models.registry import build_model as jax_build
from repro.optim import adamw as jadamw
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import configs, convert
from repro_torch.data import SyntheticLM
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import param_dict
from repro_torch.optim import adamw as tadamw
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.loop import restore_train_checkpoint, state_tree
from test_torch_train import _jax_tree_np, _leaves, _manifest
from test_torch_train import _np as _np_any

torch.set_num_threads(1)

TOL = 1e-5
BF16_TOL = 3e-2
B = 2
KINDS = {"rwkv": "rwkv6_7b", "rglru": "recurrentgemma_9b"}
SPECS = {"rwkv": (jrwkv.rwkv_param_specs, trwkv.rwkv_param_specs),
         "rglru": (jrglru.rglru_param_specs, trglru.rglru_param_specs)}


def _cfgs(kind, dtype="f32"):
    arch = KINDS[kind]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return (dataclasses.replace(jax_configs.get_config(arch, reduced=True),
                                dtype=jdt),
            dataclasses.replace(configs.get_config(arch, reduced=True),
                                dtype=tdt))


def _weights(kind, seed=0) -> dict:
    """Every leaf drawn: matrices with std 1/sqrt(fan_in), ones around
    1, zero-init leaves with std 0.1 (``Lambda`` included, so a = sigmoid
    of it spreads around 0.5)."""
    _, tc = _cfgs(kind)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in SPECS[kind][1](tc).items():
        if s.init == "ones":
            a = 1 + rng.normal(size=s.shape) * 0.1
        elif s.init == "zeros":
            a = rng.normal(size=s.shape) * 0.1
        else:
            a = rng.normal(size=s.shape) / np.sqrt(s.shape[-2])
        out[k] = a.astype(np.float32)
    return out


def _jax_block(kind, p, cfg, x, st):
    if kind == "rwkv":
        o, st = jrwkv.time_mix(p, cfg, x, st)
        o2, st = jrwkv.channel_mix(p, cfg, x + o, st)
        return o + o2, st
    return jrglru.rglru_apply(p, cfg, x, st)


def _port_block(kind, p, cfg, x, st):
    if kind == "rwkv":
        o, st = trwkv.time_mix(p, cfg, x, st)
        o2, st = trwkv.channel_mix(p, cfg, x + o, st)
        return o + o2, st
    return trglru.rglru_apply(p, cfg, x, st)


def _run(pkg, kind, w, cfg, x, dtype, parts):
    """The block over ``x`` (B, T, D) in consecutive parts of the given
    lengths, the state carried from the zero state; returns each part's
    output and the final state."""
    if pkg == "jax":
        p = {k: jnp.asarray(v, dtype) for k, v in w.items()}
        xs = jnp.asarray(x, dtype)
        st = (jrwkv.rwkv_init_state if kind == "rwkv"
              else jrglru.rglru_init_state)(cfg, B, dtype)
        fn = _jax_block
    else:
        p = {k: torch.from_numpy(v).to(dtype) for k, v in w.items()}
        xs = torch.from_numpy(x).to(dtype)
        st = (trwkv.rwkv_init_state if kind == "rwkv"
              else trglru.rglru_init_state)(cfg, B, dtype, "cpu")
        fn = _port_block
    outs, at = [], 0
    for n in parts:
        o, st = fn(kind, p, cfg, xs[:, at:at + n], st)
        outs.append(o)
        at += n
    return outs, st


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _x(tc, t, seed):
    return np.random.default_rng(seed).normal(size=(B, t, tc.d_model)
                                              ).astype(np.float32)


PARTS = [12, 5, 1, 1]             # prefill, a second prefill, two decodes


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_matches_jax(kind):
    jc, tc = _cfgs(kind)
    w = _weights(kind)
    x = _x(tc, sum(PARTS), 1)
    want, jst = _run("jax", kind, w, jc, x, jnp.float32, PARTS)
    got, tst = _run("port", kind, w, tc, x, torch.float32, PARTS)
    for i, (g, wv) in enumerate(zip(got, want)):
        assert np.abs(_np(wv)).max() > 0.1            # nothing vanished
        np.testing.assert_allclose(_np(g), _np(wv), rtol=0, atol=TOL,
                                   err_msg=f"part {i}")
    for name, a in jst._asdict().items():
        b = getattr(tst, name)
        assert b.dtype == (torch.float32 if name in ("S", "h")
                           else tc.dtype), name
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_split_sequence_equals_one_pass(kind):
    _, tc = _cfgs(kind)
    w = _weights(kind, seed=2)
    x = _x(tc, 16, 3)
    (one,), st1 = _run("port", kind, w, tc, x, torch.float32, [16])
    two, st2 = _run("port", kind, w, tc, x, torch.float32, [9, 7])
    np.testing.assert_allclose(_np(torch.cat(two, 1)), _np(one), rtol=0,
                               atol=TOL)
    for a, b in zip(st1, st2):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_block_bf16_nearer_jax_bf16(kind):
    jc16, tc16 = _cfgs(kind, "bf16")
    jc32, _ = _cfgs(kind)
    w = _weights(kind, seed=4)
    x = _x(tc16, sum(PARTS), 5)
    want16, _ = _run("jax", kind, w, jc16, x, jnp.bfloat16, PARTS)
    want32, _ = _run("jax", kind, w, jc32, x, jnp.float32, PARTS)
    got, _ = _run("port", kind, w, tc16, x, torch.bfloat16, PARTS)
    near = far = 0.0
    for g, w16, w32 in zip(got, want16, want32):
        assert g.dtype == torch.bfloat16
        g, w16, w32 = _np(g), _np(w16), _np(w32)
        err = np.linalg.norm(g - w16) / np.linalg.norm(w16)
        assert err <= BF16_TOL, err
        near += err
        far += np.linalg.norm(g - w32) / np.linalg.norm(w32)
    assert near < far, (near, far)


@pytest.mark.parametrize("fn", ["ddlerp", "conv1d"])
def test_bf16_bits(fn):
    """Op-by-op bf16 chains the reference spells out: RWKV's
    data-dependent token shift (dense, tanh, the exact sigmoid, the
    lerp) and RG-LRU's causal conv over a carried window."""
    kind = "rwkv" if fn == "ddlerp" else "rglru"
    jc, tc = _cfgs(kind, "bf16")
    w = _weights(kind, seed=6)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 9, tc.d_model if fn == "ddlerp"
                         else tc.lru_width)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    if fn == "ddlerp":
        prev = np.roll(x, 1, axis=1)
        want = jrwkv._ddlerp(jp, jx, jnp.asarray(prev, jnp.bfloat16))
        got = trwkv._ddlerp(tp, tx, torch.from_numpy(prev).to(
            torch.bfloat16))
    else:
        win = rng.normal(size=(B, tc.conv_width - 1, tc.lru_width))
        jst = jrglru.RGLRUState(jnp.zeros((B, tc.lru_width), jnp.float32),
                                jnp.asarray(win, jnp.bfloat16))
        tst = trglru.RGLRUState(torch.zeros((B, tc.lru_width)),
                                torch.from_numpy(win).to(torch.bfloat16))
        (want, wconv), (got, gconv) = (jrglru._conv1d(jp, jc, jx, jst),
                                       trglru._conv1d(tp, tc, tx, tst))
        np.testing.assert_array_equal(_np(gconv), _np(wconv))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("arch", sorted(KINDS.values()))
def test_prefill_decode_matches_forward(arch):
    fam.prefill_decode_matches_forward(arch)


@pytest.mark.parametrize("arch", sorted(KINDS.values()))
def test_loss_and_grads_match_jax(arch):
    fam.loss_and_grads_match_jax(arch)


@pytest.mark.parametrize("arch", sorted(KINDS.values()))
def test_generate_matches_jax(arch):
    fam.generate_matches_jax(arch)


def test_rwkv_train_checkpoint_crosses_between_packages(tmp_path):
    """A JAX ``Trainer``'s rwkv6 checkpoint restores into the port leaf
    for leaf, bit for bit, and the port's into the JAX package's
    ``(params, opt)`` with the same leaf paths, dtypes and shapes."""
    arch = "rwkv6_7b"
    jcfg = jax_configs.get_config(arch, reduced=True)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=40)
    data = SyntheticLM(jcfg.vocab_size, 16, 2, seed=1)
    jt = JTrainConfig(steps=2, ckpt_every=2, log_every=1000,
                      ckpt_dir=str(tmp_path / "jax"), loss_chunk=8,
                      opt=jadamw.AdamWConfig(**opt))
    jout = JTrainer(jax_build(jcfg), data, jt).run(resume=False)

    model = build_model(configs.get_config(arch, reduced=True))
    params = model.init(torch.Generator().manual_seed(9), torch.float32,
                        device="cpu")
    state = tadamw.adamw_init(tadamw.AdamWConfig(**opt), param_dict(params))
    params, state, _ = restore_train_checkpoint(str(tmp_path / "jax"), 2,
                                                params, state)
    got = _leaves(state_tree(params, state))
    want = _leaves((_jax_tree_np(jout["params"]),
                    jax.tree.map(np.asarray, jout["opt"])))
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_array_equal(_np_any(got[path]), want[path], path)

    tcfg = TrainConfig(steps=2, ckpt_every=2, log_every=1000,
                       ckpt_dir=str(tmp_path / "port"), loss_chunk=8,
                       opt=tadamw.AdamWConfig(**opt))
    tout = Trainer(model, data, tcfg, device="cpu").run(resume=False)
    assert _manifest(str(tmp_path / "port"), 2) == _manifest(
        str(tmp_path / "jax"), 2)
    like = jax.tree.map(jnp.zeros_like, (jout["params"], jout["opt"]))
    (jp, jo), _ = jax_restore(str(tmp_path / "port"), 2, like)
    back = _leaves((_jax_tree_np(jp), jax.tree.map(np.asarray, jo)))
    for path, leaf in _leaves(state_tree(tout["params"],
                                         tout["opt"])).items():
        np.testing.assert_array_equal(back[path], _np_any(leaf), path)


# ======================================================================
# bf16 decode drift in a deeper stack, printed (not a test)
# ======================================================================
def _drift_cfg(pkg_configs, arch, dtype):
    base = pkg_configs.get_config(arch)
    if arch == "rwkv6_7b":
        return dataclasses.replace(base, d_model=1024, n_heads=16,
                                   head_dim=64, d_ff=3584, vocab_size=4096,
                                   groups=((base.groups[0][0], 8),),
                                   dtype=dtype)
    return dataclasses.replace(base, d_model=1024, n_heads=4, head_dim=256,
                               d_ff=3072, lru_width=1024, vocab_size=4096,
                               groups=((base.groups[0][0], 3),), dtype=dtype)


def decode_drift(prompt: int = 24, steps: int = 15):
    """rwkv6 (d = 1,024, 8 layers) and recurrentgemma (d = 1,024, 3
    repeats of its triple) with the zero-init leaves drawn: a prefill and
    ``steps`` decode steps against one forward over the same tokens, in
    each package, bf16 and f32.  One JSON line each: the largest relative
    error in norm of the logits at each decoded position (batch 4)."""
    from test_torch_models import perturb_zero_leaves
    for arch in KINDS.values():
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                         (jnp.float32, torch.float32)):
            jcfg = _drift_cfg(jax_configs, arch, jdt)
            jm = jax_build(jcfg)
            jp = perturb_zero_leaves(jm.param_specs, jax.tree.map(
                np.asarray, jm.init(jax.random.PRNGKey(0), jnp.float32)),
                np.random.default_rng(5))
            tm = build_model(_drift_cfg(configs, arch, tdt))
            tp = convert.params_from_numpy(tm.cfg, jp)
            toks = np.random.default_rng(6).integers(
                0, 4096, (4, prompt + steps)).astype(np.int32)
            out = {}
            for pkg in ("jax", "port"):
                if pkg == "jax":
                    p, m = jax.tree.map(jnp.asarray, jp), jm
                    tk, pos = jnp.asarray(toks), jnp.int32
                    cache = m.init_cache(4, prompt + steps)
                else:
                    p, m, tk, pos = tp, tm, torch.from_numpy(toks), int
                    cache = m.init_cache(4, prompt + steps, device="cpu")
                got, cache = m.prefill(p, {"tokens": tk[:, :prompt]},
                                       cache)[:2]
                got = [got]
                for i in range(steps):
                    o, cache = m.decode_step(
                        p, tk[:, prompt + i:prompt + i + 1], cache,
                        pos(prompt + i))
                    got.append(o)
                h, _ = m.forward(p, {"tokens": tk[:, :prompt + steps]})
                want = _np(m.logits(p, h[:, prompt - 1:]))
                got = np.concatenate([_np(g) for g in got], 1)
                out[pkg] = [round(float(x), 6) for x in (
                    np.linalg.norm(got - want, axis=-1)
                    / np.linalg.norm(want, axis=-1)).max(0)]
            print(json.dumps(dict(arch=arch, dtype=jnp.dtype(jdt).name,
                                  **out)), flush=True)


if __name__ == "__main__":
    decode_drift()
