"""MLA (deepseek-v2's latent attention, ``repro_torch.models.attention``
``mla_apply``) and reduced ``deepseek_v2_236b`` against the JAX package on
the CPU.

The block, on seeded numpy weights and inputs (the ``q_lora`` path and
the direct ``wq`` one): without a cache, a prefill into an
``MLACache`` and decode steps through it, within 1e-5 in float32; a
sequence prefilled in two parts through the cache equals one pass
(1e-5); in bfloat16 within 3e-2 of the JAX package's bf16 run, relative
in norm, and nearer it than its f32 run.  The model (MLA with
the routed-expert block, 2 shared experts, top-2 of 8) through
``tests/_torch_families.py``: prefill + decode == forward (3e-2),
``lm_loss`` and every gradient leaf, greedy generation.  deepseek_v2 is
an MoE model, held in f32 at model level (router ties,
``test_torch_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro import configs as jax_configs
from repro.models import attention as jattn
from repro_torch import configs
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

ARCH = "deepseek_v2_236b"
TOL = 1e-5
BF16_TOL = 3e-2
B, T = 2, 12


def _cfgs(q_lora: bool, dtype="f32"):
    jc = jax_configs.get_config(ARCH, reduced=True)
    tc = configs.get_config(ARCH, reduced=True)
    if not q_lora:
        jc = dataclasses.replace(jc, q_lora_rank=0)
        tc = dataclasses.replace(tc, q_lora_rank=0)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return (dataclasses.replace(jc, dtype=jdt),
            dataclasses.replace(tc, dtype=tdt))


def _weights(tc, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in tattn.mla_param_specs(tc).items():
        if s.init == "ones":
            out[k] = 1 + rng.normal(size=s.shape) * 0.1
        else:
            out[k] = rng.normal(size=s.shape) / np.sqrt(s.shape[0])
    return {k: v.astype(np.float32) for k, v in out.items()}


def _run(pkg, w, cfg, x, dtype, splits):
    """No cache, then through a cache: a prefill of each part of
    ``splits`` in turn, then a decode step of each remaining position."""
    blk = cfg.groups[0][0][0]
    if pkg == "jax":
        p = {k: jnp.asarray(v, dtype) for k, v in w.items()}
        xs = jnp.asarray(x, dtype)
        full, _ = jattn.mla_apply(p, cfg, blk, xs, jnp.arange(x.shape[1]))
        cache = jattn.mla_init_cache(cfg, B, x.shape[1], dtype)
    else:
        p = {k: torch.from_numpy(v).to(dtype) for k, v in w.items()}
        xs = torch.from_numpy(x).to(dtype)
        full, _ = tattn.mla_apply(p, cfg, blk, xs,
                                  torch.arange(x.shape[1]))
        cache = tattn.mla_init_cache(cfg, B, x.shape[1], dtype, "cpu")
    outs, at = [full], 0
    for n in splits + [1] * (x.shape[1] - sum(splits)):
        if pkg == "jax":
            o, cache = jattn.mla_apply(p, cfg, blk, xs[:, at:at + n],
                                       jnp.arange(at, at + n), cache)
        else:
            o, cache = tattn.mla_apply(p, cfg, blk, xs[:, at:at + n],
                                       torch.arange(at, at + n), cache)
        outs.append(o)
        at += n
    return outs, cache


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("q_lora", [True, False], ids=["q_lora", "wq"])
def test_mla_apply_matches_jax(q_lora):
    jc, tc = _cfgs(q_lora)
    w = _weights(tc)
    x = np.random.default_rng(1).normal(size=(B, T, tc.d_model)).astype(
        np.float32)
    want, jcache = _run("jax", w, jc, x, jnp.float32, [8])
    got, tcache = _run("port", w, tc, x, torch.float32, [8])
    assert len(got) == len(want) == 1 + 1 + (T - 8)
    for i, (g, wv) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), _np(wv), rtol=0, atol=TOL,
                                   err_msg=f"call {i}")
    assert tcache.length == T == int(jcache.length)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(getattr(tcache, name)),
                                   _np(getattr(jcache, name)), rtol=0,
                                   atol=TOL, err_msg=name)


def test_split_prefill_equals_one_pass():
    """Two prefills through the cache (7 then 5 positions) give the one
    pass's outputs and cache."""
    _, tc = _cfgs(True)
    w = _weights(tc, seed=2)
    x = np.random.default_rng(3).normal(size=(B, T, tc.d_model)).astype(
        np.float32)
    (one, _), one_cache = _run("port", w, tc, x, torch.float32, [T])
    (_, a, b), two_cache = _run("port", w, tc, x, torch.float32, [7, 5])
    np.testing.assert_allclose(_np(torch.cat([a, b], 1)), _np(one), rtol=0,
                               atol=TOL)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(getattr(two_cache, name)),
                                   _np(getattr(one_cache, name)), rtol=0,
                                   atol=TOL)


def test_mla_cache_past_max_len_raises():
    _, tc = _cfgs(True)
    w = {k: torch.from_numpy(v) for k, v in _weights(tc).items()}
    cache = tattn.mla_init_cache(tc, 1, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="KV cache full"):
        tattn.mla_apply(w, tc, tc.groups[0][0][0],
                        torch.zeros((1, 5, tc.d_model)), torch.arange(5),
                        cache)


def test_mla_bf16_nearer_jax_bf16():
    """The block in bfloat16 (the no-cache pass, the prefill and the
    decode steps): within 3e-2 of the JAX package's bf16 run, relative
    in norm, and, summed, nearer it than its f32 run."""
    jc16, tc16 = _cfgs(True, "bf16")
    jc32, _ = _cfgs(True)
    w = _weights(tc16, seed=4)
    x = np.random.default_rng(5).normal(size=(B, T, tc16.d_model)).astype(
        np.float32)
    want16, _ = _run("jax", w, jc16, x, jnp.bfloat16, [8])
    want32, _ = _run("jax", w, jc32, x, jnp.float32, [8])
    got, _ = _run("port", w, tc16, x, torch.bfloat16, [8])
    near = far = 0.0
    for g, w16, w32 in zip(got, want16, want32):
        assert g.dtype == torch.bfloat16
        g, w16, w32 = _np(g), _np(w16), _np(w32)
        err = np.linalg.norm(g - w16) / np.linalg.norm(w16)
        assert err <= BF16_TOL, err
        near += err
        far += np.linalg.norm(g - w32) / np.linalg.norm(w32)
    assert near < far, (near, far)


def test_prefill_decode_matches_forward():
    fam.prefill_decode_matches_forward(ARCH)


def test_loss_and_grads_match_jax():
    fam.loss_and_grads_match_jax(ARCH)


def test_generate_matches_jax():
    fam.generate_matches_jax(ARCH)
