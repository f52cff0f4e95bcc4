"""The whisper encoder and cross-attention (``repro_torch.models``
``transformer.encode``, ``attention.gqa_apply(cross_kv=)``) and reduced
``whisper_medium`` against the JAX package on the CPU.

Cross-attention (no rope on the query, no mask) and the non-causal
encoder stack within 1e-5 in float32 on seeded numpy inputs; the
encoder really is non-causal (a late frame moves the first position's
output); a prefill stores the decoder's cross keys and values in the
cache as the reference does, and decode steps read them from there;
the decoder refuses to run without the encoder's output; the encoder in
bfloat16 within 3e-2 of the JAX package's bf16 run, relative in norm,
and nearer it than its f32 run.  The model through
``tests/_torch_families.py``: prefill + decode == forward (3e-2),
``lm_loss`` and every gradient leaf, greedy generation; and the serving
entry point runs a ``features`` batch on the CPU.  The model-level
forward / prefill / decode in f32 and bf16 are in
``test_torch_models.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from test_torch_models import _pair

torch.set_num_threads(1)

ARCH = "whisper_medium"
TOL = 1e-5
BF16_TOL = 3e-2
B = 2


def _np(t):
    if torch.is_tensor(t):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _features(cfg, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)


def test_cross_attention_matches_jax():
    jcfg, _, jp, tm, tp = _pair(ARCH, "f32")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, 5, jcfg.d_model)).astype(np.float32)
    k = rng.normal(size=(B, jcfg.enc_len, jcfg.n_kv_heads, jcfg.head_dim)
                   ).astype(np.float32)
    v = rng.normal(size=k.shape).astype(np.float32)
    blk = jcfg.groups[0][0][0]
    jcross = jax.tree.map(lambda a: a[0], jp["groups"][0]["b0"]["cross"])
    tcross = tp.groups[0][0]["b0"]["cross"]
    want, _ = jattn.gqa_apply(jcross, jcfg, blk, jnp.asarray(x),
                              jnp.arange(7, 12),
                              cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    got, cache = tattn.gqa_apply(tcross, tm.cfg, blk, torch.from_numpy(x),
                                 torch.arange(7, 12), cross_kv=(
                                     torch.from_numpy(k),
                                     torch.from_numpy(v)))
    assert cache is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL)


def test_encoder_matches_jax_and_is_not_causal():
    jcfg, _, jp, tm, tp = _pair(ARCH, "f32")
    feats = _features(jcfg, 2)
    want = jtfm.encode(jp, jcfg, {"features": jnp.asarray(feats)},
                       jtfm._ident, False)
    tparams = ttfm._cast_params(tp, tm.cfg.dtype)
    got = ttfm.encode(tparams, tm.cfg, {"features": torch.from_numpy(feats)})
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL)
    late = feats.copy()          # (not a constant shift: the norms drop it)
    late[:, -1] = _features(jcfg, 3)[:, -1]
    moved = ttfm.encode(tparams, tm.cfg, {"features": torch.from_numpy(late)})
    assert np.abs(_np(moved)[:, 0] - _np(got)[:, 0]).max() > 1e-3


def test_prefill_fills_the_cross_cache():
    jcfg, jm, jp, tm, tp = _pair(ARCH, "f32")
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (B, 6)).astype(np.int32)
    feats = _features(jcfg, 4)
    jc = jm.init_cache(B, 10)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens),
                            "features": jnp.asarray(feats)}, jc)
    tc = tm.init_cache(B, 10, device="cpu")
    _, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens),
                               "features": torch.from_numpy(feats)}, tc)
    for li in range(len(tc[0])):
        for name in ("cross_k", "cross_v"):
            got = tc[0][li]["b0"][name]
            assert got.shape == (B, jcfg.enc_len, jcfg.n_kv_heads,
                                 jcfg.head_dim)
            np.testing.assert_allclose(_np(got),
                                       _np(jc[0]["b0"][name][li]), rtol=0,
                                       atol=TOL, err_msg=f"{li} {name}")
    # a decode step reads them: zeroed ones change its logits (the
    # step returns new caches, so ``tc`` still stands at position 6)
    nxt = torch.from_numpy(tokens[:, :1])
    kept, _ = tm.decode_step(tp, nxt, tc, 6)
    for layer in tc[0]:
        for name in ("cross_k", "cross_v"):
            layer["b0"][name] = torch.zeros_like(layer["b0"][name])
    blind, _ = tm.decode_step(tp, nxt, tc, 6)
    assert np.abs(_np(kept) - _np(blind)).max() > 1e-3


def test_decoder_needs_the_encoder_output():
    _, _, _, tm, tp = _pair(ARCH, "f32")
    with pytest.raises(ValueError, match="features"):
        tm.forward(tp, {"tokens": torch.zeros((1, 3), dtype=torch.int32)})


def test_encoder_bf16_nearer_jax_bf16():
    jcfg, _, jp, tm, tp = _pair(ARCH, "bf16", seed=5)
    feats = {"features": _features(jcfg, 6)}
    j16 = jtfm.encode(jtfm._cast_params(jp, jnp.bfloat16), jcfg,
                      jax.tree.map(jnp.asarray, feats), jtfm._ident, False)
    j32cfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    j32 = jtfm.encode(jp, j32cfg, jax.tree.map(jnp.asarray, feats),
                      jtfm._ident, False)
    got = ttfm.encode(ttfm._cast_params(tp, torch.bfloat16), tm.cfg,
                      {"features": torch.from_numpy(feats["features"])})
    assert got.dtype == torch.bfloat16
    g, w16, w32 = _np(got), _np(j16), _np(j32)
    near = np.linalg.norm(g - w16) / np.linalg.norm(w16)
    far = np.linalg.norm(g - w32) / np.linalg.norm(w32)
    assert near <= BF16_TOL and near < far, (near, far)


def test_prefill_decode_matches_forward():
    fam.prefill_decode_matches_forward(ARCH)


def test_loss_and_grads_match_jax():
    fam.loss_and_grads_match_jax(ARCH)


def test_generate_matches_jax():
    fam.generate_matches_jax(ARCH)


def test_serve_entry_point_with_features(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--max-new", "3", "--prompt-len", "4"])
    out = capsys.readouterr().out
    assert out.count("generated (4, 3)") == 2, out
