"""RWKV-6 "Finch" blocks (arXiv:2404.05892): attention-free time mix
with data-dependent decay, plus channel mix.

The port's copy of the JAX package's ``models/rwkv6.py``.  Time mix per
head (size n = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (state (n, n))
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(w_base + lora(x~_t))) per channel, and token-shift
interpolation x~ = lerp(x_{t-1}, x_t, mu_*) with data-dependent mu (the
Finch ddlerp, one shared lora).

The reference's ``lax.scan`` over time is a Python loop over T here,
carrying the float32 state S (B, H, N, N): a prefill of T tokens runs T
steps of a few small ops each a layer, and a decode step one.  The
float32 casts sit where the reference has them (the decay, ``u``, the
outer product ``kv`` and the ``out`` einsum).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamSpec, dense, reshape, rmsnorm, \
    sigmoid, silu

LORA_R = 32


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head size): ``n_heads`` or one head a 64 channels."""
    h = cfg.n_heads if cfg.n_heads else cfg.d_model // 64
    return h, cfg.d_model // h


def rwkv_param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, n = _heads(cfg)
    return {
        # time mix
        "mu_x": ParamSpec((5, d), ("five", "embed"), "zeros"),
        "ddlerp_a": ParamSpec((d, LORA_R * 5), ("embed", "lora"), "zeros"),
        "ddlerp_b": ParamSpec((LORA_R * 5, 5 * d), ("lora", "embed"),
                              "zeros"),
        "w_base": ParamSpec((d,), ("embed",), "zeros"),
        "w_lora_a": ParamSpec((d, LORA_R), ("embed", "lora"), "zeros"),
        "w_lora_b": ParamSpec((LORA_R, d), ("lora", "embed"), "zeros"),
        "u": ParamSpec((h, n), ("heads", "head_dim"), "zeros"),
        "wr": ParamSpec((d, d), ("embed", "q_features")),
        "wk": ParamSpec((d, d), ("embed", "q_features")),
        "wv": ParamSpec((d, d), ("embed", "q_features")),
        "wg": ParamSpec((d, d), ("embed", "q_features")),
        "wo": ParamSpec((d, d), ("q_features", "embed")),
        "ln_x": ParamSpec((d,), ("embed",), "ones"),
        # channel mix
        "cm_mu_k": ParamSpec((d,), ("embed",), "zeros"),
        "cm_mu_r": ParamSpec((d,), ("embed",), "zeros"),
        "cm_wk": ParamSpec((d, cfg.d_ff), ("embed", "ffn")),
        "cm_wv": ParamSpec((cfg.d_ff, d), ("ffn", "embed")),
        "cm_wr": ParamSpec((d, d), ("embed", "q_features")),
    }


class RWKVState(NamedTuple):
    tm_last: torch.Tensor   # (B, D)    last token (time-mix shift)
    cm_last: torch.Tensor   # (B, D)    last token (channel-mix shift)
    S: torch.Tensor         # (B, H, N, N) wkv state, float32


def rwkv_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device) -> RWKVState:
    d = cfg.d_model
    h, n = _heads(cfg)
    return RWKVState(
        tm_last=torch.zeros((batch, d), dtype=dtype, device=device),
        cm_last=torch.zeros((batch, d), dtype=dtype, device=device),
        S=torch.zeros((batch, h, n, n), dtype=torch.float32, device=device))


def _shift(last: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for every t of x (B, T, D), ``last`` before the first."""
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token-shift: five mixed variants (r,k,v,w,g),
    (..., 5, D)."""
    d = x.shape[-1]
    base = x_prev + (x - x_prev) * 0.5
    lo = torch.tanh(dense(base, p["ddlerp_a"]))             # (..., 5R)
    mu_dd = reshape(dense(lo, p["ddlerp_b"]), *x.shape[:-1], 5, d)
    mix = p["mu_x"] + mu_dd                                 # (..., 5, D)
    return x_prev[..., None, :] + (x - x_prev)[..., None, :] * \
        sigmoid(mix)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    w = p["w_base"] + dense(torch.tanh(dense(xw, p["w_lora_a"])),
                            p["w_lora_b"])
    return torch.exp(-torch.exp(w.float()))                 # (…, D) in (0,1)


def time_mix(p, cfg: ModelConfig, x: torch.Tensor, state: RWKVState):
    """x (B, T, D) -> (out, state'); a loop over T."""
    b, t, d = x.shape
    h, n = _heads(cfg)
    mixed = _ddlerp(p, x, _shift(state.tm_last, x))         # (B,T,5,D)
    xr, xk, xv, xw, xg = mixed.unbind(2)
    r = reshape(dense(xr, p["wr"]), b, t, h, n).float()
    k = reshape(dense(xk, p["wk"]), b, t, h, n).float()
    v = reshape(dense(xv, p["wv"]), b, t, h, n).float()
    g = silu(dense(xg, p["wg"]))
    w = _decay(p, xw).reshape(b, t, h, n)                   # (B,T,H,N)
    u = p["u"].float()[None, :, :, None]

    S = state.S
    outs = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]       # (B,H,N,N)
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, i], S + u * kv))
        S = w[:, i, :, :, None] * S + kv
    o = reshape(torch.stack(outs, 1), b, t, d).to(x.dtype)
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps) * g
    out = dense(o, p["wo"])
    return out, state._replace(tm_last=x[:, -1], S=S)


def channel_mix(p, cfg: ModelConfig, x: torch.Tensor, state: RWKVState):
    x_prev = _shift(state.cm_last, x)
    xk = x_prev + (x - x_prev) * sigmoid(p["cm_mu_k"])
    xr = x_prev + (x - x_prev) * sigmoid(p["cm_mu_r"])
    kk = torch.square(F.relu(dense(xk, p["cm_wk"])))
    out = sigmoid(dense(xr, p["cm_wr"])) * dense(kk, p["cm_wv"])
    return out, state._replace(cm_last=x[:, -1])
