"""RecurrentGemma blocks (arXiv:2402.19427): the RG-LRU recurrence with a
width-4 temporal conv, alternating with local (windowed) attention in a
(rec, rec, attn) pattern — the Griffin hybrid.

The port's copy of the JAX package's ``models/rglru.py``.  RG-LRU, per
channel:
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = a^(c * r_t)    with a = sigmoid(Lambda),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrent block: x -> [W1 -> conv1d(4) -> RG-LRU] * gelu(W2 gate)
-> Wo, the gelu in its tanh form (``jax.nn.gelu``'s default).  The
reference's ``lax.scan`` over time is a Python loop over T here,
carrying h (B, W) in float32 and the conv window (B, conv_width-1, W).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .common import ModelConfig, ParamSpec, _gelu_tanh, dense, sigmoid

C_CONST = 8.0


def rglru_param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    return {
        "w_in": ParamSpec((d, w), ("embed", "ffn")),
        "w_gate": ParamSpec((d, w), ("embed", "ffn")),
        "conv_w": ParamSpec((cfg.conv_width, w), ("conv", "ffn"), "zeros",
                            0.1),
        "conv_b": ParamSpec((w,), ("ffn",), "zeros"),
        "lam": ParamSpec((w,), ("ffn",), "zeros"),       # Lambda
        "wa": ParamSpec((w, w), ("ffn", "ffn2")),
        "ba": ParamSpec((w,), ("ffn",), "zeros"),
        "wx": ParamSpec((w, w), ("ffn", "ffn2")),
        "bx": ParamSpec((w,), ("ffn",), "zeros"),
        "w_out": ParamSpec((w, d), ("ffn", "embed")),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, W) recurrent state, float32
    conv: torch.Tensor    # (B, conv_width-1, W) trailing inputs


def rglru_init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> RGLRUState:
    w = cfg.lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                         device=device))


def _conv1d(p, cfg: ModelConfig, u: torch.Tensor, state: RGLRUState):
    """Causal temporal conv of width ``conv_width`` over (B, T, W)."""
    hist = torch.cat([state.conv.to(u.dtype), u], dim=1)
    cw, t = cfg.conv_width, u.shape[1]
    out = hist[:, 0:t] * p["conv_w"][cw - 1]
    for i in range(1, cw):
        out = out + hist[:, i:i + t] * p["conv_w"][cw - 1 - i]
    out = out + p["conv_b"]
    new_conv = hist[:, -(cw - 1):] if cw > 1 else state.conv
    return out, new_conv


def rglru_apply(p, cfg: ModelConfig, x: torch.Tensor, state: RGLRUState):
    """x (B, T, D) -> (out, state'); a loop over T."""
    u = dense(x, p["w_in"])                                 # (B,T,W)
    gate = _gelu_tanh(dense(x, p["w_gate"]))
    u, new_conv = _conv1d(p, cfg, u, state)

    r = sigmoid(dense(u, p["wa"]) + p["ba"]).float()
    i = sigmoid(dense(u, p["wx"]) + p["bx"]).float()
    lam = p["lam"].float()
    log_a = -C_CONST * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)                                    # (B,T,W)
    gated = i * u.float()
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.square(a), 1e-12))

    h = state.h
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + mult[:, t] * gated[:, t]
        hs.append(h)
    y = torch.stack(hs, 1).to(x.dtype) * gate
    out = dense(y, p["w_out"])
    return out, RGLRUState(h=h, conv=new_conv)
