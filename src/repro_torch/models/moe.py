"""Mixture-of-Experts layer with capacity-bounded scatter dispatch.

The port's copy of the JAX package's ``models/moe.py``.  Every (token,
expert) pair computes its rank within its expert (an exclusive cumsum
over a one-hot, integer-exact) and is copied into a dense (E, C, D)
buffer; pairs past capacity C drop (their combine weight is zeroed),
the GShard/Switch overflow policy.  Capacity is exact (``n_tok * k``,
nothing drops) while ``n_tok * k <= 512`` (decode), else
``round(n_tok * k / E * capacity_factor)`` with Python's ``round``.

A dropped pair is sent to one spare row past the buffer's ``E * C``
rows and that row is cut off before the experts run: no write lands out
of bounds (XLA's ``mode="drop"`` has no PyTorch counterpart).  The
combine is an out-of-place ``index_add``, so autograd differentiates
the whole layer.  Inside the experts ``geglu`` uses ``silu``, as the
reference does.

``moe_apply_shardmap`` (the reference's all_to_all dispatch under
``shard_map``) needs a device mesh and is not ported
(``ROADMAP.md`` Queue 1 item 7).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import ModelConfig, ParamSpec, activation, dense

#: n_tok * k at or below which capacity is exact (no pair drops)
EXACT_PAIRS = 512


def moe_param_specs(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    sp = {
        "router": ParamSpec((d, e), ("embed", "experts")),
        "wi": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wg": ParamSpec((e, d, f), ("experts", "embed", "ffn")),
        "wo": ParamSpec((e, f, d), ("experts", "ffn", "embed")),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        sp["shared_wi"] = ParamSpec((d, fs), ("embed", "ffn"))
        sp["shared_wg"] = ParamSpec((d, fs), ("embed", "ffn"))
        sp["shared_wo"] = ParamSpec((fs, d), ("ffn", "embed"))
    return sp


def _position_in_expert(expert_ids: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """(P,) expert id per pair -> (P,) rank of the pair within its
    expert (exclusive cumsum over the one-hot)."""
    oh = F.one_hot(expert_ids.long(), n_experts)                 # (P, E)
    pos = torch.cumsum(oh, dim=0) - oh
    return torch.sum(pos * oh, dim=-1)


def capacity(cfg: ModelConfig, n_tok: int) -> int:
    """Rows an expert takes for ``n_tok`` tokens."""
    pairs = n_tok * cfg.top_k
    if pairs <= EXACT_PAIRS:
        return pairs
    return int(max(1, round(pairs / cfg.n_experts * cfg.capacity_factor)))


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest of the last axis, largest first,
    a tie to the lower index (a stable sort; ``torch.topk`` leaves ties
    unordered, and bf16 router outputs tie often)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(p, cfg: ModelConfig, xf: torch.Tensor):
    """Router of tokens xf (N, D): (weights (N, K) f32, experts (N, K)).
    Top-1 takes the sigmoid gate of the argmax expert (llama4); top-k
    takes softmax probabilities renormalised over the chosen k."""
    logits = dense(xf, p["router"]).float()                      # (N, E)
    if cfg.top_k == 1:
        return top_k(torch.sigmoid(logits), 1)
    w, idx = top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9), idx


def routing(p, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """The dispatch of x (B, T, D): each pair's expert, gate weight,
    token, rank within its expert and whether it fits (``keep``), with
    the capacity ``cap``.  Pairs are token-major: token i's k pairs are
    i*k .. i*k + k - 1."""
    n_tok = x.shape[0] * x.shape[1]
    w, idx = route(p, cfg, x.reshape(n_tok, x.shape[-1]))
    cap = capacity(cfg, n_tok)
    expert = idx.reshape(-1)
    pos = _position_in_expert(expert, cfg.n_experts)
    return dict(expert=expert, weight=w.reshape(-1), pos=pos,
                keep=pos < cap, cap=cap,
                token=torch.arange(n_tok, device=x.device).repeat_interleave(
                    cfg.top_k))


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D)."""
    b, t, d = x.shape
    n_tok = b * t
    e = cfg.n_experts
    act = activation("silu" if cfg.act == "geglu" else cfg.act)
    xf = x.reshape(n_tok, d)
    r = routing(p, cfg, x)
    cap, keep = r["cap"], r["keep"]
    pair_w = r["weight"].to(x.dtype)
    # the spare row e * cap takes every dropped pair and is cut off
    slot = torch.where(keep, r["expert"] * cap + r["pos"], e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, slot, xf[r["token"]])[:e * cap].reshape(e, cap,
                                                                    d)

    h = torch.einsum("ecd,edf->ecf", buf, p["wi"])
    if cfg.act in ("silu", "geglu", "gelu"):
        h = act(torch.einsum("ecd,edf->ecf", buf, p["wg"])) * h
    else:
        h = act(h)
    flat = torch.einsum("ecf,efd->ecd", h, p["wo"]).reshape(e * cap, d)

    safe = torch.where(keep, slot, 0)
    pair_out = flat[safe] * torch.where(keep, pair_w, 0)[:, None]
    y = torch.zeros((n_tok, d), dtype=x.dtype, device=x.device).index_add(
        0, r["token"], pair_out)
    if cfg.n_shared_experts:
        g = act(dense(xf, p["shared_wg"]))
        y = y + dense(g * dense(xf, p["shared_wi"]), p["shared_wo"])
    return y.reshape(b, t, d)


def moe_apply_shardmap(p, cfg: ModelConfig, x: torch.Tensor):
    raise NotImplementedError(
        "moe_impl='shardmap' (all_to_all expert dispatch over a device "
        "mesh) is not ported yet (ROADMAP.md Queue 1 item 7)")


def aux_load_balance_loss(p, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary (mean fraction * mean prob)."""
    logits = dense(x.reshape(-1, x.shape[-1]), p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(0)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))
