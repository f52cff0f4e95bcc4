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

``moe_apply_shardmap`` is the reference's all_to_all dispatch under
``shard_map``, on the local blocks of DTensors: each (batch, model) rank
routes its own token slice through per-destination mailboxes
(``core.dispatch``, the paper's actor dispatch), one all_to_all over its
``model`` group moves the routed rows to the ranks that hold their
experts, the local per-expert mailboxes feed the expert products, and
the inverse all_to_all brings the outputs back for the weighted combine.
The collectives carry gradients (``torch.distributed.nn.functional``),
as the reference trains through ``shard_map``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dispatch import dispatch_to_trees, gather_mailbox, mailbox_ids
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


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor,
              constrain=lambda t, axes: t) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D).  ``constrain(tensor, logical_axes)``
    lays out the (E, C, D) dispatch buffer and the expert activations
    (experts over ``model``: the reference's EP annotations)."""
    if hasattr(x, "device_mesh"):
        return _moe_apply_placed(p, cfg, x, constrain)
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
    buf = constrain(buf, ("experts", "exp_capacity", "embed"))

    h = torch.einsum("ecd,edf->ecf", buf, p["wi"])
    if cfg.act in ("silu", "geglu", "gelu"):
        h = act(torch.einsum("ecd,edf->ecf", buf, p["wg"])) * h
    else:
        h = act(h)
    h = constrain(h, ("experts", "exp_capacity", "ffn"))
    out_buf = constrain(torch.einsum("ecf,efd->ecd", h, p["wo"]),
                        ("experts", "exp_capacity", "embed"))
    flat = out_buf.reshape(e * cap, d)

    safe = torch.where(keep, slot, 0)
    pair_out = flat[safe] * torch.where(keep, pair_w, 0)[:, None]
    y = torch.zeros((n_tok, d), dtype=x.dtype, device=x.device).index_add(
        0, r["token"], pair_out)
    if cfg.n_shared_experts:
        g = act(dense(xf, p["shared_wg"]))
        y = y + dense(g * dense(xf, p["shared_wi"]), p["shared_wo"])
    return y.reshape(b, t, d)


def _moe_apply_placed(p, cfg: ModelConfig, x, constrain):
    """:func:`moe_apply` on DTensors.  DTensor has no sharding rule for
    the data-dependent dispatch and combine (``index_copy`` /
    ``index_add`` with plain index tensors), so they run on full local
    tensors: the tokens and the router are gathered to every rank, each
    rank routes all of them into the same (E, C, D) buffer (the
    reference's GSPMD lowering, a replicated buffer), the buffer is laid
    out by ``constrain`` (experts over ``model``, capacity over the batch
    axes) for the expert products, and their output is gathered back for
    the combine.  Every rank computes the same routing, so the gathered
    tensors' gradients are replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    b, t, d = x.shape
    n_tok = b * t
    e = cfg.n_experts
    act = activation("silu" if cfg.act == "geglu" else cfg.act)
    xl = x.redistribute(mesh, rep).to_local()
    xf = xl.reshape(n_tok, d)
    r = routing({"router": p["router"].redistribute(mesh, rep).to_local()},
                cfg, xl)
    cap, keep = r["cap"], r["keep"]
    slot = torch.where(keep, r["expert"] * cap + r["pos"], e * cap)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=xl.device)
    buf = buf.index_copy(0, slot, xf[r["token"]])[:e * cap].reshape(e, cap,
                                                                    d)
    buf = DTensor.from_local(buf, mesh, rep, run_check=False)
    buf = constrain(buf, ("experts", "exp_capacity", "embed"))
    h = torch.einsum("ecd,edf->ecf", buf, p["wi"])
    if cfg.act in ("silu", "geglu", "gelu"):
        h = act(torch.einsum("ecd,edf->ecf", buf, p["wg"])) * h
    else:
        h = act(h)
    h = constrain(h, ("experts", "exp_capacity", "ffn"))
    out_buf = constrain(torch.einsum("ecf,efd->ecd", h, p["wo"]),
                        ("experts", "exp_capacity", "embed"))
    flat = out_buf.redistribute(mesh, rep).to_local().reshape(e * cap, d)
    safe = torch.where(keep, slot, 0)
    pair_out = flat[safe] * torch.where(keep, r["weight"].to(x.dtype),
                                        0)[:, None]
    y = torch.zeros((n_tok, d), dtype=x.dtype, device=xl.device).index_add(
        0, r["token"], pair_out)
    y = DTensor.from_local(y.reshape(b, t, d), mesh, rep, run_check=False)
    if cfg.n_shared_experts:
        # on (B, T, D): DTensor's view rule mis-splits a (B*T, D) whose
        # rows are sharded over two mesh dims
        g = act(dense(x, p["shared_wg"]))
        y = y + dense(g * dense(x, p["shared_wi"]), p["shared_wo"])
    return y


def _local(t, mesh, spec, reduce_grads: bool):
    """``t``'s block under ``spec`` (the reference's ``in_specs``), as a
    local tensor.  ``reduce_grads``: every rank uses its block for its own
    tokens, so the gradients of the mesh dims it is replicated over are
    partial sums."""
    from torch.distributed.tensor import Partial
    from ..sharding.policy import placements
    pl = placements(mesh, spec)
    t = t.redistribute(mesh, pl)
    if not reduce_grads:
        return t.to_local()
    return t.to_local(grad_placements=[p if p.is_shard() else Partial()
                                       for p in pl])


def moe_apply_shardmap(p, cfg: ModelConfig, x: torch.Tensor,
                       constrain=lambda t, axes: t,
                       return_drops: bool = False):
    """PFO-mailbox MoE: explicit all_to_all dispatch over the ``model``
    axis of the mesh ``x`` (a DTensor) lives on.

    GSPMD's counterpart (:func:`moe_apply` under a policy) computes the
    data-dependent dispatch into a replicated buffer; here each (batch,
    model) rank routes its own token slice (sequence split over
    ``model`` inside the layer) and one all_to_all pair over ``model``
    moves only the routed rows.  Capacities are the reference's:
    ``cap = max(round(n_loc * k / S * 2), 8)`` rows a destination rank
    and ``cap2 = max(8, round(n_loc * k * S / E * 2))`` rows a local
    expert; pairs past them drop, as the reference's do.

    Falls back to :func:`moe_apply` when no ``model`` axis is ambient
    (``x`` a plain tensor, or a mesh without one) or the shapes do not
    divide.  ``return_drops`` (the all_to_all path only) also returns
    ``{"dropped": (B, T) bool}``, the tokens that lost a pair to either
    capacity (one more all_to_all of flags)."""
    mesh = getattr(x, "device_mesh", None)
    names = getattr(mesh, "mesh_dim_names", None) or ()
    b, t, d = x.shape
    S = mesh.size(names.index("model")) if "model" in names else 0
    if not S or t % S or cfg.n_experts % S:
        if return_drops:
            raise ValueError("return_drops needs the all_to_all path: a "
                             "model axis that divides T and the experts")
        return moe_apply(p, cfg, x, constrain)
    from torch.distributed.tensor import DTensor

    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    bspec = batch_axes or None
    group = mesh.get_group("model")
    xl = _local(x, mesh, (bspec, "model", None), reduce_grads=False)
    r_full = _local(p["router"], mesh, (None, None), reduce_grads=True)
    w = {k: _local(p[k], mesh, ("model", None, None), reduce_grads=True)
         for k in ("wi", "wg", "wo")}
    yl, drop = _shardmap_local(cfg, xl, r_full, w, S, group, return_drops)
    from ..sharding.policy import placements
    out_pl = placements(mesh, (bspec, "model", None))
    y = DTensor.from_local(yl, mesh, out_pl, run_check=False,
                           shape=x.shape, stride=(t * d, d, 1))
    y = constrain(y, ("batch", "seq", "embed"))

    if cfg.n_shared_experts:
        act = activation("silu" if cfg.act == "geglu" else cfg.act)
        g = act(dense(x, p["shared_wg"]))
        y = y + dense(g * dense(x, p["shared_wi"]), p["shared_wo"])
    if return_drops:
        drop = DTensor.from_local(drop, mesh,
                                  placements(mesh, (bspec, "model")),
                                  run_check=False, shape=(b, t),
                                  stride=(t, 1))
        return y, {"dropped": drop.full_tensor()}
    return y


def _a2a(t: torch.Tensor, group, grad: bool) -> torch.Tensor:
    """``jax.lax.all_to_all(t, "model", 0, 0, tiled=True)``: block j of
    dim 0 goes to rank j of ``group``, the blocks received stacked in
    rank order."""
    import torch.distributed._functional_collectives as funcol
    t = t.contiguous()
    if grad:
        return funcol.all_to_all_single_autograd(t, None, None, group)
    return funcol.all_to_all_single(t, None, None, group)


def _shardmap_local(cfg: ModelConfig, xl, r_full, w, S: int, group,
                    return_drops: bool):
    """The reference's ``local_fn`` on this rank's blocks: xl (B_loc,
    T_loc, D), the full router, the local experts' ``wi`` / ``wg`` /
    ``wo``.  Returns (y (B_loc, T_loc, D), dropped (B_loc, T_loc) bool or
    None)."""
    bl, tl, d = xl.shape
    n_loc = bl * tl
    k = cfg.top_k
    e_loc = cfg.n_experts // S
    act = activation("silu" if cfg.act == "geglu" else cfg.act)
    dev = xl.device
    xf = xl.reshape(n_loc, d)
    wts, idx = route({"router": r_full}, cfg, xf)
    pair_e = idx.reshape(-1)
    pair_w = wts.reshape(-1).to(xl.dtype)
    n_pairs = pair_e.shape[0]
    pair_tok = torch.arange(n_loc, device=dev).repeat_interleave(k)
    dest = torch.div(pair_e, e_loc, rounding_mode="floor")
    cap = max(int(round(n_loc * k / S * 2.0)), 8)        # skew headroom
    mbox, over1 = dispatch_to_trees(dest, S, cap)        # (S, cap)
    (sx,) = gather_mailbox(mbox, xf[pair_tok])           # (S, cap, D)
    se = mailbox_ids(mbox, pair_e)                       # -1: empty slot

    rx = _a2a(sx, group, grad=True).reshape(-1, d)       # (S*cap, D)
    re = _a2a(se, group, grad=False).reshape(-1)
    le = torch.where(re >= 0, torch.remainder(re, e_loc), -1)

    # local per-expert mailboxes, 2x headroom over uniform routing
    cap2 = max(8, int(round(n_loc * k * S / cfg.n_experts * 2.0)))
    lbox, over2 = dispatch_to_trees(le, e_loc, cap2)     # (e_loc, cap2)
    (ex,) = gather_mailbox(lbox, rx)                     # (e_loc, cap2, D)
    ex = torch.where((lbox >= 0)[..., None], ex, 0)
    h = torch.einsum("ecd,edf->ecf", ex, w["wi"])
    if cfg.act in ("silu", "geglu", "gelu"):
        h = act(torch.einsum("ecd,edf->ecf", ex, w["wg"])) * h
    else:
        h = act(h)
    out_e = torch.einsum("ecf,efd->ecd", h, w["wo"])

    # expert outputs back to the routed-row order (the spare last row
    # takes the empty slots and is cut), then home by the inverse
    # all_to_all
    n_rows = rx.shape[0]
    rows = torch.where(lbox >= 0, lbox, n_rows).reshape(-1)
    back = torch.zeros((n_rows + 1, d), dtype=xl.dtype, device=dev)
    back = back.index_copy(0, rows, out_e.reshape(-1, d))[:-1]
    ox = _a2a(back.reshape(S, cap, d), group, grad=True).reshape(-1, d)

    # combine: mailbox slot -> its pair -> weighted sum over the k pairs
    src = mailbox_ids(mbox, torch.arange(n_pairs, device=dev)).reshape(-1)
    pair_out = torch.zeros((n_pairs + 1, d), dtype=xl.dtype, device=dev)
    pair_out = pair_out.index_copy(0, torch.where(src >= 0, src, n_pairs),
                                   ox)[:-1]
    y = torch.zeros((n_loc, d), dtype=xl.dtype, device=dev).index_add(
        0, pair_tok, pair_out * pair_w[:, None])
    dropped = None
    if return_drops:
        # a received row past cap2 goes home as a flag
        lost = _a2a(over2.to(torch.int64).reshape(S, cap), group,
                    grad=False).reshape(-1)
        lost_pair = torch.zeros(n_pairs + 1, dtype=torch.int64, device=dev)
        lost_pair = lost_pair.index_copy(
            0, torch.where(src >= 0, src, n_pairs), lost)[:-1]
        pair_drop = over1 | (lost_pair > 0)
        dropped = torch.zeros(n_loc, dtype=torch.int64, device=dev) \
            .index_add(0, pair_tok, pair_drop.to(torch.int64)) > 0
        dropped = dropped.reshape(bl, tl)
    return y.reshape(bl, tl, d), dropped


def aux_load_balance_loss(p, cfg: ModelConfig,
                          x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary (mean fraction * mean prob)."""
    logits = dense(x.reshape(-1, x.shape[-1]), p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top1, cfg.n_experts).float().mean(0)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))
