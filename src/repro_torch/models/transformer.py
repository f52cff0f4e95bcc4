"""Model assembly: block groups -> per-layer modules -> LM.

The port's copy of the JAX package's ``models/transformer.py``: embed ->
[block groups] -> final norm -> (tied or separate) LM head, and the
sequence-chunked next-token loss :func:`lm_loss`.  A block is GQA
attention (full, local or chunked; with cross-attention in whisper's
decoder), MLA, RWKV-6 (time mix, then channel mix) or RG-LRU, followed
by a dense or routed-expert (MoE) feed-forward (RWKV's channel mix is
its own).  Enc-dec (whisper) runs an encoder stack over the frame
embeddings first and threads ``enc_out`` into the decoder's
cross-attention; a prefill stores the cross keys and values in the
cache, where decode steps read them.  The reference stacks each group's
params over a ``layers`` axis and scans them; here :class:`Transformer`
holds one module a layer (an ``nn.ModuleList`` a group) and
:func:`run_groups` is a Python loop over the layers.  With ``remat``
each layer's body (the reference's scan body) and each loss chunk run
under ``torch.utils.checkpoint``, so their activations are recomputed
in the backward pass instead of kept.  The patch and audio frontends
are the reference's stubs (precomputed patch or frame embeddings arrive
as inputs).

The ``constrain(tensor, logical_axes)`` callback threads sharding
annotations through the model at the reference's call sites (a
``ShardingPolicy``'s ``constrain``; the identity by default, so an
unsharded run is unchanged).  ``cfg.moe_impl == "shardmap"`` routes MoE
blocks through ``moe.moe_apply_shardmap`` (the all_to_all dispatch).

The functional API takes ``params`` as a :class:`Transformer` or as the
nested dict :func:`param_dict` makes of one (any tensors: a trainer
passes leaves that require gradients); ``batch`` holds tensors on the
params' device.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import rwkv6 as rwkv_mod
from .common import BlockDef, ModelConfig, ParamSpec, activation, dense, \
    layernorm, map_specs, reshape, rmsnorm

GROUP_KEYS = ("groups", "enc_groups")       # the stacked layer lists


def _ident(t, axes):
    return t


def _check_supported(blk: BlockDef, cfg: ModelConfig) -> None:
    if blk.kind not in ("attn", "mla", "rwkv", "rglru"):
        raise ValueError(blk.kind)
    if cfg.moe_impl not in ("gspmd", "shardmap"):
        raise ValueError(cfg.moe_impl)


def _all_blocks(cfg: ModelConfig):
    for pat, _ in cfg.groups + cfg.enc_groups:
        yield from pat


# ======================================================================
# parameter declaration (the reference's stacked spec tree)
# ======================================================================
def _norm_specs(cfg: ModelConfig, name: str) -> dict:
    d = cfg.d_model
    sp = {f"{name}_w": ParamSpec((d,), ("embed",), "ones")}
    if cfg.norm == "layernorm":
        sp[f"{name}_b"] = ParamSpec((d,), ("embed",), "zeros")
    return sp


def _apply_norm(cfg: ModelConfig, p, name: str, x: torch.Tensor):
    if cfg.norm == "layernorm":
        return layernorm(x, p[f"{name}_w"], p[f"{name}_b"], cfg.norm_eps)
    return rmsnorm(x, p[f"{name}_w"], cfg.norm_eps)


def mlp_param_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    sp = {"wi": ParamSpec((d, f), ("embed", "ffn")),
          "wo": ParamSpec((f, d), ("ffn", "embed"))}
    if cfg.act in ("silu", "geglu"):
        sp["wg"] = ParamSpec((d, f), ("embed", "ffn"))
    return sp


def mlp_apply(p, cfg: ModelConfig, x: torch.Tensor,
              constrain=_ident) -> torch.Tensor:
    if cfg.act in ("silu", "geglu"):
        act = activation("silu" if cfg.act == "silu" else "gelu")
        h = act(dense(x, p["wg"])) * dense(x, p["wi"])
    else:
        h = activation(cfg.act)(dense(x, p["wi"]))
    h = constrain(h, ("batch", "seq", "ffn"))
    return dense(h, p["wo"])


def block_param_specs(cfg: ModelConfig, blk: BlockDef) -> dict:
    _check_supported(blk, cfg)
    sp: dict = {}
    sp.update(_norm_specs(cfg, "ln1"))
    if blk.kind == "attn":
        sp["attn"] = attn_mod.gqa_param_specs(cfg)
    elif blk.kind == "mla":
        sp["attn"] = attn_mod.mla_param_specs(cfg)
    elif blk.kind == "rwkv":
        sp["rwkv"] = rwkv_mod.rwkv_param_specs(cfg)
    else:
        sp["rglru"] = rglru_mod.rglru_param_specs(cfg)
    if blk.cross_attn:
        sp.update(_norm_specs(cfg, "lnx"))
        sp["cross"] = attn_mod.cross_param_specs(cfg)
    sp.update(_norm_specs(cfg, "ln2"))
    if blk.kind == "rwkv":
        pass  # the channel mix lives in the rwkv specs
    elif blk.moe:
        sp["moe"] = moe_mod.moe_param_specs(cfg)
    else:
        sp["mlp"] = mlp_param_specs(cfg)
    return sp


def _stack_specs(spec_tree, repeat: int):
    return map_specs(spec_tree, lambda s: ParamSpec(
        (repeat, *s.shape), ("layers", *s.axes), s.init, s.scale))


def group_param_specs(cfg: ModelConfig, pattern: tuple,
                      repeat: int) -> dict:
    per_layer = {f"b{i}": block_param_specs(cfg, blk)
                 for i, blk in enumerate(pattern)}
    return _stack_specs(per_layer, repeat)


def model_param_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    sp: dict = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                           "normal", 1.0),
        "groups": [group_param_specs(cfg, pat, rep)
                   for pat, rep in cfg.groups],
    }
    sp.update(_norm_specs(cfg, "final"))
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.enc_groups:
        sp["enc_groups"] = [group_param_specs(cfg, pat, rep)
                            for pat, rep in cfg.enc_groups]
        sp.update({f"enc_{k}": v
                   for k, v in _norm_specs(cfg, "final").items()})
        sp["enc_pos"] = ParamSpec((cfg.enc_len, d), ("seq", "embed"),
                                  "normal", 0.02)
    if cfg.frontend == "patch":
        sp["patch_pos"] = ParamSpec((cfg.frontend_len, d),
                                    ("seq", "embed"), "normal", 0.02)
    return sp


# ======================================================================
# the model state as modules
# ======================================================================
class ParamTree(nn.Module):
    """A nested dict of tensors as a module: ``tree[name]`` is a
    parameter or a sub-tree.  Parameters are registered without
    gradients, so serving builds no autograd graph; ``requires_grad_()``
    turns them on, and the trainer (``train/loop.py``) differentiates
    with respect to detached aliases of them instead."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(
                    name, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def get(self, name: str, default=None):
        return getattr(self, name, default)

    def tree(self) -> dict:
        """The nested dict of tensors this module holds."""
        out = {n: p for n, p in self._parameters.items()}
        out.update({n: m.tree() for n, m in self._modules.items()})
        return out


def _unstack(tree, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class Transformer(ParamTree):
    """A model's params: the reference's tree with each group's
    ``layers`` axis unstacked into an ``nn.ModuleList`` of one
    :class:`ParamTree` a layer (``{"b0": ..., "b1": ...}``, one entry a
    block of the group's pattern); an encoder's groups alike
    (``enc_groups``).  ``model(batch)`` is :func:`forward`."""

    def __init__(self, cfg: ModelConfig, tree: dict):
        for blk in _all_blocks(cfg):
            _check_supported(blk, cfg)
        top = {k: v for k, v in tree.items() if k not in GROUP_KEYS}
        super().__init__(top)
        self.cfg = cfg
        for key, groups in (("groups", cfg.groups),
                            ("enc_groups", cfg.enc_groups)):
            if groups:
                self.add_module(key, nn.ModuleList(
                    nn.ModuleList(ParamTree(_unstack(g, i))
                                  for i in range(rep))
                    for g, (_, rep) in zip(tree[key], groups)))

    def tree(self) -> dict:
        """The reference's layout: each group's layers stacked again."""
        return stack_layers(param_dict(self))

    def forward(self, batch: dict, caches=None, positions=None):
        return forward(self, self.cfg, batch, caches=caches,
                       positions=positions)


def param_dict(params) -> dict:
    """A :class:`Transformer`'s tensors as a nested dict: the
    reference's tree with each group a list of one ``{"b<i>": ...}`` dict
    a layer (the layout the functional API, the optimizer and
    :func:`_cast_params` work on).  A dict is returned as it is."""
    if not isinstance(params, Transformer):
        return params
    tree = {n: p for n, p in params._parameters.items()}
    for key in GROUP_KEYS:
        if key in params._modules:
            tree[key] = [[layer.tree() for layer in g]
                         for g in params._modules[key]]
    return tree


def stack_layers(tree: dict) -> dict:
    """:func:`param_dict`'s layout -> the reference's (each group's
    layers stacked on a leading axis)."""
    return dict(tree, **{k: [_stack(g) for g in tree[k]]
                         for k in GROUP_KEYS if k in tree})


def unstack_layers(tree: dict) -> dict:
    """:func:`stack_layers`' inverse (views of the stacked tensors)."""
    return dict(tree, **{k: [[_unstack(g, i) for i in range(_layers(g))]
                             for g in tree[k]]
                         for k in GROUP_KEYS if k in tree})


def _layers(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


# ======================================================================
# caches
# ======================================================================
def block_init_cache(cfg: ModelConfig, blk: BlockDef, batch: int,
                     max_len: int, dtype: torch.dtype, device) -> dict:
    """One block's cache: ``kv`` (GQA, MLA) or ``state`` (RWKV, RG-LRU),
    and ``cross_k`` / ``cross_v`` (B, enc_len, KV, head_dim) for a
    cross-attention block."""
    c: dict = {}
    if blk.kind == "attn":
        c["kv"] = attn_mod.gqa_init_cache(cfg, blk, batch, max_len, dtype,
                                          device)
    elif blk.kind == "mla":
        c["kv"] = attn_mod.mla_init_cache(cfg, batch, max_len, dtype, device)
    elif blk.kind == "rwkv":
        c["state"] = rwkv_mod.rwkv_init_state(cfg, batch, dtype, device)
    else:
        c["state"] = rglru_mod.rglru_init_state(cfg, batch, dtype, device)
    if blk.cross_attn:
        shape = (batch, cfg.enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["cross_k"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cross_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device):
    """Caches mirroring the decoder's layer structure: a list per group
    of one ``{"b<i>": block_init_cache(...)}`` a layer."""
    out = []
    for pat, rep in cfg.groups:
        for blk in pat:
            _check_supported(blk, cfg)
        out.append([{f"b{i}": block_init_cache(cfg, blk, batch, max_len,
                                                dtype, device)
                     for i, blk in enumerate(pat)} for _ in range(rep)])
    return out


# ======================================================================
# forward
# ======================================================================
def apply_block(blk: BlockDef, bp, cfg: ModelConfig, x: torch.Tensor,
                positions, bcache, enc_out=None, causal: bool = True,
                constrain=_ident):
    """One block.  ``bcache`` None runs without a cache; ``enc_out``
    (B, enc_len, D) feeds a cross-attention block, which otherwise reads
    the cross keys and values a prefill stored in ``bcache``.  Returns
    (x, new_cache)."""
    _check_supported(blk, cfg)
    new_cache = dict(bcache) if bcache is not None else None
    h = _apply_norm(cfg, bp, "ln1", x)
    if blk.kind in ("attn", "mla"):
        apply = attn_mod.gqa_apply if blk.kind == "attn" else \
            attn_mod.mla_apply
        kw = {"causal": causal, "constrain": constrain} \
            if blk.kind == "attn" else {}
        o, kv = apply(bp["attn"], cfg, blk, h, positions,
                      cache=bcache["kv"] if bcache is not None else None,
                      **kw)
        if new_cache is not None and kv is not None:
            new_cache["kv"] = kv
        x = x + o
    elif blk.kind == "rwkv":
        st = bcache["state"] if bcache is not None else \
            rwkv_mod.rwkv_init_state(cfg, x.shape[0], x.dtype, x.device)
        o, st = rwkv_mod.time_mix(bp["rwkv"], cfg, h, st)
        x = x + o
        h2 = _apply_norm(cfg, bp, "ln2", x)
        o2, st = rwkv_mod.channel_mix(bp["rwkv"], cfg, h2, st)
        x = x + o2
        if new_cache is not None:
            new_cache["state"] = st
        return constrain(x, ("batch", "seq", "embed")), new_cache
    else:
        st = bcache["state"] if bcache is not None else \
            rglru_mod.rglru_init_state(cfg, x.shape[0], x.dtype, x.device)
        o, st = rglru_mod.rglru_apply(bp["rglru"], cfg, h, st)
        x = x + o
        if new_cache is not None:
            new_cache["state"] = st

    if blk.cross_attn:
        hx = _apply_norm(cfg, bp, "lnx", x)
        if enc_out is not None:                       # train / prefill
            shape = (*enc_out.shape[:2], cfg.n_kv_heads, cfg.head_dim)
            ck = reshape(dense(enc_out, bp["cross"]["wk"]), *shape)
            cv = reshape(dense(enc_out, bp["cross"]["wv"]), *shape)
            if new_cache is not None:
                new_cache["cross_k"] = ck.to(new_cache["cross_k"].dtype)
                new_cache["cross_v"] = cv.to(new_cache["cross_v"].dtype)
        elif bcache is not None:                      # decode
            ck, cv = bcache["cross_k"], bcache["cross_v"]
        else:
            raise ValueError("a cross-attention block needs the encoder's "
                             "output: pass batch['features']")
        o, _ = attn_mod.gqa_apply(bp["cross"], cfg, blk, hx, positions,
                                  cross_kv=(ck, cv))
        x = x + o

    h2 = _apply_norm(cfg, bp, "ln2", x)
    if blk.moe:
        moe_fn = (moe_mod.moe_apply_shardmap
                  if cfg.moe_impl == "shardmap" else moe_mod.moe_apply)
        x = x + moe_fn(bp["moe"], cfg, h2, constrain)
    else:
        x = x + mlp_apply(bp["mlp"], cfg, h2, constrain)
    return constrain(x, ("batch", "seq", "embed")), new_cache


def _layer(pat, lp, cfg: ModelConfig, x, positions, enc_out, causal,
           constrain):
    """One layer (one repeat of the group's pattern) with no cache: the
    body that ``remat`` checkpoints."""
    for i, blk in enumerate(pat):
        x, _ = apply_block(blk, lp[f"b{i}"], cfg, x, positions, None,
                           enc_out, causal, constrain)
    return x


def run_groups(groups_cfg, gparams_list, x, caches, *, cfg, positions,
               enc_out=None, causal: bool = True, remat: bool = False,
               constrain=_ident):
    """Every layer of every group in order (a Python loop, no scan).
    ``gparams_list[g][layer]`` and ``caches[g][layer]`` hold one layer's
    ``{"b<i>": ...}``.  ``remat`` (no caches) recomputes each layer's
    activations in the backward pass, as the reference's
    ``jax.checkpoint`` around its scan body does."""
    if caches is None:
        for (pat, _), layers in zip(groups_cfg, gparams_list):
            for lp in layers:
                if remat:
                    x = checkpoint(_layer, pat, lp, cfg, x, positions,
                                   enc_out, causal, constrain,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = _layer(pat, lp, cfg, x, positions, enc_out, causal,
                               constrain)
        return x, None
    new_caches = []
    for gi, (pat, rep) in enumerate(groups_cfg):
        out = []
        for li in range(rep):
            lp, lc = gparams_list[gi][li], caches[gi][li]
            lc_new = {}
            for i, blk in enumerate(pat):
                x, lc_new[f"b{i}"] = apply_block(
                    blk, lp[f"b{i}"], cfg, x, positions, lc[f"b{i}"],
                    enc_out, causal, constrain)
            out.append(lc_new)
        new_caches.append(out)
    return x, new_caches


def embed_inputs(params, cfg: ModelConfig, batch: dict,
                 constrain=_ident) -> torch.Tensor:
    """Token + frontend-stub embedding -> (B, T, D)."""
    x = params["embed"][batch["tokens"].long()].to(cfg.dtype)
    if cfg.frontend == "patch" and "patches" in batch:
        pe = (batch["patches"].to(cfg.dtype)
              + params["patch_pos"][None].to(cfg.dtype))
        x = torch.cat([pe, x], dim=1)
    return constrain(x, ("batch", "seq", "embed"))


def encode(params: dict, cfg: ModelConfig, batch: dict,
           remat: bool = False, constrain=_ident) -> torch.Tensor:
    """The whisper encoder over stub frame embeddings
    ``batch["features"]`` (B, enc_len, D), non-causal, on params already
    cast to ``cfg.dtype``."""
    x = batch["features"].to(cfg.dtype) + params["enc_pos"][None].to(
        cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = run_groups(cfg.enc_groups, params["enc_groups"], x, None,
                      cfg=cfg, positions=positions, causal=False,
                      remat=remat, constrain=constrain)
    return _apply_norm(cfg, {k[len("enc_"):]: v for k, v in params.items()
                             if k.startswith("enc_final")}, "final", x)


def _cast_params(params, dtype: torch.dtype):
    """Mixed precision: master params may be fp32; compute in cfg.dtype.
    Returns :func:`param_dict`'s nested dict of cast tensors; a tensor
    already in ``dtype`` is passed through, not copied, and the cast is
    differentiable (an f32 master's gradient flows through it)."""
    params = param_dict(params)

    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast(v) for v in t]
        return t.to(dtype) if t.is_floating_point() else t

    return cast(params)


def forward(params, cfg: ModelConfig, batch: dict, *, caches=None,
            positions=None, remat: bool = False, constrain=_ident):
    """Returns (hidden (B,T,D), new_caches)."""
    return _forward(_cast_params(params, cfg.dtype), cfg, batch, caches,
                    positions, remat, constrain)


def _forward(params: dict, cfg: ModelConfig, batch: dict, caches,
             positions, remat: bool = False, constrain=_ident):
    """:func:`forward` on params already cast to ``cfg.dtype``."""
    enc_out = None
    if cfg.enc_groups and "features" in batch:
        enc_out = encode(params, cfg, batch, remat, constrain)
    x = embed_inputs(params, cfg, batch, constrain)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    x, new_caches = run_groups(cfg.groups, params["groups"], x, caches,
                               cfg=cfg, positions=positions,
                               enc_out=enc_out, remat=remat,
                               constrain=constrain)
    x = _apply_norm(cfg, params, "final", x)
    return constrain(x, ("batch", "seq", "embed")), new_caches


def logits_fn(params, cfg: ModelConfig, hidden: torch.Tensor,
              constrain=_ident):
    """(B,T,D) -> (B,T,V) logits, in the hidden's dtype."""
    return _logits(_cast_params(params, cfg.dtype), cfg, hidden, constrain)


def _logits(params: dict, cfg: ModelConfig, hidden: torch.Tensor,
            constrain=_ident):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return constrain(torch.matmul(hidden, w.to(hidden.dtype)),
                     ("batch", "seq", "vocab"))


def _chunk_loss(h: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                constrain=_ident) -> torch.Tensor:
    """Summed ``logsumexp - gold`` of one chunk: h (B,c,D), labels (B,c);
    the logits in float32, from a product in h's dtype.  On DTensor
    logits (vocab-sharded) the gold logit is a masked sum over the vocab,
    the one nonzero term exact: DTensor's gather rule over a sharded
    vocab fails on this op chain."""
    logits = constrain(torch.matmul(h, w.to(h.dtype)).float(),
                       ("batch", "seq", "vocab"))
    if hasattr(logits, "device_mesh"):
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(vocab == labels[..., None].long(), logits,
                           0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def lm_loss(params, cfg: ModelConfig, batch: dict, *, remat: bool = True,
            loss_chunk: int = 512, constrain=_ident) -> torch.Tensor:
    """Next-token cross-entropy, sequence-chunked: the (B, T, V) logits
    are never materialised, one (B, T / n_chunks, V) chunk at a time,
    where n_chunks is the largest count <= T // loss_chunk that divides
    T.  Summed in float32 and divided by B * T.  ``remat`` also
    recomputes each chunk's logits in the backward pass."""
    cparams = _cast_params(params, cfg.dtype)
    hidden, _ = _forward(cparams, cfg, batch, None, None, remat, constrain)
    labels = batch["labels"]
    if cfg.frontend == "patch" and "patches" in batch:
        hidden = hidden[:, -labels.shape[1]:]
    b, t, _ = hidden.shape
    w = cparams["embed"].T if cfg.tie_embeddings else cparams["lm_head"]
    n_chunks = max(t // loss_chunk, 1)
    while t % n_chunks:          # largest chunk count dividing t
        n_chunks -= 1
    c = t // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        h, lab = hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if remat:
            total = total + checkpoint(_chunk_loss, h, lab, w, constrain,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _chunk_loss(h, lab, w, constrain)
    if hasattr(total, "full_tensor"):
        # a 0-d DTensor's division backward fails on a Partial sum
        total = total.full_tensor()
    return total / (b * t)


def prefill(params, cfg: ModelConfig, batch: dict, cache,
            constrain=_ident):
    """Fill caches with the prompt.  Returns (last_logits (B,1,V),
    caches, last_hidden (B,D)): the last position's final hidden state
    comes back too, from the same pass (the kNN-LM head's query; the
    reference computes it with a second forward)."""
    tlen = batch["tokens"].shape[1] + (
        cfg.frontend_len if cfg.frontend == "patch" and "patches" in batch
        else 0)
    params = _cast_params(params, cfg.dtype)
    hidden, caches = _forward(
        params, cfg, batch, cache,
        torch.arange(tlen, device=batch["tokens"].device),
        constrain=constrain)
    last = hidden[:, -1:]
    return _logits(params, cfg, last, constrain), caches, last[:, 0]


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache, *,
                pos: int, constrain=_ident):
    """One decode step: token (B, 1) at absolute position ``pos``."""
    params = _cast_params(params, cfg.dtype)
    hidden, caches = _forward(params, cfg, {"tokens": token}, cache,
                              pos + torch.arange(1, device=token.device),
                              constrain=constrain)
    return _logits(params, cfg, hidden, constrain), caches
