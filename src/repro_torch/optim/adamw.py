"""AdamW with cosine schedule and global-norm clipping.

The port's copy of the JAX package's ``optim/adamw.py``: plain functions
on trees of tensors (nested dicts and lists, as
``models.transformer.param_dict`` lays a model out), not
``torch.optim``, so each step's arithmetic follows the reference's.
State is (m, v) in float32 plus an optional float32 master copy of the
params (``use_master``) and the step as a 0-d int32 tensor on the
params' device, so no schedule value is read back to the host.

The schedule and the bias corrections are evaluated as float32 tensors,
as JAX evaluates them (its weak-typed Python scalars take the array's
float32): Python doubles would differ in the last bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    use_master: bool = True
    # gradient compression: differentiate w.r.t. a bf16 copy of the
    # params (half the gradient bytes); m/v/update stay fp32
    grad_dtype: str = "f32"        # "f32" | "bf16"


class OptState(NamedTuple):
    m: object
    v: object
    master: object       # fp32 copy or None
    step: torch.Tensor   # 0-d int32


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its dict / list structure; None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest)]
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted, list
    entries in order, None skipped."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves`
    order) in place of its own."""
    it = iter(leaves)

    def take(node):
        if isinstance(node, dict):
            got = {k: take(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        if isinstance(node, (list, tuple)):
            return [take(v) for v in node]
        return None if node is None else next(it)

    return take(tree)


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_frac`` of
    it at ``total_steps``; ``step`` an integer tensor, the result float32."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(cfg: AdamWConfig, params) -> OptState:
    """Zero moments in float32, a float32 master copy when
    ``use_master``, step 0 on the params' device."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params) if cfg.use_master else None
    device = tree_leaves(params)[0].device
    return OptState(m=zeros, v=tree_map(torch.clone, zeros), master=master,
                    step=torch.zeros((), dtype=torch.int32, device=device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in :func:`tree_leaves` order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def adamw_update(cfg: AdamWConfig, grads, opt: OptState, params):
    """Returns (new_params, new_opt, metrics): new tensors, the inputs
    untouched.  New params take each old param's dtype."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = opt.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    ref = opt.master if cfg.use_master else params

    gs = tree_map(lambda g: g.float() * scale, grads)
    m = tree_map(lambda m_, g: cfg.b1 * m_ + (1 - cfg.b1) * g, opt.m, gs)
    v = tree_map(lambda v_, g: cfg.b2 * v_ + (1 - cfg.b2) * g * g, opt.v, gs)
    newf = tree_map(
        lambda m_, v_, p: p.float() - lr * (
            (m_ / b1c) / (torch.sqrt(v_ / b2c) + cfg.eps)
            + cfg.weight_decay * p.float()),
        m, v, ref)
    new_params = tree_map(lambda nf, p: nf.to(p.dtype), newf, params)
    new_master = newf if cfg.use_master else None
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, OptState(m, v, new_master, step), metrics
