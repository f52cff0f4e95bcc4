"""Analytic MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE).

The port's copy of the JAX package's ``analysis/model_flops.py``.  N
comes from the exact ParamSpec shapes; MoE activity discounts routed
experts (every leaf under a ``moe`` block whose axes name ``experts``,
the router included, the ``shared_*`` experts not) to top_k/n_experts.
For serve cells the factor is 2 (forward only) and D is the tokens
actually processed (prompt for prefill, 1 per sequence for decode).
Spec-only: nothing is allocated.
"""
from __future__ import annotations

import math

from ..configs import get_config
from ..configs.shapes import SHAPES
from ..models.common import ParamSpec
from ..models.registry import build_model


def _spec_leaves(tree, path=()):
    """(path, ParamSpec) pairs; a list entry's part is "" (the
    reference's path string for a sequence index)."""
    if isinstance(tree, ParamSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], path + (str(k),))
    else:
        for v in tree:
            yield from _spec_leaves(v, path + ("",))


def param_counts(arch: str) -> tuple[int, int]:
    """(total_params, active_params)."""
    cfg = get_config(arch)
    total = routed = 0
    for path, spec in _spec_leaves(build_model(cfg).param_specs):
        n = math.prod(spec.shape)
        total += n
        keys = "/".join(path)
        if "/moe/" in f"/{keys}/" and "shared" not in keys and \
                "experts" in spec.axes:
            routed += n
    if cfg.n_experts:
        active = total - routed + routed * cfg.top_k / cfg.n_experts
    else:
        active = total
    return int(total), int(active)


def model_flops(arch: str, shape: str) -> float:
    """Global MODEL_FLOPS for one step of this cell."""
    cell = SHAPES[shape]
    _, n_active = param_counts(arch)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch
