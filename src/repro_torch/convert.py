"""Carry projections and whole index states between numpy and the port.

The JAX package draws its SRP projections with ``jax.random``, which
torch cannot reproduce, so a test that holds the port against a JAX
index copies ``state.proj`` out of it (as numpy) and hands it over with
:func:`proj_from_numpy`.  :func:`state_to_numpy` and
:func:`state_from_numpy` turn a whole ``PFOState`` to and from nested
dicts of numpy arrays in the JAX package's dtypes (uint32 keys and
filters, f32 payload pages), so every field of the two systems can be
compared — the cold tier's ``ColdState`` included (``None`` when off).

:func:`params_from_numpy` and :func:`params_to_numpy` carry a model's
weights across: the JAX package's param pytree (each group's leaves
stacked over a leading ``layers`` axis, an encoder's ``enc_groups``
alike; every block kind's leaves, MoE experts included) to the port's
``Transformer`` (one module a layer) and back,
so both packages can run on the same weights.  :func:`opt_from_numpy`
and :func:`opt_to_numpy` do the same for AdamW's ``OptState``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import snapshots as snap_mod
from .core.coldtier import ColdCache, ColdRouting, ColdState
from .core.hash_tree import TreeState
from .core.index import PFOState
from .core.store import DenseStore
from .models.common import ModelConfig
from .models.transformer import Transformer, stack_layers, unstack_layers
from .optim.adamw import OptState

#: fields that hold uint32 values (int64 in the port); the port's tree
#: arenas are int64 too, where the reference's are int32
_U32 = {"leaf_key", "keys", "blooms"}
_PARTS = {"lsh_forest": TreeState, "main_forest": TreeState,
          "store": DenseStore, "lsh_snaps": snap_mod.SnapshotSet,
          "main_snaps": snap_mod.SnapshotSet}
_SCALARS = ("tombstones", "n_tombstones", "stamp")
_COLD = {"lsh_route": ColdRouting, "main_route": ColdRouting,
         "lsh_cache": ColdCache, "main_cache": ColdCache}


def proj_from_numpy(proj: dict, device=None) -> dict:
    """``{"table_proj": (d, L*32), "part_proj": (L, 32, C)}`` arrays ->
    float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.array(v, np.float32)).to(device)
            for k, v in proj.items()}


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _leaf_to_numpy(name: str, t):
    if t is None:
        return None
    a = t.detach().cpu().numpy()
    if name in _U32:
        return a.astype(np.uint32)
    if a.dtype == np.int64:                   # the port's int64 arenas
        return a.astype(np.int32)
    return a


def state_to_numpy(state: PFOState) -> dict:
    """Nested dict of numpy leaves, in the JAX package's dtypes."""
    out = {part: {n: _leaf_to_numpy(n, t) for n, t in
                  _fields(getattr(state, part)).items()} for part in _PARTS}
    for name in _SCALARS:
        out[name] = getattr(state, name).detach().cpu().numpy()
    out["proj"] = {k: v.detach().cpu().numpy() for k, v in state.proj.items()}
    out["cold"] = None
    if state.cold is not None:
        out["cold"] = {part: {n: _leaf_to_numpy(n, t) for n, t in
                              _fields(getattr(state.cold, part)).items()}
                       for part in _COLD}
        out["cold"]["n_cold"] = state.cold.n_cold.detach().cpu().numpy()
    return out


def state_from_numpy(tree, device=None) -> PFOState:
    """Build a port state from :func:`state_to_numpy`'s layout, or from
    any object with the same fields (a JAX ``PFOState`` whose leaves
    convert with ``np.asarray``)."""
    top = _fields(tree)

    def tensor(name, a, wide=False):
        if a is None:
            return None
        a = np.asarray(a)
        if name in _U32 or (wide and a.dtype.kind == "i"):
            a = a.astype(np.int64)
        return torch.as_tensor(a.copy()).to(device)

    def group(src, kinds, wide=False):
        return {part: cls(**{n: tensor(n, a, wide=wide and cls is TreeState)
                             for n, a in _fields(src[part]).items()})
                for part, cls in kinds.items()}

    cold = top.get("cold")
    if cold is not None:
        cold = _fields(cold)
        cold = ColdState(**group(cold, _COLD),
                         n_cold=tensor("n_cold", cold["n_cold"]))
    return PFOState(**group(top, _PARTS, wide=True),
                    **{n: tensor(n, top[n]) for n in _SCALARS},
                    proj=proj_from_numpy(_fields(top["proj"]), device),
                    cold=cold)


def _param_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16: bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> Transformer:
    """The JAX package's param pytree (arrays as numpy, or anything
    ``np.asarray`` takes; bfloat16 arrays keep their bits) -> the port's
    ``Transformer`` on ``device`` (CPU when None) in the arrays' dtypes,
    each group's ``layers`` axis unstacked."""
    return Transformer(cfg, _map_tree(tree,
                                      lambda a: _param_tensor(a, device)))


def params_to_numpy(model: Transformer) -> dict:
    """:func:`params_from_numpy`'s inverse: the reference's pytree layout
    (groups stacked over ``layers``) as numpy arrays; bfloat16 comes back
    as float32 (exact), numpy having no bfloat16."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map_tree(model.tree(), leaf)


def opt_from_numpy(opt, device=None) -> OptState:
    """The JAX package's ``OptState`` (or :func:`opt_to_numpy`'s dict):
    m, v and master (None or a tree) in the reference's stacked layout,
    the step a 0-d int32 -> the port's ``OptState`` on ``device``, each
    tree in ``param_dict``'s layout (layers unstacked)."""
    f = _fields(opt)

    def tree(t):
        if t is None:
            return None
        return unstack_layers(_map_tree(t, lambda a: _param_tensor(a,
                                                                   device)))
    return OptState(tree(f["m"]), tree(f["v"]), tree(f["master"]),
                    _param_tensor(f["step"], device))


def opt_to_numpy(opt: OptState) -> dict:
    """:func:`opt_from_numpy`'s inverse: ``{"m", "v", "master", "step"}``
    in the reference's stacked layout as numpy (master None when off)."""
    def tree(t):
        if t is None:
            return None
        return _map_tree(stack_layers(t),
                         lambda x: x.detach().cpu().numpy())
    return dict(m=tree(opt.m), v=tree(opt.v), master=tree(opt.master),
                step=opt.step.detach().cpu().numpy())
