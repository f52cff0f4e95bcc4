"""Process layout of the port's distributed stream engine.

The JAX package drives every shard from one process over a device mesh.
The port runs SPMD on ``torch.distributed``: one process per device,
every process running the same program on the same request stream.
:func:`stream_mesh` lays the world out as a ``(data, model)`` grid —
rank ``r`` is data replica ``r // n_model``, model shard
``r % n_model`` — and opens the process groups the collectives run on:
the rank's ``model`` group (the shards of its replica: routing and the
flag word's max) and its ``data`` group (the replicas of its shard:
query rows split over it).

The LM stack's part (:class:`ShardingPolicy`, :func:`make_policy`) is
the JAX package's logical-axis rule table (MaxText-style rules,
divisibility-safe).  Every parameter, activation and cache tensor
carries *logical* axis names; a rule table maps each name to the mesh
axes it wants.  :meth:`ShardingPolicy._resolve` degrades gracefully: a
mesh-axis product that does not divide the dim drops trailing axes (and
finally the whole rule), and no mesh axis is used twice in one tensor.
A resolved spec is a tuple with one entry a tensor dim: ``None``, a
mesh axis name, or a tuple of them (the JAX ``PartitionSpec``'s
entries).  The rules are plain Python and need no mesh devices: a
:class:`MeshShape` stands in for a mesh.

Modes:
  train  — 2D weight sharding ("model" on TP dims, FSDP on "embed"
           over the batch axes), batch over (pod, data), EP for
           experts, activations TP on ffn/vocab.
  serve  — TP over "model"; weights additionally FSDP over "data"
           when the per-chip estimate exceeds ``serve_fsdp_gb``
           (the 100B+ archs); KV caches shard batch over (pod, data)
           and sequence over "model" (kv-head sharding when the kv
           heads divide "model").

On a ``torch.distributed`` :class:`DeviceMesh` a spec becomes DTensor
placements (:meth:`ShardingPolicy.placements`): a tensor dim whose spec
names mesh axes takes ``Shard(dim)`` on each of them, every other mesh
dim ``Replicate()``; a dim split over ``("pod", "data")`` splits
pod-major, as JAX's (DTensor shards in mesh-dim order, and ``pod`` is
the mesh's first axis).  XLA's SPMD partitioner has its counterpart in
DTensor's sharding propagation: a step runs under
:meth:`ShardingPolicy.context` (plain tensors — positions, masks — act
as replicated), and :meth:`ShardingPolicy.constrain` redistributes an
activation to its rule's placements where the reference puts a
``with_sharding_constraint``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from ..core.device import default_device
from ..models.common import ModelConfig, ParamSpec, map_specs


@dataclasses.dataclass(frozen=True)
class StreamMesh:
    """One rank's view of the ``(data, model)`` grid."""
    n_model: int
    n_data: int
    shard: int                 # this rank's model index
    data_index: int            # this rank's data index
    device: torch.device
    model_group: object        # process group over this replica's shards
    data_group: object         # process group over this shard's replicas
    world_group: object        # every rank of the grid
    backend: str

    @property
    def rank(self) -> int:
        return self.data_index * self.n_model + self.shard


def stream_mesh(n_model: int, n_data: int = 1, device=None) -> StreamMesh:
    """The ``(data, model)`` grid over the initialised default process
    group, whose world must be exactly ``n_model * n_data`` ranks.

    ``device`` None means CUDA: each rank takes GPU ``rank % count`` and
    the groups run on NCCL (raises without a GPU or without NCCL).
    ``device="cpu"`` runs the groups on gloo over CPU tensors.  Every
    rank must call this with the same arguments (group creation is a
    collective)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "stream_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "rank=..., world_size=...) on every rank first")
    need = n_model * n_data
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != need:
        raise RuntimeError(
            f"stream_mesh({n_data}x{n_model}) needs a world of {need} "
            f"ranks, one per device; the process group has {world}")
    device = default_device(device)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("stream_mesh on CUDA needs NCCL, and this "
                               "torch build has none")
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"stream_mesh runs on cuda or cpu, not {device}")
    d_idx, shard = divmod(rank, n_model)
    model_group = data_group = None
    # every rank creates every group, in the same order
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)],
                           backend=backend)
        if d == d_idx:
            model_group = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)],
                           backend=backend)
        if m == shard:
            data_group = g
    world_group = dist.new_group(list(range(need)), backend=backend)
    return StreamMesh(n_model=n_model, n_data=n_data, shard=shard,
                      data_index=d_idx, device=device,
                      model_group=model_group, data_group=data_group,
                      world_group=world_group, backend=backend)


# ======================================================================
# the LM stack's rule table
# ======================================================================
class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with no devices: the rule table's
    view of a mesh (a :class:`DeviceMesh` gives the same through
    :func:`mesh_axes`)."""
    axis_names: tuple
    shape: tuple


class NamedSharding(NamedTuple):
    """A leaf's placement on a mesh (what ``restore_checkpoint``'s
    ``shardings`` tree holds)."""
    mesh: Any
    placements: tuple


def gathered(t: torch.Tensor) -> torch.Tensor:
    """A step's output as a full local tensor: a DTensor gathered, any
    other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a :class:`MeshShape` or a DeviceMesh."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def placements(mesh, spec) -> tuple:
    """A spec's DTensor placements, one a mesh dim: ``Shard(d)`` where
    tensor dim d's spec names that mesh axis (of more than one rank),
    else ``Replicate()``.  DTensor splits a dim named by several mesh
    axes in the mesh's order: as JAX's for ``("pod", "data")``; for
    ``small_batch``'s cache sequence over ``("model", "data")`` the
    blocks land on other ranks than JAX's (data-major), each rank
    holding the same number of bytes."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if sizes[a] > 1:          # a split over one rank is no split
                out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any                 # DeviceMesh, or MeshShape for rules alone
    param_rules: dict
    act_rules: dict
    cache_rules: dict
    # logical axes where an unsharded resolution means "emit no
    # constraint at all" rather than "force replication" (serve mode's
    # heads: forcing head replication costs prefill memory)
    soft_axes: frozenset = frozenset()

    # -- core: logical axes + shape -> spec ------------------------------
    def _resolve(self, shape, axes, rules) -> tuple:
        used: set = set()
        out = []
        sizes = mesh_axes(self.mesh)
        for dim, ax in zip(shape, axes):
            want = tuple(rules.get(ax, ()) or ())
            want = tuple(a for a in want if a not in used)
            # drop trailing axes until the product divides the dim
            while want:
                prod = math.prod(sizes[a] for a in want)
                if prod > 0 and dim % prod == 0 and prod > 1:
                    break
                want = want[:-1]
            if want:
                used.update(want)
                out.append(want if len(want) > 1 else want[0])
            else:
                out.append(None)
        return tuple(out)

    def param_spec(self, shape, axes) -> tuple:
        return self._resolve(shape, axes, self.param_rules)

    def act_spec(self, shape, axes) -> tuple:
        return self._resolve(shape, axes, self.act_rules)

    def cache_spec(self, shape, axes) -> tuple:
        return self._resolve(shape, axes, self.cache_rules)

    # -- specs -> DTensor placements ---------------------------------------
    def placements(self, spec) -> tuple:
        return placements(self.mesh, spec)

    # -- spec-tree helpers -------------------------------------------------
    def param_pspecs(self, spec_tree):
        return map_specs(spec_tree,
                         lambda s: self.param_spec(s.shape, s.axes))

    def param_shardings(self, spec_tree):
        """Placements a leaf of a ParamSpec tree."""
        return map_specs(spec_tree, lambda s: self.placements(
            self.param_spec(s.shape, s.axes)))

    def distribute(self, t: torch.Tensor, spec) -> torch.Tensor:
        """``t`` (the same full tensor on every rank) as a DTensor placed
        by ``spec``: each rank keeps its own block, no data moves."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, self.placements(spec),
                                 src_data_rank=None)

    @contextlib.contextmanager
    def context(self):
        """A sharded step's scope: plain tensors (positions, masks,
        host-made constants) act as replicated DTensors."""
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            yield

    def constrain(self, x, axes):
        """The callback threaded through the model as ``constrain``: a
        DTensor redistributed to its rule's placements (a plain tensor
        is first taken as replicated)."""
        if x.ndim != len(axes):
            return x
        spec = self.act_spec(x.shape, axes)
        for ax, sp in zip(axes, spec):
            if ax in self.soft_axes and sp is None:
                return x          # skip: don't force replication
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        want = self.placements(spec)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh, want)

    def batch_spec(self) -> tuple:
        ax = self.act_rules.get("batch", ())
        return (ax if len(ax) > 1 else (ax[0] if ax else None),)

    def batch_sharding(self) -> tuple:
        """Placements of a batch tensor (dim 0 over the batch axes)."""
        return self.placements(self.batch_spec())


def _batch_axes(mesh) -> tuple:
    names = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def estimate_param_bytes(spec_tree, bytes_per: int = 2) -> int:
    total = [0]

    def add(s: ParamSpec):
        total[0] += math.prod(s.shape) * bytes_per
        return s

    map_specs(spec_tree, add)
    return total[0]


def make_policy(mesh, cfg: ModelConfig, mode: str, *, param_specs=None,
                serve_fsdp_gb: float = 8.0,
                small_batch: bool = False) -> ShardingPolicy:
    """Build the rule tables for (mesh, arch, mode).

    mode: "train" | "serve".  ``small_batch`` (long_500k) re-targets
    the idle batch axes at the cache sequence dim."""
    sizes = mesh_axes(mesh)
    b_axes = _batch_axes(mesh)
    mdl = ("model",) if "model" in sizes else ()

    # ---------------- parameters ----------------
    tp_dims = {
        "ffn": mdl, "vocab": mdl, "q_features": mdl, "kv_features": mdl,
        "experts": mdl, "heads": mdl,
        "kv_lora": (), "lora": (), "five": (), "conv": (), "seq": (),
        "ffn2": (), "head_dim": (), "layers": (),
    }
    if mode == "train":
        # 2D: TP dims over model, FSDP the embed dim over batch axes
        param_rules = dict(tp_dims, embed=b_axes)
    else:
        pb = estimate_param_bytes(param_specs) if param_specs else 0
        per_chip = pb / max(math.prod(sizes[a] for a in mdl), 1)
        big = per_chip > serve_fsdp_gb * (1 << 30)
        param_rules = dict(tp_dims, embed=(("data",) if big and "data"
                                           in sizes else ()))

    # ---------------- activations ----------------
    act_rules = {
        "batch": b_axes if not small_batch else (),
        "seq": () if not small_batch else b_axes,
        "embed": (), "ffn": mdl, "vocab": mdl,
        "experts": mdl, "exp_capacity": b_axes,
        "heads": mdl, "kv_heads": mdl, "head_dim": (),
    }

    # ---------------- caches / states ----------------
    kv_div = bool(cfg.n_kv_heads) and "model" in sizes and \
        cfg.n_kv_heads % sizes["model"] == 0
    cache_rules = {
        "layers": (), "cache_batch": b_axes if not small_batch else (),
        "kv_heads": mdl if kv_div else (),
        "cache_seq": (() if kv_div else mdl) +
                     (b_axes if small_batch else ()),
        "head_dim": (), "kv_lora": (),
        "embed": (), "ffn": mdl, "ffn2": (),
        "heads": mdl, "enc_seq": (), "conv": (),
    }
    soft = frozenset() if mode == "train" else \
        frozenset({"heads", "kv_heads"})
    return ShardingPolicy(mesh=mesh, param_rules=param_rules,
                          act_rules=act_rules, cache_rules=cache_rules,
                          soft_axes=soft)


# ----------------------------------------------------------------------
# cache logical axes (the port's cache tree: a list a group of one
# {"b<i>": ...} dict a layer, with no stacked ``layers`` axis)
# ----------------------------------------------------------------------
def cache_logical_axes(cfg: ModelConfig, cache) -> Any:
    """The cache tree with each tensor leaf replaced by its logical
    axes (the reference's, less the stacked ``layers`` axis); a cache's
    host-int ``length`` stays as it is."""
    from ..models.attention import KVCache, MLACache
    from ..models.rglru import RGLRUState
    from ..models.rwkv6 import RWKVState

    kv = ("cache_batch", "cache_seq", "kv_heads", "head_dim")

    def annotate(node):
        if isinstance(node, KVCache):
            return KVCache(k=kv, v=kv, length=node.length)
        if isinstance(node, MLACache):
            return MLACache(
                c_kv=("cache_batch", "cache_seq", "kv_lora"),
                k_rope=("cache_batch", "cache_seq", "head_dim"),
                length=node.length)
        if isinstance(node, RWKVState):
            return RWKVState(
                tm_last=("cache_batch", "embed"),
                cm_last=("cache_batch", "embed"),
                S=("cache_batch", "heads", "head_dim", "ffn2"))
        if isinstance(node, RGLRUState):
            return RGLRUState(h=("cache_batch", "ffn"),
                              conv=("cache_batch", "conv", "ffn"))
        if isinstance(node, dict):
            return {k: (("cache_batch", "enc_seq", "kv_heads", "head_dim")
                        if k in ("cross_k", "cross_v") else annotate(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [annotate(v) for v in node]
        return node

    return annotate(cache)


def _map_cache(fn, cache, axes):
    """``fn(tensor, axes)`` on every tensor leaf of a cache tree."""
    if isinstance(cache, torch.Tensor):
        return fn(cache, axes)
    if isinstance(cache, dict):
        return {k: _map_cache(fn, v, axes[k]) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_map_cache(fn, c, a) for c, a in zip(cache, axes)]
    if isinstance(cache, tuple):            # the cache NamedTuples
        return type(cache)(*(_map_cache(fn, c, a)
                             for c, a in zip(cache, axes)))
    return cache


def cache_pspecs(policy: ShardingPolicy, cfg: ModelConfig, cache):
    """The cache tree with each tensor leaf replaced by its spec."""
    return _map_cache(lambda t, a: policy.cache_spec(t.shape, a), cache,
                      cache_logical_axes(cfg, cache))


def distribute_cache(policy: ShardingPolicy, cfg: ModelConfig, cache):
    """A full cache tree (the same on every rank) placed by
    :func:`cache_pspecs`."""
    return _map_cache(
        lambda t, a: policy.distribute(t, policy.cache_spec(t.shape, a)),
        cache, cache_logical_axes(cfg, cache))


def layer_specs(spec_tree):
    """A model's ParamSpec tree in the port's layout: each group a list
    of one spec dict a layer, the stacked ``layers`` axis dropped (its
    rule is always unsharded, so each layer's spec is the stacked
    leaf's less that entry)."""
    def drop(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape[1:], s.axes[1:], s.init, s.scale)

    out = dict(spec_tree)
    for key in ("groups", "enc_groups"):
        if key in spec_tree:
            out[key] = [[map_specs(g, drop)
                         for _ in range(_stack_len(g))]
                        for g in spec_tree[key]]
    return out


def _stack_len(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    assert tree.axes[0] == "layers", tree.axes
    return tree.shape[0]


def place_params(policy: ShardingPolicy, spec_tree, params,
                 inplace: bool = False):
    """A ``Transformer``'s parameters as DTensors placed by
    ``param_shardings`` (every rank holds the same full params and keeps
    its own block).  Returns a new module sharing no parameter with
    ``params`` unless ``inplace``, which replaces them in ``params``."""
    from torch import nn

    if not inplace:
        # a structural copy: the new modules, the old parameters
        params = copy.deepcopy(params, memo={id(p): p
                                             for p in params.parameters()})

    def walk(module, specs):
        for name, p in list(module._parameters.items()):
            s = specs[name]
            module._parameters[name] = nn.Parameter(
                policy.distribute(p.data, policy.param_spec(s.shape,
                                                            s.axes)),
                requires_grad=p.requires_grad)
        for name, child in module._modules.items():
            walk(child, specs[int(name)] if isinstance(specs, list)
                 else specs[name])

    walk(params, layer_specs(spec_tree))
    return params


def place_tree(policy: ShardingPolicy, spec_tree, tree):
    """A param tree in ``transformer.param_dict``'s layout (nested dicts,
    each group a list of layers) placed as DTensors by
    ``param_shardings``: the functional API's input.  The dry-run builds
    ``tree`` from empty tensors under ``FakeTensorMode``."""
    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, s)]
        return policy.distribute(t, policy.param_spec(s.shape, s.axes))

    return walk(tree, layer_specs(spec_tree))
