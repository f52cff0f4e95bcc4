"""Per-device cost of one step, read off the ops it dispatches.

The counterpart of the JAX package's ``analysis/hlo.py`` (``analyze_hlo``
parses the optimized HLO).  :func:`analyze_step` runs a step under a
``TorchDispatchMode`` that sees every aten op a device runs: where an
op's arguments are DTensors the mode steps aside (returns
``NotImplemented``), DTensor turns the op into its local ops and
collectives, and those come back through the mode on local tensors.  So
every number is per device, as the reference's post-SPMD shapes are:

  * ``flops``: the products' FLOPs, by ``torch.utils.flop_counter``'s
    formulas (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the attention and
    convolution ops; ``einsum`` and ``matmul`` arrive decomposed into
    them), 2 * output * contracted extent as the reference counts a dot;
  * ``bytes_accessed``: the bytes in and out of every op that is not a
    view, with no fusion: an upper bound on the memory traffic (eager
    PyTorch runs each op as its own kernel, and a fused backend would
    keep elementwise chains on chip);
  * ``collective_bytes``: the output bytes of each collective, by kind
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``),
    read from the functional collectives DTensor issues
    (``_c10d_functional``) and from the c10d ops a module calls itself;
  * ``peak_bytes``: the most bytes that the step's own outputs (not
    views, not in-place results) held alive at once, plus its arguments.

An eager step has no ``while`` loops, so the reference's ``while_trips``
(the trip counts it multiplies loop bodies by) has no counterpart: a
Python loop over layers or chunks dispatches every trip's ops, and they
are all counted.  ``HloStats`` has no other field.  Under
``FakeTensorMode`` (the dry-run) nothing is allocated and the counts are
the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = {
    # functional collectives (what DTensor issues)
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    # c10d ops (in place: the payload is the first argument)
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}


@dataclasses.dataclass
class StepStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    peak_bytes: int = 0

    @property
    def collective_total(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": dict(self.collective_bytes),
                "collective_total": self.collective_total,
                "peak_bytes": self.peak_bytes}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _CostMode(TorchDispatchMode):
    def __init__(self, stats: StepStats, live0: int):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self.stats, self.dtensor, self.flops = stats, DTensor, flop_registry
        self.paused = 0
        self.live = live0
        stats.peak_bytes = live0

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented       # let DTensor desugar to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        ins = _tensors((args, kwargs))
        packet = func._overloadpacket
        st = self.stats
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:      # c10d ops write their first argument
                payload = out if func.namespace == "_c10d_functional" \
                    else args[0]
                st.collective_bytes[kind] += sum(_nbytes(t)
                                                 for t in _tensors(payload))
            return out
        if packet in self.flops:
            st.flops += float(self.flops[packet](*args, **kwargs,
                                                 out_val=out))
        if func.is_view:
            return out
        outs = _tensors(out)
        st.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        fresh = [t for t in outs if all(t is not a for a in ins)]
        for t in fresh:
            n = _nbytes(t)
            self.live += n
            weakref.finalize(t, self._freed, n)
        st.peak_bytes = max(st.peak_bytes, self.live)
        return out


def local_bytes(tree) -> int:
    """Bytes a device holds of a tree's tensors (a DTensor's local
    block)."""
    total = 0
    for t in _tensors(tree):
        t = t.to_local() if hasattr(t, "to_local") else t
        total += _nbytes(t)
    return total


@contextlib.contextmanager
def _uncounted_propagation(mode: _CostMode):
    """DTensor's sharding propagation runs each new op once on fake
    global-shape tensors to learn its output's shape: no device runs
    that, so the mode counts nothing while it does."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if hasattr(ShardingPropagator, n)), None)
    if name is None:
        yield
        return
    real = getattr(ShardingPropagator, name)

    def quiet(*a, **kw):
        mode.paused += 1
        try:
            return real(*a, **kw)
        finally:
            mode.paused -= 1

    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, real)


def analyze_step(step, *args, **kwargs) -> tuple:
    """Run ``step(*args, **kwargs)`` once under the cost mode; returns
    ``(step's result, StepStats)`` for this device."""
    stats = StepStats()
    mode = _CostMode(stats, local_bytes((args, kwargs)))
    with _uncounted_propagation(mode), mode:
        out = step(*args, **kwargs)
    return out, stats
