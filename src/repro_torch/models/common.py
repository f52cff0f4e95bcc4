"""Shared model machinery: config IR, declarative params, norms, rope.

The port's copy of the JAX package's ``models/common.py``.  A model is
a list of *block groups* ``(pattern, repeat)``, where the pattern is a
short tuple of BlockDefs.  Params are *declared* (shape + logical axes
+ initializer) by :class:`ParamSpec` trees whose group leaves carry a
leading ``layers`` axis, as the reference stacks them; the port's
module (``transformer.Transformer``) unstacks that axis into one module
a layer.

Numerics follow the reference step by step (dtypes included): norms and
rope compute in float32 and cast back, ``gelu`` is the tanh form
(``jax.nn.gelu``'s default).  In a 16-bit float on the CPU, ``sigmoid``,
``silu`` and ``gelu`` spell out the op sequence XLA lowers ``jax.nn``'s
to, each op rounded to the dtype, and so give the reference's bits (the
tests hold them so); in float32, and on the card, they are PyTorch's
fused ops, one kernel each, rounded once.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


# ----------------------------------------------------------------------
# block/config IR
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockDef:
    kind: str = "attn"        # "attn" | "mla" | "rwkv" | "rglru"
    attn_impl: str = "full"   # "full" | "local" | "chunked"
    rope: str = "rope"        # "rope" | "nope"
    window: int = 0           # local window / chunk size
    moe: bool = False
    cross_attn: bool = False  # enc-dec decoder blocks


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "decoder"        # "decoder" | "encdec"
    n_layers: int = 2              # informational; groups are canonical
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    vocab_size: int = 1024
    groups: tuple = ()             # ((BlockDef,...), repeat) tuples
    enc_groups: tuple = ()         # encoder stack for enc-dec
    act: str = "silu"              # "silu" | "gelu" | "relu2" | "geglu"
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gspmd"        # "gspmd" | "shardmap"
    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # RG-LRU
    lru_width: int = 0
    conv_width: int = 4
    # frontend stub
    frontend: str | None = None    # None | "patch" | "audio"
    frontend_len: int = 0          # stub sequence length
    enc_len: int = 0               # encoder length for enc-dec
    # numerics
    dtype: torch.dtype = torch.bfloat16   # compute/weight dtype
    norm_eps: float = 1e-6

    @property
    def q_features(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_features(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_count(self) -> int:
        n = sum(len(p) * r for p, r in self.groups)
        n += sum(len(p) * r for p, r in self.enc_groups)
        return n


# ----------------------------------------------------------------------
# declarative params
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                    # logical axis names (len == ndim)
    init: str = "normal"           # "normal" | "zeros" | "ones"
    scale: float = 1.0             # stddev multiplier for "normal"


def _fan_in(shape: tuple) -> int:
    # contraction dim heuristics: last-but-one for matrices
    if len(shape) >= 2:
        return shape[-2]
    return max(shape[0], 1)


def map_specs(tree, fn):
    """``fn`` applied to every ParamSpec of a nested dict/list tree, in
    sorted key order (the order ``jax.tree`` flattens a dict in)."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(tree[k], fn) for k in sorted(tree)}
    return [map_specs(v, fn) for v in tree]


def init_params(spec_tree, generator: torch.Generator,
                dtype: torch.dtype) -> dict:
    """Real tensors for a spec tree, drawn on the generator's device:
    normal leaves are float32 draws times ``scale / sqrt(fan_in)`` (fan_in
    the second-to-last dimension), cast to ``dtype``."""
    dev = generator.device

    def one(s: ParamSpec) -> torch.Tensor:
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=dev)
        std = s.scale / (_fan_in(s.shape) ** 0.5)
        return (torch.randn(s.shape, generator=generator,
                            dtype=torch.float32, device=dev) * std).to(dtype)

    return map_specs(spec_tree, one)


# ----------------------------------------------------------------------
# numerics
# ----------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


class _Sigmoid16(torch.autograd.Function):
    """``jax.nn.sigmoid`` in a 16-bit float: XLA lowers it to
    1 / (1 + exp(-x)), each op rounded to the dtype; the gradient is
    the analytic s (1 - s), as the reference's (no inf * 0 where
    exp(-x) overflows)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return 1 / (1 + torch.exp(-x))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x.float())
        return (g.float() * s * (1 - s)).to(x.dtype)


def _jax_bits(x: torch.Tensor) -> bool:
    """Spell out ``jax.nn``'s 16-bit op sequence: a bfloat16 / float16
    tensor on the CPU.  On the card the fused kernel stands (bit parity
    with the reference buys nothing there, and the sequence costs 3-8
    launches a call on host-bound paths)."""
    return x.dtype in (torch.bfloat16, torch.float16) and not x.is_cuda


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: in bfloat16 / float16 on the CPU its bits (see
    :class:`_Sigmoid16`), else ``torch.sigmoid``."""
    return _Sigmoid16.apply(x) if _jax_bits(x) else torch.sigmoid(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, x * sigmoid(x): in a 16-bit float on the CPU its
    bits."""
    return x * sigmoid(x) if _jax_bits(x) else F.silu(x)


_GELU_C = (2 / math.pi) ** 0.5


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form): in a 16-bit float on the CPU its
    bits, op by op as XLA rounds them, with the constants rounded to the
    dtype."""
    if not _jax_bits(x):
        return F.gelu(x, approximate="tanh")
    c1 = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    c2 = torch.tensor(_GELU_C, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * ((x * x) * x)))))


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def activation(name: str):
    if name == "silu":
        return silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":
        return _relu2
    raise ValueError(name)


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (...,) -> cos/sin (..., head_dim//2), float32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D); cos/sin (..., T, D//2) broadcast over heads."""
    half = x.shape[-1] // 2
    c = cos[..., None, :]
    s = sin[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s],
                     dim=-1).to(x.dtype)


def _split_contraction(x, w):
    """``x`` laid out for the product with ``w``: replicated on its last
    dim where ``w``'s contraction dim is sharded, it is split there (a
    local slice, no collective: the row-parallel product).  DTensor's own
    choice for a replicated ``x`` views a non-contiguous local block
    whose backward fails."""
    from torch.distributed.tensor import Replicate, Shard
    # a split of an inner dim (the sequence, after attention over a
    # sequence-sharded cache) is gathered: the product flattens (B, T),
    # and DTensor's strided layout for that reads values back (it fails
    # on fake tensors)
    pl = [Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1 else p
          for p in x.placements]
    for i, p in enumerate(w.placements):
        if p.is_shard(0) and isinstance(pl[i], Replicate):
            pl[i] = Shard(x.ndim - 1)
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def reshape(t: torch.Tensor, *shape) -> torch.Tensor:
    """``t.reshape(shape)``.  On a DTensor, a reshaped dim stays sharded
    only where the view keeps its blocks whole (the first reshaped dim,
    its new size a multiple of the shard count); any other sharded dim
    among those the view moves is gathered first, a pending sum is
    reduced, the rest keep their placements: GSPMD reshards there too
    (heads that do not divide the mesh axis).  DTensor's own view rule
    would otherwise raise or build a strided layout whose backward fails
    and whose sharding rules read values back."""
    if not hasattr(t, "device_mesh"):
        return t.reshape(shape)
    from torch.distributed.tensor import Replicate
    old = tuple(t.shape)
    pre = 0
    while pre < min(len(old), len(shape)) and old[pre] == shape[pre]:
        pre += 1
    suf = 0
    while suf < min(len(old), len(shape)) - pre and \
            old[-1 - suf] == shape[-1 - suf]:
        suf += 1
    moved = range(pre, len(old) - suf)
    mesh, pl = t.device_mesh, list(t.placements)
    n = math.prod(mesh.size(i) for i, p in enumerate(pl)
                  if p.is_shard() and p.dim == pre)
    keep = pre < len(shape) and shape[pre] % n == 0
    # a pending sum (Partial) is reduced first: DTensor would turn it
    # into a strided split of the merged dim, which reads values back
    new = [Replicate() if p.is_partial() or (p.is_shard() and p.dim in moved
                                             and not (p.dim == pre and keep))
           else p for p in pl]
    if new != pl:
        t = t.redistribute(mesh, new)
    return t.reshape(shape)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    if hasattr(w, "device_mesh") and hasattr(x, "device_mesh"):
        x = _split_contraction(x, w)
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y
