"""Locality-sensitive hashing primitives (paper §2.1, §4.1), in PyTorch.

Sign-random-projection (SRP) LSH for angular distance: a compound key of
``M`` bits is ``sign(a_i . x)`` packed MSB-first, one key per LSH table.
The partition level of PHF re-hashes the compound key with ``C`` further
SRP functions over the key's +-1 bit vector; MurmurHash3's 32-bit
finalizer is the MainTable's exact hash (paper §3.1).

uint32 keys are carried as int64 holding 0..2^32-1, so sorts, searches
and comparisons keep the unsigned order; every shift, add and multiply
is masked back to 32 bits.  Results equal the JAX package's bit for bit.
"""
from __future__ import annotations

import torch

from .config import PFOConfig

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret integers as uint32 values held in int64 (negative
    int32 ids wrap to 2^32 + id, as ``astype(uint32)`` does)."""
    return x.to(torch.int64) & MASK32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for a in [0, 2^32), split into 16-bit halves of
    ``c`` so no partial product overflows int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


# ----------------------------------------------------------------------
# bit helpers — keys are read MSB-first so LLCP (Def. 2) is a prefix.
# ----------------------------------------------------------------------
def key_bits(h: torch.Tensor, start, width: int) -> torch.Tensor:
    """Extract ``width`` bits of ``h`` starting ``start`` bits from the
    MSB (``start`` may be a tensor broadcasting against ``h``)."""
    shift = 32 - start - width
    return (u32(h) >> shift) & ((1 << width) - 1)


def llcp_int(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Longest common prefix of two uint32 keys (Def. 2): the leading
    zeros of ``a ^ b``, 32 where they are equal."""
    x = u32(a) ^ u32(b)
    clz = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    done = x == 0
    clz = torch.where(done, 32, clz)
    for sh, w in ((16, 0xFFFF0000), (8, 0xFF000000), (4, 0xF0000000),
                  (2, 0xC0000000), (1, 0x80000000)):
        hi = ~done & ((x & w) == 0)
        clz = clz + torch.where(hi, sh, 0)
        x = torch.where(hi, (x << sh) & MASK32, x)
    return clz


# ----------------------------------------------------------------------
# murmur3 finalizer (fmix32) — MainTable exact hash (paper §3.1).
# ----------------------------------------------------------------------
def murmur3_fmix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    h = u32(x) ^ ((seed * GOLDEN) & MASK32)
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def make_projections(cfg: PFOConfig, generator: torch.Generator,
                     device=None) -> dict:
    """Random SRP parameters for all L tables + the partition level:
    ``table_proj`` (d, L*M) f32 and ``part_proj`` (L, M, C) f32, drawn
    from ``generator`` (CPU draws, so a seed gives the same projections
    on every device)."""
    table = torch.randn((cfg.dim, cfg.L * cfg.M), generator=generator)
    part = torch.randn((cfg.L, cfg.M, cfg.C), generator=generator)
    return {"table_proj": table.to(device), "part_proj": part.to(device)}


def pack_bits_msb(bits: torch.Tensor) -> torch.Tensor:
    """Pack (..., 32) {0,1} into uint32 values (int64), bit 0 -> MSB."""
    w = torch.tensor([1 << (31 - j) for j in range(32)], dtype=torch.int64,
                     device=bits.device)
    return (bits.to(torch.int64) * w).sum(-1)


def unpack_bits_msb(h: torch.Tensor, width: int = 32) -> torch.Tensor:
    """uint32 -> (..., width) {0,1} int64, MSB first."""
    shifts = torch.arange(width - 1, -1, -1, device=h.device)
    return (u32(h)[..., None] >> shifts) & 1


def hash_vectors(x: torch.Tensor, table_proj: torch.Tensor,
                 M: int) -> torch.Tensor:
    """Compound keys for all tables: (N, d) -> (N, L) uint32 (int64)."""
    n = x.shape[0]
    bits = (x.float() @ table_proj >= 0).reshape(n, -1, M)
    return pack_bits_msb(bits)


def partition_ids(h: torch.Tensor, part_proj: torch.Tensor,
                  cfg: PFOConfig) -> torch.Tensor:
    """Partition-level re-hash (paper §4.1): C SRP bits over the key bits.

    h: (N, L) keys -> (N, L) int64 partition ids in [0, 2^C).
    """
    if cfg.C == 0:
        return torch.zeros(h.shape, dtype=torch.int64, device=h.device)
    bits = unpack_bits_msb(h, cfg.M).float() * 2.0 - 1.0          # (N,L,M)
    proj = torch.einsum("nlm,lmc->nlc", bits, part_proj)           # (N,L,C)
    w = 1 << torch.arange(cfg.C - 1, -1, -1, device=h.device)
    return ((proj >= 0).to(torch.int64) * w).sum(-1)


def region_ids(h: torch.Tensor, part_proj: torch.Tensor,
               cfg: PFOConfig) -> torch.Tensor:
    """Global region (hash tree) id in [0, 2^(C+m)): partition<<m | tree,
    the tree being the key's first m bits (§4.1)."""
    pid = partition_ids(h, part_proj, cfg)
    return (pid << cfg.m) | key_bits(h, 0, cfg.m)


def main_table_keys(ids: torch.Tensor, cfg: PFOConfig):
    """MainTable: murmur key + tree id from its first main_m bits (§4.1)."""
    h = murmur3_fmix32(ids)
    return h, key_bits(h, 0, cfg.main_m)
