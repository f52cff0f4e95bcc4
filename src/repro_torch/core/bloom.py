"""Bloom filters over snapshot bucket prefixes (paper §3.2.2), in PyTorch.

Each sealed snapshot carries a bit-packed Bloom filter built from the
indices of its non-empty buckets; queries probe every snapshot's filter
at once before touching the segment arrays.  Filters are packed 32 bits
to a word, LSB first, as uint32 values held in int64.  Every function
takes a leading batch axis (one filter set per LSH table).
"""
from __future__ import annotations

import torch

from .lsh import GOLDEN, MASK32, murmur3_fmix32, u32


def _bit_positions(keys: torch.Tensor, n_hashes: int,
                   bloom_bits: int) -> torch.Tensor:
    """(...,) uint32 keys -> (..., n_hashes) int64 bit positions."""
    seeds = torch.arange(1, n_hashes + 1, device=keys.device)
    mixed = (u32(keys)[..., None] + seeds * GOLDEN) & MASK32
    return murmur3_fmix32(mixed, seed=7) % bloom_bits


def build(keys: torch.Tensor, n_hashes: int, bloom_bits: int,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Build packed filters from (B, N) keys; ``mask`` marks valid rows.
    Returns (B, bloom_bits // 32) words."""
    assert bloom_bits % 32 == 0
    b = keys.shape[0]
    pos = _bit_positions(keys, n_hashes, bloom_bits)          # (B, N, K)
    if mask is not None:
        pos = torch.where(mask[..., None], pos, bloom_bits)   # park OOB
    bits = torch.zeros((b, bloom_bits + 1), dtype=torch.bool,
                       device=keys.device)
    bits.scatter_(1, pos.reshape(b, -1), True)
    words = bits[:, :-1].reshape(b, -1, 32).to(torch.int64)
    w = 1 << torch.arange(32, device=keys.device)
    return (words * w).sum(-1)


def contains(bloom: torch.Tensor, keys: torch.Tensor,
             n_hashes: int) -> torch.Tensor:
    """(W,) filter, (...,) keys -> (...,) bool membership."""
    pos = _bit_positions(keys, n_hashes, bloom.shape[-1] * 32)
    got = (bloom[pos // 32] >> (pos % 32)) & 1
    return (got == 1).all(-1)


def contains_multi(blooms: torch.Tensor, keys: torch.Tensor,
                   n_hashes: int) -> torch.Tensor:
    """Probe S stacked filters per batch row: (B, S, W) x (B, N) ->
    (B, S, N) bool."""
    b, s, w = blooms.shape
    pos = _bit_positions(keys, n_hashes, w * 32)              # (B, N, K)
    n, k = pos.shape[1:]
    word = (pos // 32).reshape(b, 1, n * k).expand(b, s, n * k)
    got = torch.gather(blooms, 2, word).reshape(b, s, n, k)
    got = (got >> (pos % 32)[:, None]) & 1
    return (got == 1).all(-1)
