"""Memory-lean membership test shared across the read/write paths.

``isin`` by broadcast materialises an (n, m) compare; the tombstone
buffer, the ring id set and a delete batch reach 10^5..10^6 rows, so
every membership test goes through sort + searchsorted instead, in
O(n + m) memory.
"""
from __future__ import annotations

import torch


def member_sorted(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``isin(x, table)`` in O(n + m) memory: a bool tensor shaped like
    ``x`` marking elements present in ``table`` (any shape, flattened).
    A zero-size table matches nothing."""
    t = table.reshape(-1)
    if t.shape[0] == 0:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    t = torch.sort(t.to(x.dtype)).values
    pos = torch.searchsorted(t, x.contiguous()).clamp(0, t.shape[0] - 1)
    return t[pos] == x
