"""Plain PyTorch versions of the port's kernels (the correctness contract).

Each ``ref_*`` is the semantic ground truth of one hand-written CUDA
kernel (``csrc/*.cu``) and a copy of the JAX package's oracle of the
same name.  The ops wrappers send CPU tensors here; ``chip_smoke.py``
holds each kernel against its plain version on the card.

Compound keys are carried as int64 holding 0..2^32-1 (torch's uint32
supports few ops), so sorts and comparisons keep the unsigned order.
"""
from __future__ import annotations

import torch

# bit weight of column j within a word: column 0 is the MSB
_MSB_WEIGHTS = [1 << (31 - j) for j in range(32)]


def ref_lsh_hash(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(N, d) f32 x (d, P) f32 -> (N, P//32) int64 keys in [0, 2^32),
    sign bits packed MSB-first (column p*32+0 is the MSB of word p)."""
    n = x.shape[0]
    proj = x.float() @ a.float()                                 # (N, P)
    bits = (proj >= 0).to(torch.int64).reshape(n, -1, 32)
    w = torch.tensor(_MSB_WEIGHTS, dtype=torch.int64, device=x.device)
    return (bits * w).sum(-1)


def ref_rank_dots(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (Q, C, d) -> (Q, C) f32 inner products of each query with
    its own candidate block."""
    return torch.einsum("qd,qcd->qc", q.float(), x.float())


def ref_pair_dist(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(Q, d) x (N, d) -> (Q, N) f32 squared L2 distances,
    ``max(|q|^2 + |x|^2 - 2 q.x, 0)``."""
    q, x = q.float(), x.float()
    qs = (q * q).sum(-1)[:, None]
    xs = (x * x).sum(-1)[None, :]
    return (qs + xs - 2.0 * (q @ x.T)).clamp_min(0.0)


def ref_gather_rank(q: torch.Tensor, store: torch.Tensor, slots: torch.Tensor,
                    valid: torch.Tensor, metric: str,
                    staging: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, d) f32, (N, d) f32, (Q, C) int, (Q, C) bool -> (Q, C) f32.

    Gather store rows by slot id (clipped; masked rows may carry any
    slot, including duplicates) and exact-rank against each query;
    invalid positions are +inf.  With ``staging`` (M, d), slots
    ``>= store rows`` gather staging row ``slot - n`` instead (the
    tiered-store path).
    """
    q = q.float()
    slots = slots.long()
    n = store.shape[0]
    x = store[slots.clamp(0, n - 1)].float()                     # (Q, C, d)
    if staging is not None:
        xs_ = staging[(slots - n).clamp(0, staging.shape[0] - 1)].float()
        x = torch.where((slots >= n)[..., None], xs_, x)
    if metric == "angular":
        qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        xn = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        d = 1.0 - torch.einsum("qd,qcd->qc", qn, xn)
    else:
        dots = torch.einsum("qd,qcd->qc", q, x)
        qs = (q * q).sum(-1)[:, None]
        xs = (x * x).sum(-1)
        d = (qs + xs - 2.0 * dots).clamp_min(0.0)
    return torch.where(valid.bool(), d, torch.full_like(d, float("inf")))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2^32) (int64), the SWAR popcount of
    the JAX package's uint32 oracle with every step masked to 32 bits."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def ref_hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, W) x (N, W) keys in [0, 2^32) (int64, as ``lsh_hash`` returns
    them) -> (Q, N) int32 total bit differences.  Summed word by word, so
    no (Q, N, W) block is built."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                      device=a.device)
    for w in range(a.shape[1]):
        out += _popcount32(a[:, w, None] ^ b[None, :, w])
    return out.to(torch.int32)
