"""The plain reference of a stream of windows, and the comparison that
decides ``correct``.

The reference replays each window's writes in order (the last write of
an id wins: a delete makes it dead, an insert or update makes the row
the request names its current version), then answers the window's
queries exactly: the k nearest live ids at their current versions, by a
float32 product with TF32 off.  It reads the request table the benchmark
made from the seed and nothing the program made; the program's answers
are read only to be judged.

It imports torch and numpy alone.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

QUERY, INSERT, DELETE, UPDATE = range(4)
CHUNK = 1024                     # query rows a product block


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32 (TF32 off) inside the block."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest): the operands
    a TF32 tensor-core product sees.  Used by the control alone."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Replay:
    """Id -> row of its current version in ``table`` (``row_of``; -1: dead
    or never issued) and of its last written version (``last_of``; dead
    ids too), on the table's device, advanced one window at a time.
    Angular distance (1 - cosine), the one metric a configuration states
    so far."""

    def __init__(self, table: torch.Tensor, n_prefill: int, n_ids: int,
                 metric: str):
        if metric != "angular":
            raise ValueError(f"no reference for metric {metric!r} yet")
        self.table = table
        self.dev = table.device
        self.row_of = torch.full((n_ids,), -1, dtype=torch.int64,
                                 device=self.dev)
        self.row_of[:n_prefill] = torch.arange(n_prefill, device=self.dev)
        self.last_of = self.row_of.clone()

    def apply(self, kind: np.ndarray, key: np.ndarray,
              row: np.ndarray) -> None:
        """One window's writes, in order."""
        wr = np.flatnonzero(kind != QUERY)[::-1]
        if wr.size == 0:
            return
        _, first = np.unique(key[wr], return_index=True)
        last = wr[first]
        new = np.where(kind[last] == DELETE, -1, row[last])
        self.row_of[torch.as_tensor(key[last], device=self.dev)] = \
            torch.as_tensor(new, device=self.dev)
        wrote = new >= 0
        self.last_of[torch.as_tensor(key[last][wrote], device=self.dev)] = \
            torch.as_tensor(new[wrote], device=self.dev)

    def live(self):
        """(ids, rows) of the live ids, ascending by id."""
        ids = torch.nonzero(self.row_of >= 0).squeeze(1)
        return ids, self.row_of[ids]

    def knn(self, q_rows: np.ndarray, k: int, tf32: bool = False):
        """The exact k nearest live ids of each query row, ascending by
        distance: host (ids (Q, k) int64, dists (Q, k) float32).  With
        ``tf32`` the product's operands are rounded to TF32 first (the
        control)."""
        ids, rows = self.live()
        x = self.table[rows]
        x = x / x.norm(dim=1, keepdim=True)
        if tf32:
            x = round_tf32(x)
        out_i, out_d = [], []
        qr = torch.as_tensor(q_rows, device=self.dev)
        with no_tf32():
            for s in range(0, qr.numel(), CHUNK):
                q = self.table[qr[s:s + CHUNK]]
                q = q / q.norm(dim=1, keepdim=True)
                d = 1.0 - (round_tf32(q) if tf32 else q) @ x.t()
                neg, at = torch.topk(-d, min(k, ids.numel()), dim=1)
                out_i.append(ids[at].cpu().numpy())
                out_d.append((-neg).cpu().numpy())
        return np.concatenate(out_i), np.concatenate(out_d)

    def judge(self, q_rows: np.ndarray, self_keys: np.ndarray,
              ids: np.ndarray, dists: np.ndarray, truth: np.ndarray | None):
        """The window's answers against this state.  ``ids`` (Q, k) with -1
        past the answered ones, ``dists`` (Q, k) with +inf there;
        ``self_keys`` (Q,) the id a self-query copies (else -1).  Returns
        the window's counts: ``malformed`` answers (holes, a repeated id,
        a finite distance without an id or the reverse, distances out of
        order), ``dead`` ids (not live, or live at another version: the
        distance says which), the largest ``dist_gap`` between a reported
        distance and the exact one to the id's current version,
        ``self_missing`` self-queries whose answer lacks their own id
        though the ranking budget cannot have cut it (the answer is not
        full, or holds a larger id: the budget keeps the smallest ids),
        and the sum of ``hits`` against ``truth`` (the exact
        neighbours); ``self_absent`` counts every self-query without its
        id, the budget's cuts too."""
        dev = self.dev
        n = len(q_rows)
        valid = ids >= 0
        finite = np.isfinite(dists)
        holes = (np.diff(valid.astype(np.int8), axis=1) > 0).any(1)
        srt = np.sort(np.where(valid, ids, -1 - np.arange(ids.shape[1])),
                      axis=1)
        dup = (np.diff(srt, axis=1) == 0).any(1)
        dd = np.where(finite, dists, np.finfo(np.float32).max)
        order = (np.diff(dd, axis=1) < 0).any(1)
        malformed = holes | dup | (valid != finite).any(1) | order

        idd = torch.as_tensor(np.where(valid, ids, 0), device=dev)
        v = torch.as_tensor(valid, device=dev)
        in_range = idd < self.row_of.numel()
        rows = torch.where(in_range, self.row_of[idd.clamp_max(
            self.row_of.numel() - 1)], -1)
        dead = v & (rows < 0)
        ok = v & ~dead
        q = self.table[torch.as_tensor(q_rows, device=dev)].double()
        x = self.table[rows.clamp_min(0)].double()                # (Q, k, d)
        qn = q / q.norm(dim=1, keepdim=True)
        xn = x / x.norm(dim=2, keepdim=True)
        true = 1.0 - torch.einsum("qd,qkd->qk", qn, xn)
        got = torch.as_tensor(np.where(valid, dists, 0.0), device=dev)
        gap = torch.where(ok, (got.double() - true).abs(), 0.0)
        sk = self_keys[:, None]
        absent = (self_keys >= 0) & ~(valid & (ids == sk)).any(1)
        missing = absent & (~valid.all(1) | (valid & (ids > sk)).any(1))
        hits = 0
        if truth is not None:
            t = torch.as_tensor(truth, device=dev)
            hits = int(((idd[:, :, None] == t[:, None, :]).any(2)
                        & v).sum())
        return dict(malformed=int(malformed.sum()), dead=int(dead.sum()),
                    dist_gap=float(gap.max()) if n else 0.0,
                    self_missing=int(missing.sum()),
                    self_absent=int(absent.sum()), hits=hits)
