"""The one traffic generator: a mix file's parameters -> the requests of a
closed loop that submits ``window`` requests, flushes, and submits the
next window.

Every window holds the same number of each kind (the mix's shares of the
window, largest remainders first), in an order drawn from the seed, so
seeds change which keys and vectors a run sees and never how much work
it holds.  Keys and vectors follow the window semantics the engine
serves: a window's writes land in order, and its queries see the state
after them.

A mix file's keys:

- ``window``, ``k``: requests a window; neighbours a query asks for.
- ``mix``: share of ``query`` / ``insert`` / ``delete`` / ``update``.
- ``keys``: how a kind picks its id.  ``issued``: uniform over every id
  issued so far (the prefill's and the inserts'); ``prefill``: uniform
  over the prefill's ids; ``zipf``: YCSB's scrambled zipfian over the
  prefill's ids with constant ``zipf_theta``, the same ids popular on
  every seed.  An insert always takes a
  fresh id.
- ``vectors``: where a write's or a query's vector comes from, before
  noise.  ``random_prefill``: a uniformly drawn prefill row;
  ``key_base``: the key's own prefill row; ``key_current``: the key's
  vector as it stands after the window's writes.
- ``noise``: Gaussian noise a coordinate, in units of the data's
  root-mean-square coordinate (``data.noise_scale``).
- ``self_queries``: share of the queries that are a live id's own
  vector, exactly, drawn uniformly over the live ids.

Window ``w`` is drawn from ``(seed, w)`` and the state the windows before
it left, so its requests are the same however many windows are made, and
a run makes them ``CHUNK`` at a time as it needs them: the rate a run can
reach has no ceiling.
"""
from __future__ import annotations

import numpy as np
import torch

from . import data as data_mod

KINDS = ("query", "insert", "delete", "update")
SCRAMBLE = 0x9E3779B9          # the zipfian ranks' fixed order over the ids
QUERY, INSERT, DELETE, UPDATE = range(4)
CHUNK = 32                     # windows made at a time


def window_counts(mix: dict, window: int) -> np.ndarray:
    """Requests of each kind in one window: the shares of ``window``,
    rounded by largest remainder so they sum to ``window``."""
    share = np.array([mix["mix"].get(k, 0.0) for k in KINDS], float)
    raw = share / share.sum() * window
    counts = np.floor(raw).astype(np.int64)
    left = window - counts.sum()
    counts[np.argsort(-(raw - counts), kind="stable")[:left]] += 1
    return counts


class _Keys:
    """Draws ids for one kind by its ``keys`` rule."""

    def __init__(self, rule: str, n_prefill: int, theta: float):
        self.rule, self.n = rule, n_prefill
        if rule == "zipf":
            w = np.arange(1, n_prefill + 1, dtype=np.float64) ** -theta
            self.cdf = np.cumsum(w) / w.sum()
            # which ids are popular is fixed, as YCSB's scrambled zipfian
            # fixes it by a hash of the rank: seeds draw the requests
            self.scramble = np.random.default_rng(SCRAMBLE).permutation(
                n_prefill)
        elif rule not in ("prefill", "issued"):
            raise ValueError(f"unknown keys rule {rule!r}")

    def draw(self, rng: np.random.Generator, m: int,
             issued: np.ndarray | None = None) -> np.ndarray:
        """``m`` ids; ``issued`` (m,) bounds an ``issued`` draw per row."""
        if self.rule == "prefill":
            return rng.integers(0, self.n, m)
        if self.rule == "issued":
            return np.floor(rng.random(m) * issued).astype(np.int64)
        rank = np.searchsorted(self.cdf, rng.random(m), side="right")
        return self.scramble[np.minimum(rank, self.n - 1)]


class Traffic:
    """The requests of the windows made so far, request ``i`` of window
    ``i // window``: ``kind``, ``key`` (the id a write touches, or a
    self-query's id; else -1), ``row`` (the row of ``table`` holding the
    request's vector; -1 for a delete) and ``self_query``.  ``table``
    (n_prefill + requests, dim) is on the device, its prefill rows the
    base; ``host`` holds the requests' rows on the host."""

    def __init__(self, mix: dict, cfg: dict, base: torch.Tensor, seed: int):
        n = base.shape[0]
        self.window, self.k, self.seed, self.n_prefill = (
            mix["window"], mix["k"], seed, n)
        self.pattern = np.repeat(np.arange(4, dtype=np.int8),
                                 window_counts(mix, self.window))
        keys, theta = mix.get("keys", {}), mix.get("zipf_theta", 0.99)
        self.draw = {k: _Keys(keys.get(KINDS[k], "prefill"), n, theta)
                     for k in (QUERY, DELETE, UPDATE)}
        self.vec_rule = mix.get("vectors", {})
        self.self_share = mix.get("self_queries", 0.0)
        self.noise = mix["noise"] * data_mod.noise_scale(cfg)
        self.row_of = np.arange(n, dtype=np.int64)   # id -> row; -1 dead
        self.issued = n
        self.kind = np.empty(0, np.int8)
        self.key = np.empty(0, np.int64)
        self.row = np.empty(0, np.int64)
        self.self_query = np.empty(0, bool)
        self.table = base
        self.host = np.empty((0, base.shape[1]), np.float32)

    @property
    def n_windows(self) -> int:
        return len(self.kind) // self.window

    def _plan(self, w: int):
        """Window ``w``'s kinds, keys, source rows (the row a vector is
        copied from) and self-queries, with the state after it; and the
        seed of its noise."""
        W, n = self.window, self.n_prefill
        rng = np.random.default_rng([self.seed, w])
        noise_seed = int(rng.integers(0, 2**63))
        if self.row_of.size < self.issued + W:
            self.row_of = np.concatenate([self.row_of, np.full(
                max(self.row_of.size, W), -1, np.int64)])
        row_of = self.row_of
        kd = rng.permutation(self.pattern)
        wk = np.full(W, -1, np.int64)
        ins = kd == INSERT
        before = self.issued + np.cumsum(ins) - ins   # ids issued before row
        wk[ins] = before[ins]
        self.issued += int(ins.sum())
        for kk in (DELETE, UPDATE):
            m = kd == kk
            wk[m] = self.draw[kk].draw(rng, int(m.sum()), before[m])
        rows = n + w * W + np.arange(W)
        src = np.full(W, -1, np.int64)
        for kk in (INSERT, UPDATE):
            m = kd == kk
            rule = self.vec_rule.get(KINDS[kk], "random_prefill")
            src[m] = (wk[m] if rule == "key_base"
                      else rng.integers(0, n, int(m.sum())))
        # the window's writes land in order: the last write of an id wins
        wr = np.flatnonzero(kd != QUERY)[::-1]
        _, first = np.unique(wk[wr], return_index=True)
        last = wr[first]
        row_of[wk[last]] = np.where(kd[last] == DELETE, -1, rows[last])
        # then its queries see that state
        q = np.flatnonzero(kd == QUERY)
        is_self = rng.random(q.size) < self.self_share
        self_q = np.zeros(W, bool)
        if is_self.any():
            live = np.flatnonzero(row_of[:self.issued] >= 0)
            pick = live[rng.integers(0, live.size, int(is_self.sum()))]
            src[q[is_self]] = row_of[pick]
            wk[q[is_self]] = pick
            self_q[q[is_self]] = True
        rest = q[~is_self]
        if self.vec_rule.get("query", "random_prefill") == "key_current":
            qk = self.draw[QUERY].draw(rng, rest.size)
            cur = row_of[qk]
            src[rest] = np.where(cur >= 0, cur, qk)
        else:
            src[rest] = rng.integers(0, n, rest.size)
        return kd, wk, src, self_q, noise_seed

    def extend(self, m: int) -> "Traffic":
        """Makes the next ``m`` windows."""
        W, w0 = self.window, self.n_windows
        plans = [self._plan(w) for w in range(w0, w0 + m)]
        kind, key, src, self_q = (np.concatenate([p[i] for p in plans])
                                  for i in range(4))
        dev, dim = self.table.device, self.table.shape[1]
        noise = torch.cat([torch.randn(
            (W, dim), generator=torch.Generator(device=dev).manual_seed(p[4]),
            device=dev) for p in plans])
        noise *= self.noise
        noise[torch.as_tensor(self_q, device=dev)] = 0.0
        start = self.table.shape[0]
        table = torch.cat([self.table, torch.zeros(
            (m * W, dim), dtype=self.table.dtype, device=dev)])
        src_d = torch.as_tensor(src, device=dev)
        # writes copy prefill rows, queries any row: the writes go first
        for sel in (kind != QUERY, kind == QUERY):
            at = torch.as_tensor(np.flatnonzero(sel & (kind != DELETE)),
                                 device=dev)
            table[start + at] = table[src_d[at]] + noise[at]
        self.table = table
        self.host = np.concatenate([self.host, table[start:].cpu().numpy()])
        self.kind = np.concatenate([self.kind, kind])
        self.key = np.concatenate([self.key, key])
        self.row = np.concatenate([self.row, np.where(
            kind == DELETE, -1, start + np.arange(m * W))])
        self.self_query = np.concatenate([self.self_query, self_q])
        return self

