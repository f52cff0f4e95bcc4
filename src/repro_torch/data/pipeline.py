"""Data pipelines: deterministic, shardable, skip-ahead-able (numpy only).

The port's copy of the JAX package's ``data/pipeline.py`` generators.
``SyntheticLM`` generates a structured token stream (a noisy Markov
chain over the vocab).  Batches are a pure function of (seed, step), so
each data shard slices its rows of the global batch, a restart from step
k replays the exact stream, and a host that falls behind can skip ahead
without coordination.

``VectorStream`` generates clustered unit vectors for PFO workloads
(insert/query streams with planted near-neighbor structure).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 3           # markov-ish structure strength

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Rows [shard::n_shards] of the global batch for ``step``."""
        rows = self.global_batch // n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        base = rng.integers(0, self.vocab_size,
                            (rows, self.seq_len + 1), dtype=np.int64)
        # structure: token_t depends on token_{t-1} (copy with offset)
        for t in range(1, self.seq_len + 1):
            copy = rng.random(rows) < 0.7
            base[copy, t] = (base[copy, t - 1] * 7 + 13) % self.vocab_size
        return {
            "tokens": base[:, :-1].astype(np.int32),
            "labels": base[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass
class VectorStream:
    dim: int
    n_clusters: int = 32
    seed: int = 0
    noise: float = 0.15

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        c = rng.normal(size=(self.n_clusters, self.dim))
        self.centers = (c / np.linalg.norm(c, axis=1, keepdims=True)
                        ).astype(np.float32)

    def batch(self, step: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (ids, vectors): clustered unit vectors."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 1, step]))
        which = rng.integers(0, self.n_clusters, n)
        v = self.centers[which] + \
            rng.normal(size=(n, self.dim)).astype(np.float32) * self.noise
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        ids = (np.arange(n) + step * n).astype(np.int32)
        return ids, v

    def queries(self, step: int, n: int) -> np.ndarray:
        _, v = self.batch(step + 10_000, n)
        return v


def make_batch_specs(cfg, shape_name: str) -> dict:
    """The (shape, dtype) stand-ins of a dry-run cell's batch
    (``configs.shapes.input_specs``)."""
    from ..configs import input_specs
    return input_specs(cfg, shape_name)
