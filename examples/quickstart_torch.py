"""Quickstart: PFO as a standalone online ANN index, on the PyTorch port.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``: the same config,
sizes, steps and printed lines.  It runs on CUDA unless ``--device``
names another device (``--device cpu`` runs the kernels' plain
versions); without a card and without ``--device`` it stops with an
error.  The index draws its SRP projections from a ``torch.Generator``
seeded 0 where the JAX script draws them with ``jax.random``, so the
ids and distances printed here differ from the JAX script's;
``run(proj=...)`` takes a JAX index's projections
(``repro_torch.convert.proj_from_numpy``) and then answers as it does.
"""
import argparse

import numpy as np

from repro_torch.core import PFOConfig, PFOIndex

N, BATCH, QUERIES = 5000, 1000, 5


def config() -> PFOConfig:
    return PFOConfig(
        dim=64,        # vector dimensionality
        L=6,           # LSH tables (more => better recall)
        C=2, m=2,      # 2^(C+m) = 16 parallel hash trees per table
        l=32, t=4,     # directory width / bucket-spread threshold (§5.1)
        store_capacity=32768,
    )


def run(device=None, *, proj=None, n: int = N, batch: int = BATCH) -> dict:
    """The quickstart on ``device`` (CUDA when None); returns what it
    prints: dispatch rounds per insert call, the index stats, and the
    (ids, dists) of the queries, of the query after the update and of
    the query after the delete."""
    rng = np.random.default_rng(0)
    cfg = config()
    index = PFOIndex(cfg, seed=0, device=device, proj=proj)

    # --- online inserts (batched; rounds == actor-mailbox dispatch) ---
    vecs = rng.normal(size=(n, cfg.dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    rounds = []
    for s in range(0, n, batch):
        rounds.append(index.insert(np.arange(s, s + batch, dtype=np.int32),
                                   vecs[s:s + batch]))
        print(f"inserted [{s}, {s + batch}) in {rounds[-1]} dispatch "
              "round(s)")
    stats = index.stats()
    print("stats:", stats)

    # --- queries -------------------------------------------------------
    queries = vecs[:QUERIES] + rng.normal(
        size=(QUERIES, cfg.dim)).astype(np.float32) * .02
    ids, dists = index.query(queries, k=5)
    for i in range(QUERIES):
        print(f"q{i}: ids={ids[i].tolist()} d0={dists[i, 0]:.4f}")
    assert (ids[:, 0] == np.arange(QUERIES)).all(), \
        "nearest neighbor is itself"

    # --- online update (paper §5: new version written, old reclaimed) --
    index.update(np.array([0], np.int32), -vecs[:1])
    ids2, d2 = index.query(-vecs[:1], k=3)
    print("after update, query(-v0):", ids2[0].tolist(), "d0=%.4f" % d2[0, 0])
    assert ids2[0, 0] == 0

    # --- delete ----------------------------------------------------------
    index.delete(np.array([1, 2], np.int32))
    ids3, d3 = index.query(vecs[1:3], k=3)
    assert not np.isin([1, 2], ids3).any()
    print("deleted ids 1,2 -> no longer returned.")

    # --- observability ---------------------------------------------------
    # every PFOIndex carries an Obs handle: op latency histograms
    # (p50/p90/p99), maintenance-epoch timings and readback counters
    # accrue automatically; obs.format() renders the snapshot as a table
    print()
    print(index.obs.format(title="quickstart metrics"))
    print("done.")
    return dict(rounds=rounds, stats=stats, query=(ids, dists),
                after_update=(ids2, d2), after_delete=(ids3, d3))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
