"""Streaming recommendation (paper §2.2) on the PyTorch port: a live,
*interleaved* stream of user-history updates and similar-user queries
served through the StreamEngine — the online query+update workload PFO
exists for.

Each epoch interleaves writes (new/updated user vectors) with reads
(recommendation queries) in one request stream; the engine coalesces
them into size-bucketed micro-batches with device-resident rounds and
runs seal/merge epochs as explicit events.  Recall@10 vs brute force is
tracked as the store grows, demonstrating realtime visibility of new
data (no pause-to-update, unlike PLSH).

    PYTHONPATH=src python examples/streaming_recsys_torch.py [--device cpu]

The port's counterpart of ``examples/streaming_recsys.py``: the same
config, sizes, stream and printed lines.  It runs on CUDA unless
``--device`` names another device (``--device cpu`` runs the kernels'
plain versions); without a card and without ``--device`` it stops with
an error.  Every vector inserted so far stays on the device for the
brute-force oracle.  The index draws its SRP projections from a
``torch.Generator`` seeded 0 where the JAX script draws them with
``jax.random``, so the numbers printed here differ from the JAX
script's; ``run(proj=...)`` takes a JAX index's projections
(``repro_torch.convert.proj_from_numpy``) and then answers as it does.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import PFOConfig, PFOIndex
from repro_torch.core.device import default_device
from repro_torch.data import VectorStream
from repro_torch.kernels import ops
from repro_torch.serving import StreamConfig, StreamEngine

DIM, EPOCHS, BATCH, QUERIES = 64, 8, 800, 32


def config(dim: int = DIM) -> PFOConfig:
    return PFOConfig(dim=dim, L=6, C=2, m=2, l=32, t=4,
                     max_leaves_per_tree=512, store_capacity=1 << 16,
                     max_candidates_total=256)


def run(device=None, *, proj=None, epochs: int = EPOCHS, batch: int = BATCH,
        queries: int = QUERIES) -> list:
    """The stream on ``device`` (CUDA when None); returns one dict an
    epoch with what it prints and each query's answer (``ids``,
    ``dists``) and brute-force ids (``oracle``)."""
    device = default_device(device)
    engine = StreamEngine(PFOIndex(config(), seed=0, device=device,
                                   proj=proj),
                          StreamConfig(max_batch=256, default_k=10))
    engine.warmup()
    stream = VectorStream(dim=DIM, n_clusters=24, seed=1)

    all_ids = np.zeros((0,), np.int32)
    # the oracle's store grows on the device: each epoch copies only
    # its own batch in
    all_vecs = torch.empty((epochs * batch, DIM), dtype=torch.float32,
                           device=device)
    out = []
    for epoch in range(epochs):
        ids, vecs = stream.batch(epoch, batch)
        q = stream.queries(epoch, queries)
        n = len(all_ids) + batch
        all_ids = np.concatenate([all_ids, ids])
        all_vecs[n - batch:n] = torch.from_numpy(vecs).to(device)

        # one interleaved stream: writes and reads mixed, engine coalesces
        t0 = time.perf_counter()
        tickets = []
        qi = 0
        for r in range(batch):
            engine.insert(int(ids[r]), vecs[r])
            if r % (batch // queries) == 0 and qi < queries:
                tickets.append(engine.query(q[qi], k=10))
                qi += 1
        res = engine.flush()
        elapsed = time.perf_counter() - t0

        got = np.stack([res[t][0] for t in tickets])
        got_d = np.stack([res[t][1] for t in tickets])
        oid, _ = ops.brute_force_topk(torch.from_numpy(q).to(device),
                                      all_vecs[:n], 10, "angular")
        oracle_ids = all_ids[oid.cpu().numpy()]
        recall = np.mean([len(set(got[i]) & set(oracle_ids[i])) / 10
                          for i in range(queries)])
        st = engine.stats()
        req_s = (batch + queries) / elapsed
        print(f"epoch {epoch}: store={len(all_ids):5d} "
              f"{req_s:7.0f} req/s "
              f"recall@10={recall:.2f} rounds={st['rounds']} "
              f"syncs={st['syncs']} seals={st['seals']}")
        out.append(dict(store=len(all_ids), req_s=req_s,
                        recall=float(recall), rounds=st["rounds"],
                        syncs=st["syncs"], seals=st["seals"], ids=got,
                        dists=got_d, oracle=oracle_ids))

    print("final stats:", engine.stats())
    print("index stats:", engine.index.stats())
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
