"""kNN-LM serving on the PyTorch port: an LM decodes while a PFO
datastore of (hidden-state -> next-token) memories is queried every
step and updated online with each served request.

    PYTHONPATH=src python examples/knnlm_serving_torch.py [--arch qwen2_7b] \
        [--device cpu]

The port's counterpart of ``examples/knnlm_serving.py``: the same
reduced config, datastore, rounds and printed lines.  It runs on CUDA
unless ``--device`` names another device (``--device cpu`` runs the
kernels' plain versions); without a card and without ``--device`` it
stops with an error.  The weights come from a ``torch.Generator`` on the
device seeded 0 and the index's SRP projections from one on the host
seeded 0, where the JAX script draws both with ``jax.random``, so the
tokens printed here differ from the JAX script's.  ``run(params=...,
proj=...)`` takes the JAX model's weights as numpy (through
``repro_torch.convert.params_from_numpy``) and a JAX index's projections
(``repro_torch.convert.proj_from_numpy``) and then serves as it does.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs, convert
from repro_torch.core import PFOConfig, PFOIndex
from repro_torch.core.device import default_device
from repro_torch.models.registry import build_model
from repro_torch.serving import ServeConfig, ServingEngine

ROUNDS, REQUESTS, PROMPT, NEW = 3, 4, 12, 8


def run(device=None, *, arch: str = "smollm_135m", rounds: int = ROUNDS,
        params=None, proj=None, dtype=None) -> dict:
    """Serve ``rounds`` rounds on ``device`` (CUDA when None); returns
    each round's tokens and stats and the datastore's stats.  ``params``
    is a numpy tree in the JAX package's layout; ``dtype`` overrides the
    config's compute dtype."""
    device = default_device(device)
    cfg = configs.get_config(arch, reduced=True)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device=device)
    else:
        params = convert.params_from_numpy(cfg, params, device)

    pcfg = PFOConfig(dim=cfg.d_model, L=4, C=2, m=2, l=32, t=4,
                     max_leaves_per_tree=512, main_max_leaves_per_tree=2048,
                     store_capacity=16384, max_candidates_total=128)
    pfo = PFOIndex(pcfg, seed=0, device=device, proj=proj)
    engine = ServingEngine(model, params,
                           ServeConfig(knn_lambda=0.3, knn_k=8),
                           pfo_index=pfo,
                           knn_vocab_map=np.zeros(16384, np.int32))

    rng = np.random.default_rng(0)
    served = []
    for r in range(rounds):
        batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                        (REQUESTS, PROMPT)).astype(np.int32)}
        out, stats = engine.generate(batch, max_new=NEW, insert_online=True)
        print(f"round {r}: tokens[0]={out[0].tolist()} "
              f"datastore={stats['datastore_size']}")
        served.append((out, stats))
    pfo_stats = pfo.stats()
    print("PFO:", pfo_stats)

    # the serving engine shares the datastore's Obs handle: prefill/
    # decode/kNN latency histograms land next to the stream's round
    # metrics
    print()
    print(engine.obs.format(title="knn-lm serving metrics"))
    return dict(rounds=served, pfo=pfo_stats)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.device, arch=args.arch, rounds=args.rounds)


if __name__ == "__main__":
    main()
