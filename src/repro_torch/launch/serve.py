"""Serving entrypoint: batched generation with the PFO kNN-LM head.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_135m \
      --reduced --requests 4 --max-new 16 [--no-knn] [--device cpu]

Runs on the card unless ``--device`` names another device.  Weights are
random (a ``torch.Generator`` seeded 0), as in the JAX package's entry
point; an encoder-decoder config (``--arch whisper_medium``) gets random
frame embeddings for its stub audio frontend.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import configs
from ..core import PFOConfig, PFOIndex
from ..core.device import default_device
from ..models.registry import build_model
from ..serving import ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--no-knn", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = configs.get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=device)

    pfo = None
    vocab_map = None
    if not args.no_knn:
        pcfg = PFOConfig(dim=cfg.d_model, L=4, C=2, m=2, l=32, t=4,
                         max_nodes_per_tree=128, max_leaves_per_tree=512,
                         main_m=4, main_max_leaves_per_tree=2048,
                         store_capacity=16384,
                         max_candidates_total=128)
        pfo = PFOIndex(pcfg, seed=0, device=device)
        vocab_map = np.zeros(16384, np.int32)

    eng = ServingEngine(model, params, ServeConfig(), pfo_index=pfo,
                        knn_vocab_map=vocab_map)
    rng = np.random.default_rng(0)
    for round_i in range(2):
        batch = {"tokens": rng.integers(
            0, cfg.vocab_size, (args.requests, args.prompt_len)
        ).astype(np.int32)}
        if cfg.frontend == "audio":    # the stub frontend's frame embeddings
            batch["features"] = rng.normal(
                size=(args.requests, cfg.enc_len, cfg.d_model)
            ).astype(np.float32)
        out, stats = eng.generate(batch, max_new=args.max_new,
                                  insert_online=pfo is not None)
        print(f"round {round_i}: generated {out.shape} stats={stats}")
        print("tokens[0]:", out[0].tolist())


if __name__ == "__main__":
    main()
