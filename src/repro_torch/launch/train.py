"""Training entrypoint.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \
      --steps 200 --seq 256 --batch 8 [--reduced] [--ckpt DIR] \
      [--device cpu]

Trains on the card unless ``--device`` names another device, from
random weights (a ``torch.Generator`` on that device seeded 0) on the
synthetic Markov token stream, with checkpoints and restart, as the JAX
package's entry point does.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from .. import configs
from ..data import SyntheticLM
from ..models.registry import build_model
from ..optim import AdamWConfig
from ..train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt,
        loss_chunk=min(512, args.seq),
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps))
    out = Trainer(model, data, tcfg, device=args.device).run(
        resume=not args.no_resume)
    print(f"final loss {out['losses'][-1]:.4f} "
          f"(first {out['losses'][0]:.4f}); slow steps: "
          f"{out['slow_steps']}")
    return out


if __name__ == "__main__":
    main()
