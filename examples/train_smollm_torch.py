"""End-to-end driver on the PyTorch port: train the REAL smollm-135m
config (30L, d=576, ~135M params) for a few hundred steps on the
synthetic Markov stream, with checkpoints + restart.

    PYTHONPATH=src python examples/train_smollm_torch.py --steps 300 \
        [--device cpu]

The port's counterpart of ``examples/train_smollm.py``: the same config,
sizes, optimizer, checkpoint cadence and printed lines.  It trains on
CUDA unless ``--device`` names another device; without a card and
without ``--device`` it stops with an error.  ``--smoke`` drops to the
reduced config for a fast end-to-end check of the same driver (on the
CPU, ``--smoke --device cpu`` keeps a step under a second).  The weights
are drawn from a ``torch.Generator`` on the device seeded 0, where the
JAX script draws them with ``jax.random``, so the losses printed here
differ from the JAX script's.

Checkpoints go to ``smollm_ckpt_torch`` in the temp directory, apart from
the JAX script's ``/tmp/smollm_ckpt``.  Both write the JAX package's
layout, so a JAX checkpoint of the same config resumes here; one of
another config is refused (a leaf of another shape or a missing leaf).
"""
import argparse
import os
import tempfile

from repro_torch import configs
from repro_torch.checkpoint import latest_step
from repro_torch.data import SyntheticLM
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer

CKPT = os.path.join(tempfile.gettempdir(), "smollm_ckpt_torch")


def run(device=None, *, steps: int = 300, seq: int = 128, batch: int = 4,
        smoke: bool = False, ckpt: str = CKPT) -> dict:
    """Train on ``device`` (CUDA when None), resuming from the newest
    checkpoint under ``ckpt``; returns the ``Trainer``'s output with the
    step it started from (``start``)."""
    cfg = configs.get_config("smollm_135m", reduced=smoke)
    model = build_model(cfg)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    tcfg = TrainConfig(
        steps=steps, ckpt_every=50, log_every=5, ckpt_dir=ckpt,
        loss_chunk=min(128, seq),
        opt=AdamWConfig(lr=6e-4, warmup_steps=max(steps // 20, 5),
                        total_steps=steps))
    start = min(latest_step(ckpt) or 0, steps)
    out = Trainer(model, data, tcfg, device=device).run(resume=True)
    if out["losses"]:
        print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
              f"over {len(out['losses'])} steps")
    return dict(out, start=start)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt", default=CKPT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.device, steps=args.steps, seq=args.seq,
               batch=args.batch, smoke=args.smoke, ckpt=args.ckpt)


if __name__ == "__main__":
    main()
