"""Dump the first slice of ``chip_smoke.py``'s LM datastore, and how it
spreads over the LSH tables.

    python3 scripts/lm_datastore.py --out build/lm_datastore.npz
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tests/test_torch_lm_serving.py \
        build/lm_datastore.npz

The first command runs on one NVIDIA GPU.  It builds the ``lm`` phase's
full-width smollm_135m from the phase's seed (so the same weights), runs
the fill's first forward pass (LM_FILL_BATCH SyntheticLM sequences: the
phase's first 8,192 memories, at the same batch shape) and the phase's
256 recall queries, and writes memories, next tokens, queries, the
datastore's config and its projections to ``--out``.  It prints one JSON
line on how the memories spread, by the plain hash (no kernel launch):
the largest tree's share of the memories, the trees used, the distinct
keys of each table, the norm of the mean unit vector (1 when all point
one way), and for the queries the share whose exact nearest memory
shares a table key with them and the mean cosine of that neighbour.

The second command holds the JAX package's index and the port's, with
those projections, to the same answers and recall on that dump, on the
CPU.  ``--device cpu --reduced`` checks this script on the CPU with the
reduced model.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import PFOConfig, PFOIndex  # noqa: E402
from repro_torch.core.lsh import region_ids  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def spread(mem: torch.Tensor, q: torch.Tensor, proj: dict,
           pcfg: PFOConfig) -> dict:
    keys = ref.ref_lsh_hash(mem, proj["table_proj"])
    trees = region_ids(keys, proj["part_proj"], pcfg)
    per_tree = torch.stack([torch.bincount(trees[:, t],
                                           minlength=pcfg.n_trees)
                            for t in range(pcfg.L)])
    unit = torch.nn.functional.normalize(mem, dim=1)
    qunit = torch.nn.functional.normalize(q, dim=1)
    cos, nn = (qunit @ unit.T).max(1)
    qkeys = ref.ref_lsh_hash(q, proj["table_proj"])
    shares = (qkeys == keys[nn]).any(1)
    return dict(memories=len(mem), max_tree_share=float(per_tree.max()
                                                        / len(mem)),
                trees_used=int((per_tree > 0).sum()),
                distinct_keys=[int(torch.unique(keys[:, t]).numel())
                               for t in range(pcfg.L)],
                mean_unit_norm=float(unit.mean(0).norm()),
                queries=len(q), nearest_shares_a_key=float(
                    shares.float().mean()),
                nearest_cos_mean=float(cos.mean()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    dev, seed = torch.device(args.device), args.seed
    cfg = configs.get_config(cs.LM_ARCH, reduced=args.reduced)
    if args.reduced:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    text = SyntheticLM(cfg.vocab_size, cs.LM_FILL_LEN, cs.LM_FILL_SEQS,
                       seed=seed).batch(0)
    n = cs.LM_FILL_BATCH
    with torch.no_grad():
        hid, _ = model.forward(params, {"tokens": torch.from_numpy(
            text["tokens"][:n]).to(dev)})
        mem = hid.float().reshape(-1, cfg.d_model)
        held = SyntheticLM(cfg.vocab_size, 64, cs.LM_RECALL_SEQS,
                           seed=seed + 3).batch(0)["tokens"]
        hq, _ = model.forward(params, {"tokens": torch.from_numpy(held).to(
            dev)})
    pick = np.random.default_rng(seed).choice(64, cs.LM_RECALL_PER_SEQ,
                                              replace=False)
    q = hq[:, torch.as_tensor(pick, device=dev)].float().reshape(
        -1, cfg.d_model)
    pcfg = PFOConfig(dim=cfg.d_model, **cs.LM_DATASTORE)
    proj = PFOIndex(pcfg, seed=seed, device=dev).state.proj
    print(json.dumps(dict(arch=cs.LM_ARCH, reduced=args.reduced,
                          spread=spread(mem, q, proj, pcfg))), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, mem=mem.cpu().numpy(),
             nxt=text["labels"][:n].reshape(-1), queries=q.cpu().numpy(),
             table_proj=proj["table_proj"].cpu().numpy(),
             part_proj=proj["part_proj"].cpu().numpy(),
             datastore=json.dumps(cs.LM_DATASTORE), k=cs.LM_SERVE["knn_k"])
    print(json.dumps({"ok": True, "out": args.out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
