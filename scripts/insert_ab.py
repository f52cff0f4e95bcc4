"""Time the hot write path of one checkout of the port against another's.

    python3 scripts/insert_ab.py --src PARENT_DIR --src . [--items N]

Each ``--src`` names a checkout (its ``src/`` holds ``repro_torch``);
each runs in a process of its own, in the order given, on the same card
and the same data: ``chip_smoke.py``'s hot main-path config at glove
width (d = 100) and its clustered unit vectors from ``--seed``.  A leg
inserts ``--items`` vectors in calls of 4,096 (``fresh``, after one
untimed warm-up call), then re-inserts the first half of them live with
new vectors (``live_reinsert``), and prints one JSON line: inserts/s of
each part (synchronised wall clock), rounds, seals, live MainTable
entries and free store slots.  Put both checkouts in one call, in the
order parent, change, change, parent: the card's power limit and the
host's load then weigh on both alike.  The last lines are the card's
name and power limit and ``{"ok": true}``.  ``--device cpu`` with small
``--items`` checks the script itself.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def leg(args) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(args.leg), "src"))
    import torch
    from repro_torch.core import PFOConfig, PFOIndex

    dev = torch.device(args.device)
    cfg = PFOConfig(dim=100, max_nodes_per_tree=512,
                    max_leaves_per_tree=4096, main_max_nodes_per_tree=1024,
                    main_max_leaves_per_tree=16384, store_capacity=1 << 20)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    n, batch = args.items, 4096

    def clustered(m):
        centers = torch.randn((max(1, m // 20), cfg.dim), generator=g,
                              device=dev)
        centers = centers / centers.norm(dim=1, keepdim=True)
        which = torch.randint(0, centers.shape[0], (m,), generator=g,
                              device=dev)
        x = centers[which] + 0.5 / cfg.dim ** 0.5 * torch.randn(
            (m, cfg.dim), generator=g, device=dev)
        return x / x.norm(dim=1, keepdim=True)

    vecs = clustered(n + batch)
    again = clustered(n // 2)
    ids = torch.randperm(n + batch, generator=g, device=dev).to(torch.int32)
    idx = PFOIndex(cfg, seed=args.seed, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    idx.insert(ids[n:], vecs[n:])                 # warm-up, not timed
    sync()
    out = {}
    for name, rows, x in (("fresh", slice(0, n), vecs),
                          ("live_reinsert", slice(0, n // 2), None)):
        r0 = len(idx.rounds_log)
        t0 = time.perf_counter()
        for s in range(rows.start, rows.stop, batch):
            e = min(s + batch, rows.stop)
            idx.insert(ids[s:e], vecs[s:e] if x is not None
                       else again[s:e])
        sync()
        dt = time.perf_counter() - t0
        out[name] = dict(items=rows.stop - rows.start, s=dt,
                         inserts_per_s=(rows.stop - rows.start) / dt,
                         rounds=sum(idx.rounds_log[r0:]))
    st = idx.stats()
    return dict(src=args.leg, device=str(dev), **out,
                seals=idx.maintenance_log.count("seal"),
                items_hot=int(idx.state.main_forest.n_items.sum()),
                main_sealed=int(idx.state.main_snaps.counts.sum()),
                store_free=int(idx.state.store.free_top),
                overflow_events=st["overflow_events"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", default=[])
    ap.add_argument("--items", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.leg is not None:
        print("INSERT_AB " + json.dumps(leg(args)), flush=True)
        return 0
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("insert_ab: no CUDA device", file=sys.stderr)
            return 1
    for src in args.src:
        got = subprocess.run(
            [sys.executable, __file__, "--leg", src, "--items",
             str(args.items), "--seed", str(args.seed), "--device",
             args.device], capture_output=True, text=True)
        line = [ln for ln in got.stdout.splitlines()
                if ln.startswith("INSERT_AB ")]
        if got.returncode or not line:
            print(got.stdout, got.stderr, file=sys.stderr)
            return 1
        print(line[0].split(" ", 1)[1], flush=True)
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
