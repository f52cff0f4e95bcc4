"""A cell of the benchmark at a size the CPU runs in seconds: the same
harness, traffic and reference, a small index (the kernels' plain
versions run on the CPU)."""
from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO), str(REPO / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SMALL = dict(rows=3000, prefill_batch=512, stream=dict(max_batch=64),
             index=dict(L=4, C=2, m=2, l=16, t=4, max_nodes_per_tree=64,
                        max_leaves_per_tree=512, main_max_nodes_per_tree=128,
                        main_max_leaves_per_tree=1024, store_capacity=16384,
                        max_candidates_total=128, snapshot_capacity=4096))
SMALL_MIX = dict(window=64)


def run_small(cell: str, seed: int = 2147483647, seconds: float = 1.0,
              trace: bool = False, control: bool = False,
              bench: dict | None = None) -> dict:
    """One run of ``cell`` on the CPU at the small size."""
    from pfo_bench import run, spec
    bench = bench or spec.load_benchmark()
    run.T_START = time.perf_counter()
    return run.run_cell(bench, spec.cell_of(bench, cell), seed, seconds,
                        trace, "cpu", control=control, cfg_over=SMALL,
                        mix_over=SMALL_MIX)
