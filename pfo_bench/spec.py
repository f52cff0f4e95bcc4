"""What a run reads by name: ``BENCHMARK.json`` at the root of the
checkout, and the files of one configuration, one traffic mix, one
cell's limits and one metric, each found by the name the cell gives.

A later cell, configuration, mix or metric is a new file and a new
entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent          # pfo_bench/
REPO = HERE.parent                              # the checkout's root


def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str, repo: Path = REPO) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((repo / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_of(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def limits_of(cell: str, root: Path = HERE) -> dict:
    """The cell's limits on the numbers that decide ``correct``."""
    return json.loads((root / "limits" / f"{cell}.json").read_text())


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones with
    ``trace`` off, its per-layer ones with it on.  A metric with a
    ``workloads`` list belongs to those cells only."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, root: Path = HERE):
    """The ``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pfo_bench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
