"""``BENCHMARK.json``'s form (keys, names, units, texts, bounds, the
check's time budget), and every name it gives resolved to its file."""
from __future__ import annotations

import json
import re

import pytest

from _small import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "pfo_bench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts(bench):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [e["name"] for e in bench[g]]
        assert len(names) == len(set(names)), g
        for e in bench[g]:
            assert NAME.match(e["name"]), e["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_metrics(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    layers = set()
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] == "ops_per_s"
        assert set(m["workloads"]) <= cells and m["workloads"]
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert "kernels" in layers


def test_every_name_has_its_file(bench):
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"].startswith("pfo_bench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg and f"source_{key}" in cfg
    used = set()
    for w in bench["workloads"]:
        used.add(w["config"])
        assert w["config"] in files
        assert (REPO / "pfo_bench/traffic" / f"{w['traffic']}.json").exists()
        lim = json.loads((REPO / "pfo_bench/limits" /
                          f"{w['name']}.json").read_text())
        assert lim["dist_gap"] > 0
    assert used == set(files)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (REPO / "pfo_bench/metrics" / f"{m['name']}.py").exists()


def test_every_cell_reports_enough(bench):
    from pfo_bench import spec
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics_of(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics_of(bench, w["name"], True)
