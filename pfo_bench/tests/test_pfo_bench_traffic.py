"""The traffic generator: each mix repeats for a seed and holds its
shares in every window; a mix dropped into a copy of the benchmark is a
cell with no other file edited."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from _small import REPO, SMALL, SMALL_MIX

from pfo_bench import data, generator, spec

MIXES = sorted(p.stem for p in (REPO / "pfo_bench/traffic").glob("*.json"))


def _cfg():
    bench = spec.load_benchmark()
    return spec.config_of(bench, bench["configs"][0]["name"])


def _traffic(mix, seed, n=2000, windows=6):
    cfg = _cfg()
    base = data.base_vectors(cfg, n, seed, "cpu")
    return generator.Traffic(mix, cfg, base, seed).extend(windows)


@pytest.mark.parametrize("name", MIXES)
def test_mix_repeats_for_a_seed(name):
    mix = dict(spec.traffic_of(name), window=128)
    a, b = _traffic(mix, 2**31 + 5), _traffic(mix, 2**31 + 5)
    c = _traffic(mix, 2**31 + 6)
    for f in ("kind", "key", "row", "self_query"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert torch.equal(a.table, b.table)
    assert not np.array_equal(a.key, c.key)


@pytest.mark.parametrize("name", MIXES)
def test_mix_keeps_its_shares_in_every_window(name):
    mix = dict(spec.traffic_of(name), window=128)
    t = _traffic(mix, 11)
    want = generator.window_counts(mix, 128)
    shares = np.array([mix["mix"].get(k, 0.0) for k in generator.KINDS])
    assert np.abs(want / 128 - shares).max() <= 1 / 128
    for w in range(t.n_windows):
        got = np.bincount(t.kind[w * 128:(w + 1) * 128], minlength=4)
        assert np.array_equal(got, want)
    self_share = t.self_query[t.kind == 0].mean()
    assert abs(self_share - mix.get("self_queries", 0.0)) < 0.08


def test_window_semantics_of_the_stream():
    """Inserts take fresh ids in order; deletes draw ids issued so far;
    a self-query copies a live id's current vector exactly."""
    mix = dict(spec.traffic_of("stream-mix"), window=128)
    n = 2000
    t = _traffic(mix, 3, n=n)
    ins = t.key[t.kind == generator.INSERT]
    assert np.array_equal(ins, n + np.arange(ins.size))
    cur = {i: i for i in range(n)}
    for w in range(t.n_windows):
        s = slice(w * 128, (w + 1) * 128)
        issued = n + int((t.kind[:s.stop] == generator.INSERT).sum())
        for kd, key, row in zip(t.kind[s], t.key[s], t.row[s]):
            if kd == generator.DELETE:
                assert 0 <= key < issued
                cur.pop(int(key), None)
            elif kd != generator.QUERY:
                cur[int(key)] = int(row)
        for kd, key, row, sq in zip(t.kind[s], t.key[s], t.row[s],
                                    t.self_query[s]):
            if kd == generator.QUERY and sq:
                assert int(key) in cur
                assert torch.equal(t.table[row], t.table[cur[int(key)]])


@pytest.mark.parametrize("name", MIXES)
def test_a_window_is_the_same_however_many_are_made(name):
    """Window ``w`` comes from ``(seed, w)`` and the windows before it:
    made in one call or in chunks, and with more windows after it, its
    requests and vectors are the same."""
    mix = dict(spec.traffic_of(name), window=128)
    cfg = _cfg()
    base = data.base_vectors(cfg, 2000, 4, "cpu")
    one = generator.Traffic(mix, cfg, base, 2**31 + 9).extend(6)
    chunks = generator.Traffic(mix, cfg, base, 2**31 + 9)
    chunks.extend(1).extend(2).extend(3)
    few = generator.Traffic(mix, cfg, base, 2**31 + 9).extend(4)
    end = few.n_windows * 128
    for f in ("kind", "key", "row", "self_query"):
        assert np.array_equal(getattr(one, f), getattr(chunks, f))
        assert np.array_equal(getattr(one, f)[:end], getattr(few, f))
    assert torch.equal(one.table, chunks.table)
    assert torch.equal(one.table[:2000 + end], few.table)
    assert np.array_equal(one.host, one.table[2000:].numpy())


def test_zipf_keys_are_skewed():
    mix = dict(spec.traffic_of("ycsb-b"), window=1024)
    t = _traffic(mix, 5, n=20000, windows=40)
    keys = t.key[t.kind == generator.UPDATE]
    top = np.bincount(keys).max() / keys.size
    # zipf 0.99 over 20,000 ids: the hottest takes ~9%
    assert 0.05 < top < 0.14
    assert keys.max() < 20000


def test_a_mix_file_dropped_into_a_copy_is_a_cell(tmp_path):
    """A new mix is a traffic file, a limits file and an entry in
    BENCHMARK.json: no file of the harness is edited."""
    shutil.copytree(REPO / "pfo_bench", tmp_path / "pfo_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "pfo_bench").rglob("*") if p.is_file()}
    mix = dict(spec.traffic_of("ycsb-b"), mix={"query": 0.8, "delete": 0.2},
               keys={"query": "zipf", "delete": "issued"})
    (tmp_path / "pfo_bench/traffic/read-delete.json").write_text(
        json.dumps(mix))
    cfg = bench["configs"][0]["name"]
    cell = f"{cfg}.read-delete"
    (tmp_path / f"pfo_bench/limits/{cell}.json").write_text(
        json.dumps({"dist_gap": 1e-5}))
    bench["workloads"].append(dict(name=cell, config=cfg,
                                   traffic="read-delete", chips=1,
                                   why="a test mix"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(REPO / 'src')!r}]\n"
        "from pfo_bench import run, spec\n"
        f"assert spec.REPO == __import__('pathlib').Path({str(tmp_path)!r})\n"
        "b = spec.load_benchmark()\n"
        f"r = run.run_cell(b, spec.cell_of(b, {cell!r}), 7, 0.5, False, "
        f"'cpu', cfg_over={SMALL!r}, mix_over={SMALL_MIX!r})\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"ops_per_s", "recall_at_10", "setup_s"}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "pfo_bench").rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
