"""The plain reference on a hand-worked stream, the roofline arithmetic,
and the span reduction, on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _small  # noqa: F401  (puts the checkout on the path)

from pfo_bench import roofline, spans
from pfo_bench.reference.window_knn import Replay, round_tf32

Q, I, D, U = range(4)


def _stream():
    """Three windows over ids 0-2 (rows 0-2 of the table), angular, d=2.
    Rows: 0 (1,0), 1 (0,1), 2 (-1,0); 3 (1,1) id 3's insert; 4 (1,0.1)
    id 1's update; 5 (0.9,0.1) the query."""
    table = torch.tensor([[1, 0], [0, 1], [-1, 0], [1, 1], [1, 0.1],
                          [0.9, 0.1]], dtype=torch.float32)
    windows = [  # (kind, key, row) in submission order
        [(I, 3, 3), (D, 0, -1), (Q, -1, 5)],
        [(U, 1, 4), (Q, -1, 5)],
        [(D, 3, -1), (D, 1, -1), (I, 1, 1), (Q, -1, 5)],
    ]
    return table, windows


def test_three_windows_by_hand():
    table, windows = _stream()
    rep = Replay(table, 3, 4, "angular")
    want = [[3, 1], [1, 3], [1, 2]]      # window 1: 0 deleted, 3 (1,1)
    for w, reqs in enumerate(windows):   # nearer than 1 (0,1); then 1 at
        arr = np.array(reqs, np.int64)   # (1,0.1); then 1 back at (0,1)
        rep.apply(arr[:, 0], arr[:, 1], arr[:, 2])
        ids, d = rep.knn(np.array([5]), 2)
        assert ids[0].tolist() == want[w], w
        assert (np.diff(d[0]) >= 0).all()
    # after window 3: live 1 (row 1) and 2 (row 2); 0 and 3 dead, their
    # last versions rows 0 and 3
    assert rep.row_of.tolist() == [-1, 1, 2, -1]
    assert rep.last_of.tolist() == [0, 1, 2, 3]


def test_judge_counts_each_fault():
    table, windows = _stream()
    rep = Replay(table, 3, 4, "angular")
    for reqs in windows[:2]:
        arr = np.array(reqs, np.int64)
        rep.apply(arr[:, 0], arr[:, 1], arr[:, 2])
    q = np.array([5])
    ids, d = rep.knn(q, 2)
    truth = ids
    ok = rep.judge(q, np.array([-1]), ids, d, truth)
    assert ok == dict(malformed=0, dead=0, dist_gap=ok["dist_gap"],
                      self_missing=0, self_absent=0, hits=2)
    assert ok["dist_gap"] < 1e-7
    # a deleted id, a stale version's distance, a repeat, an empty self
    dead = rep.judge(q, np.array([-1]), np.array([[1, 0]]),
                     np.array([[d[0, 0], 0.2]], np.float32), truth)
    assert dead["dead"] == 1
    v0 = table[1] / table[1].norm()           # id 1's old version
    qn = table[5] / table[5].norm()
    stale = rep.judge(q, np.array([-1]), np.array([[1, 3]]),
                      np.array([[1 - float(v0 @ qn), d[0, 1]]], np.float32),
                      truth)
    assert stale["dist_gap"] > 0.5
    rep_ = rep.judge(q, np.array([-1]), np.array([[1, 1]]),
                     np.array([[d[0, 0], d[0, 0]]], np.float32), truth)
    assert rep_["malformed"] == 1
    empty = rep.judge(q, np.array([1]), np.array([[-1, -1]]),
                      np.full((1, 2), np.inf, np.float32), truth)
    assert empty["self_missing"] == 1 and empty["malformed"] == 0
    # a self-query of id 2 (row 2): found; lost though a larger id came
    # back; absent behind a full answer of smaller ids, which the ranking
    # budget (the smallest ids) can have cut
    s2 = np.array([2])
    ids2, d2 = rep.knn(s2, 2)
    assert ids2[0, 0] == 2
    found = rep.judge(s2, s2, ids2, d2, None)
    assert found["self_missing"] == found["self_absent"] == 0
    assert found["dist_gap"] < 1e-7
    lost = rep.judge(s2, s2, np.array([[3, 1]]),
                     np.array([[0.5, 1.0]], np.float32), None)
    assert lost["self_missing"] == lost["self_absent"] == 1
    cut = rep.judge(s2, s2, np.array([[1, 0]]),
                    np.array([[1.0, 1.5]], np.float32), None)
    assert cut["self_missing"] == 0 and cut["self_absent"] == 1


def test_the_control_reads_tf32_gaps():
    """The reference with its product's operands in TF32 answers with
    distances ~1e-4 of their scale away: what the control must show."""
    g = torch.Generator().manual_seed(0)
    table = torch.rand((4000, 100), generator=g) * 200
    rep = Replay(table, 3000, 3000, "angular")
    q = np.arange(3000, 3200)
    ids, d = rep.knn(q, 10, tf32=True)
    r = rep.judge(q, np.full(200, -1), ids, d, None)
    assert 1e-6 < r["dist_gap"] < 1e-2
    ids, d = rep.knn(q, 10)
    assert rep.judge(q, np.full(200, -1), ids, d, None)["dist_gap"] < 1e-5
    x = torch.tensor([1 + 2**-12, 1 + 2**-10], dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0, 1 + 2**-10]


def test_roofline_arithmetic():
    # PERF.md's kernel table: lsh_hash at (4,096, 100, 320) is bound by
    # its operations, 2 * 4096 * 100 * 320 at 495 / 3 TFLOP/s
    ms, by = roofline.bound_ms(*roofline.lsh_hash_work(4096, 100, 320))
    assert by == "operations"
    assert ms == pytest.approx(0.001588752, rel=1e-6)   # the table's digits
    # gather_rank reads each named store row once: bytes-bound
    b, f = roofline.gather_rank_work(256, 512, 100, rows=50_000,
                                     valid=80_000)
    assert b == 4.0 * (256 * 100 + 50_000 * 100) + 256 * 512 * 9
    assert f == 2.0 * 80_000 * 100
    assert roofline.bound_ms(b, f)[1] == "bytes"


def test_span_self_time():
    ev = [("dispatch", 0, 100, 0, {"kind": "query"}),
          ("pack", 10, 30, 0, {"kind": "query"}),
          ("result_pickup", 100, 50, 0, {"kind": "query"}),
          ("dispatch", 200, 40, 1, {"kind": "insert"})]
    q = spans.self_us(ev, lambda n, a: a.get("kind") == "query"
                      and n != "pack")
    assert q == 70 + 50
    assert spans.self_us(ev, lambda n, a: n == "pack") == 30
    assert spans.self_us(ev, lambda n, a: a.get("kind") == "insert") == 40
