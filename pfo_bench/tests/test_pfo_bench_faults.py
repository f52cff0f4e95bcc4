"""``correct`` comes out false for the control and for each fault a cell
can have, planted under the timed path; a sound run comes out true.
The harness's look for a card is skipped: these run it on the CPU at a
small size.  A cell holds one chip, so there is no exchange between
chips to leave out."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _small import run_small

from pfo_bench import spec
from repro_torch.core import index as index_mod
from repro_torch.serving import stream as stream_mod

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _failed(res: dict) -> set[str]:
    return {k for k, (v, lim) in res["checks"].items() if v > lim}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell, seed=2**31 + 99)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference in the program's place, its products in TF32."""
    res = run_small(cell, seed=2**31 + 98, control=True)
    assert not res["correct"]
    assert _failed(res) == {"dist_gap"}


def _no_insert(state, ids, vecs, slots_in, main_active, lsh_active, cfg,
               mcap, lcap, fm=None, fl=None):
    """An insert step that returns its state unchanged and acknowledges."""
    flags = index_mod.round_flags(state, cfg, fm or mcap, fl or lcap)
    return (state, torch.where(slots_in == -2, 0, slots_in),
            torch.zeros_like(main_active), torch.zeros_like(lsh_active),
            flags)


def _half_insert(state, ids, vecs, slots_in, main_active, lsh_active, cfg,
                 mcap, lcap, fm=None, fl=None):
    """An insert step that leaves out the second half of its batch's
    active rows (all of a batch of one)."""
    rank = torch.cumsum(main_active.int(), 0) - 1
    keep = rank < main_active.sum() // 2
    st, slots, mp, lp, flags = index_mod.insert_step(
        state, ids, vecs, slots_in, main_active & keep,
        lsh_active & keep.repeat_interleave(cfg.L), cfg, mcap, lcap, fm, fl)
    return st, slots, mp, lp, flags


def _half_query(state, qvecs, cfg, k):
    """A query step that answers the first half of its batch only."""
    ids, d = index_mod.query_step(state, qvecs, cfg, k)
    cut = torch.arange(ids.shape[0])[:, None] >= ids.shape[0] // 2
    return torch.where(cut, -1, ids), torch.where(cut, float("inf"), d)


def _altered(ids, dists):
    """A query round's answer with one id altered where it is produced."""
    ids, dists = stream_mod.__dict__["_real_to_host"](ids, dists)
    ids = ids.copy()
    row = np.flatnonzero((ids[:, 0] >= 0) & (ids[:, 1] >= 0))
    if row.size:
        r = row[0]
        ids[r, 0] = ids[r, 1] + 1 if ids[r, 1] + 1 not in ids[r] else -7
    return ids, dists


FAULTS = {
    "state_unchanged": ("insert_step", _no_insert),
    "half_batch_insert": ("insert_step", _half_insert),
    "half_batch_query": ("query_step", _half_query),
    "answer_altered": ("_to_host", _altered),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_each_fault_is_not_correct(cell, fault, monkeypatch):
    name, fn = FAULTS[fault]
    monkeypatch.setitem(stream_mod.__dict__, "_real_to_host",
                        stream_mod._to_host)
    monkeypatch.setattr(stream_mod, name, fn)
    res = run_small(cell, seed=2**31 + 97)
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_is_correct_and_reads_the_spans(cell):
    """``--trace 1`` judges as ``--trace 0`` does and reports the
    per-layer metrics the program's spans and counters give (the
    profiler's need a card)."""
    res = run_small(cell, seed=2**31 + 96, trace=True)
    assert res["correct"], res["checks"]
    names = {m["name"] for m in spec.metrics_of(
        spec.load_benchmark(), cell, True) if m["source"] != "device_trace"}
    names.discard("index.syncs_per_round")        # counted on a card only
    assert names <= set(res["metrics"]), res["metrics"]
