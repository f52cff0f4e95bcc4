"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` at first use) and skip elsewhere.  They
import no JAX, so they run where the port runs::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The seeded inputs below are shared with ``test_torch_kernels.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

MARGIN = 1e-4
TOL = 2e-5
HASH_SHAPES = [(1, 8, 1), (7, 33, 2), (37, 100, 3), (128, 64, 4),
               (130, 257, 2), (300, 100, 10)]
RANK_SHAPES = [(1, 1, 1, 8), (3, 7, 13, 5), (8, 128, 100, 64),
               (5, 130, 41, 17), (16, 96, 500, 100)]
#: (q, c, n store rows, m staging rows, d): ragged d, N and M
STAGED_SHAPES = [(1, 1, 1, 1, 8), (3, 7, 13, 4, 5), (8, 128, 100, 37, 64),
                 (5, 130, 41, 300, 17), (16, 96, 500, 1000, 100)]


def hash_inputs(n, d, tables, seed):
    """x (n, d), a (d, 32*tables) with every projection >= MARGIN from
    zero in float64 (rows are redrawn until they are)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(d, tables * 32)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    while True:
        bad = np.abs(x.astype(np.float64) @ a.astype(np.float64)).min(1) < MARGIN
        if not bad.any():
            return x, a
        x[bad] = rng.normal(size=(int(bad.sum()), d)).astype(np.float32)


def rank_inputs(q, c, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(0, n, size=(q, c)).astype(np.int32),
            rng.random((q, c)) < 0.7)


def staged_inputs(q, c, n, m, d, seed):
    """Queries, a store, a staging arena and slots over both arenas (some
    past the staging arena's end, which clip), with masked and duplicate
    slots."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(-2, n + m + 3, size=(q, c)).astype(np.int32)
    slots[:, ::5] = slots[:, :1]                  # duplicates
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32), slots,
            rng.random((q, c)) < 0.7)


def _t(*arrays):
    """numpy arrays -> CPU tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.cuda
def test_each_launch_counts_once_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ops.reset_launches()
    x, a = _t(*hash_inputs(8, 16, 2, seed=1))
    ops.lsh_hash(x.cuda(), a.cuda())
    args = _t(*rank_inputs(2, 3, 5, 16, seed=2))
    ops.gather_rank(*(v.cuda() for v in args), "l2")
    assert ops.LAUNCHES == {"lsh_hash": 1, "gather_rank": 1,
                            "gather_rank_staged": 0}
    q, store, staging, slots, valid = (v.cuda() for v in _t(
        *staged_inputs(2, 3, 5, 4, 16, seed=3)))
    ops.gather_rank(q, store, slots, valid, "angular", staging=staging)
    ops.gather_rank(q, store, slots, valid, "l2", staging=staging)
    assert ops.LAUNCHES == {"lsh_hash": 1, "gather_rank": 1,
                            "gather_rank_staged": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,tables", HASH_SHAPES)
def test_lsh_hash_kernel_matches_plain_on_card(n, d, tables):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, a = _t(*hash_inputs(n, d, tables, seed=n + d))
    got = ops.lsh_hash(x.cuda(), a.cuda()).cpu()
    assert torch.equal(got, ref.ref_lsh_hash(x, a))


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,n,d", RANK_SHAPES)
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_gather_rank_kernel_matches_plain_on_card(q, c, n, d, metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _t(*rank_inputs(q, c, n, d, seed=q + c))
    got = ops.gather_rank(*(t.cuda() for t in args), metric).cpu()
    torch.testing.assert_close(got, ref.ref_gather_rank(*args, metric),
                               rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,n,m,d", STAGED_SHAPES)
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_gather_rank_staged_kernel_matches_plain_on_card(q, c, n, m, d,
                                                         metric):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, store, staging, slots, valid = _t(*staged_inputs(q, c, n, m, d,
                                                         seed=q + c + m))
    got = ops.gather_rank(qq.cuda(), store.cuda(), slots.cuda(),
                          valid.cuda(), metric, staging=staging.cuda()).cpu()
    want = ref.ref_gather_rank(qq, store, slots, valid, metric,
                               staging=staging)
    assert torch.equal(torch.isinf(got), ~valid)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_staged_rows_rank_bit_identically_on_card(metric):
    """Store rows copied into the staging arena and addressed through
    staging slots rank bit for bit as they do from the store."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, store, slots, valid = (t.cuda() for t in _t(
        *rank_inputs(16, 96, 500, 100, seed=5)))
    staging = torch.zeros((700, 100), device="cuda")
    perm = torch.randperm(700, device="cuda")[:500]
    staging[perm] = store                         # row r -> staging perm[r]
    staged = torch.where(torch.arange(96, device="cuda") % 2 == 0, slots,
                         500 + perm[slots.long()].to(torch.int32))
    a = ops.gather_rank(qq, store, slots, valid, metric)
    b = ops.gather_rank(qq, store, staged, valid, metric, staging=staging)
    assert torch.equal(a, b)
