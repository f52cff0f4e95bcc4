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
#: (n, d, tables): ragged N and d, the path's insert and query batches
#: (4096 and 1024 rows of d = 100, L = 10: the kernel's 5- and 2-word
#: tiles), N off the 64-row tile with 7 words (a multiple of neither
#: tile's words), d = 4k + 1 (rows not 16-byte aligned) and d = 1000 (K
#: past one chunk)
HASH_SHAPES = [(1, 8, 1), (7, 33, 2), (37, 100, 3), (128, 64, 4),
               (130, 257, 2), (300, 100, 10), (4096, 100, 10),
               (1024, 100, 10), (1000, 100, 7), (300, 101, 5),
               (45, 1000, 3)]
#: (q, c, n store rows, d) for gather_rank: ragged shapes, then the main
#: path's C = 512 and d = 100 at small Q, C = 1000 (two 512-candidate
#: tiles, the second ragged), d on the 16-byte path (4, 128) and on the
#: scalar path (99), and the d limit (12,288: the shared memory past 48 KB)
RANK_SHAPES = [(1, 1, 1, 8), (3, 7, 13, 5), (8, 128, 100, 64),
               (5, 130, 41, 17), (16, 96, 500, 100), (4, 512, 1000, 100),
               (3, 1000, 300, 100), (5, 64, 50, 4), (5, 64, 50, 99),
               (5, 64, 50, 128), (2, 40, 30, 12288)]
#: (q, c, n store rows, m staging rows, d): ragged d, N and M, then as
#: RANK_SHAPES (d = 7,168: the kNN-LM index's widest d_model) and a
#: staging arena of one row
STAGED_SHAPES = [(1, 1, 1, 1, 8), (3, 7, 13, 4, 5), (8, 128, 100, 37, 64),
                 (5, 130, 41, 300, 17), (16, 96, 500, 1000, 100),
                 (4, 512, 1000, 700, 100), (3, 1000, 300, 200, 100),
                 (5, 64, 50, 40, 4), (5, 64, 50, 40, 99),
                 (5, 64, 50, 40, 128), (2, 40, 30, 20, 7168),
                 (4, 100, 50, 1, 100)]
#: tolerances of the reference's kernel tests (tests/test_kernels.py)
DOTS_TOL = 2e-5
PAIR_TOL = 1e-4
#: (q, c, d) for rank_dots, (q, n, d) for pair_dist, (q, n, w) for hamming:
#: the reference's sweeps, plus 1s, d = 100 and non-multiples of the tiles;
#: for rank_dots also d = 99 (scalar loads) and a block shaped like
#: MultiProbeFlat's (~10,000 candidates, several 512-candidate tiles a
#: query, the last ragged); for hamming, Q and N off the kernel's 64 x 128
#: tiles, W = 1, 10, 42 and the limit 63
DOTS_SHAPES = [(1, 1, 8), (5, 33, 48), (8, 128, 128), (9, 130, 65),
               (1, 1, 1), (3, 65, 100), (5, 64, 99), (4, 10000, 100)]
#: rank_dots past one pass of the lanes (the query read a pass at a time):
#: d = 7,168 (the kNN-LM index's widest d_model) and the limit 12,288, on
#: unit rows (``unit_dots_inputs``)
WIDE_DOTS_SHAPES = [(2, 40, 7168), (3, 17, 12288)]
PAIR_SHAPES = [(1, 1, 8), (5, 57, 48), (128, 128, 256), (33, 200, 100),
               (1, 1, 1), (129, 131, 9), (130, 300, 100), (1024, 4099, 100),
               (1, 1, 4), (200, 300, 1000)]
HAMMING_SHAPES = [(1, 1, 1), (9, 13, 4), (130, 70, 10), (33, 257, 10),
                  (2, 300, 41), (64, 128, 10), (65, 129, 10), (200, 1028, 1),
                  (63, 300, 42), (70, 260, 63)]


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


def dots_inputs(q, c, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(q, c, d)).astype(np.float32))


def unit_dots_inputs(q, c, d, seed):
    """dots_inputs with every row scaled to unit length, as
    ``pairwise_rank`` hands them for the angular metric.  At d in the
    thousands two fp32 summation orders of N(0, 1) products part by
    ~1e-4 (the JAX package's and torch's plain versions already do), past
    the reference's 2e-5; unit rows keep that tolerance meaningful."""
    qq, x = dots_inputs(q, c, d, seed)
    return (qq / np.linalg.norm(qq, axis=-1, keepdims=True),
            x / np.linalg.norm(x, axis=-1, keepdims=True))


def pair_inputs(q, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def key_inputs(q, n, w, seed):
    """uint32 keys as int64 (the port's carrier), the extremes included."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, size=(q, w), dtype=np.uint64).astype(np.int64)
    b = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.int64)
    a.reshape(-1)[:2] = [0, 0xFFFFFFFF][:a.size]
    b.reshape(-1)[-2:] = [0xFFFFFFFF, 0x80000000][-b.size:]
    return a, b


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
                            "gather_rank_staged": 0, "pair_dist": 0,
                            "rank_dots": 0, "hamming": 0}
    q, store, staging, slots, valid = (v.cuda() for v in _t(
        *staged_inputs(2, 3, 5, 4, 16, seed=3)))
    ops.gather_rank(q, store, slots, valid, "angular", staging=staging)
    ops.gather_rank(q, store, slots, valid, "l2", staging=staging)
    assert ops.LAUNCHES == {"lsh_hash": 1, "gather_rank": 1,
                            "gather_rank_staged": 2, "pair_dist": 0,
                            "rank_dots": 0, "hamming": 0}
    qq, x = (v.cuda() for v in _t(*pair_inputs(3, 5, 16, seed=4)))
    ops.pair_dist_sq(qq, x)
    ops.brute_force_topk(qq, x, 2, "angular")
    qq, block = (v.cuda() for v in _t(*dots_inputs(3, 5, 16, seed=5)))
    ops.rank_dots(qq, block)
    ops.pairwise_rank(qq, block, torch.ones((3, 5), dtype=torch.bool,
                                            device="cuda"), "l2")
    ops.hamming(*(v.cuda() for v in _t(*key_inputs(3, 5, 2, seed=6))))
    assert ops.LAUNCHES == {"lsh_hash": 1, "gather_rank": 1,
                            "gather_rank_staged": 2, "pair_dist": 2,
                            "rank_dots": 2, "hamming": 1}


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
@pytest.mark.parametrize("c,d", [(96, 100), (512, 100), (96, 99)])
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_staged_rows_rank_bit_identically_on_card(c, d, metric):
    """Store rows copied into the staging arena and addressed through
    staging slots rank bit for bit as they do from the store: at the main
    path's C = 512, and at d = 99 (scalar loads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, store, slots, valid = (t.cuda() for t in _t(
        *rank_inputs(16, c, 500, d, seed=5)))
    staging = torch.zeros((700, d), device="cuda")
    perm = torch.randperm(700, device="cuda")[:500]
    staging[perm] = store                         # row r -> staging perm[r]
    staged = torch.where(torch.arange(c, device="cuda") % 2 == 0, slots,
                         500 + perm[slots.long()].to(torch.int32))
    a = ops.gather_rank(qq, store, slots, valid, metric)
    b = ops.gather_rank(qq, store, staged, valid, metric, staging=staging)
    assert torch.equal(a, b)


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """A copy of x whose data starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_scalar_and_vector_loads_rank_bit_identically_on_card(staged,
                                                              metric):
    """An arena that is not 16-byte aligned takes the kernels' scalar
    loads; they sum the same products in the same order as the 16-byte
    loads, so the distances are equal bit for bit (and to the plain
    version within TOL)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, store, staging, slots, valid = (t.cuda() for t in _t(
        *staged_inputs(6, 512, 300, 200, 100, seed=17)))
    if not staged:
        staging = None
        slots = slots.clamp_max(299)
    a = ops.gather_rank(qq, store, slots, valid, metric, staging=staging)
    b = ops.gather_rank(qq, _unaligned(store), slots, valid, metric,
                        staging=None if staging is None
                        else _unaligned(staging))
    assert store.data_ptr() % 16 == 0 and _unaligned(store).data_ptr() % 16
    assert torch.equal(a, b)
    want = ref.ref_gather_rank(qq.cpu(), store.cpu(), slots.cpu(),
                               valid.cpu(), metric,
                               staging=None if staging is None
                               else staging.cpu())
    torch.testing.assert_close(b.cpu(), want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_all_invalid_rows_and_clipped_slots_on_card(staged, metric):
    """Rows whose every candidate is invalid come back all +inf; negative
    slots and slots past every arena clip as the plain version clips
    them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(23)
    qq, store, staging, _, valid = _t(*staged_inputs(5, 600, 40, 3, 100,
                                                     seed=23))
    slots = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, size=(5, 600),
                                          dtype=np.int64).astype(np.int32))
    slots[:, ::3] = torch.tensor([-1, 39, 40, 42, 43])[:, None]
    valid[[1, 3]] = False
    kw = dict(staging=staging.cuda()) if staged else {}
    got = ops.gather_rank(qq.cuda(), store.cuda(), slots.cuda(),
                          valid.cuda(), metric, **kw).cpu()
    want = ref.ref_gather_rank(qq, store, slots, valid, metric,
                               **(dict(staging=staging) if staged else {}))
    assert torch.isinf(got[[1, 3]]).all()
    assert torch.equal(torch.isinf(got), ~valid)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,d", DOTS_SHAPES)
def test_rank_dots_kernel_matches_plain_on_card(q, c, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, x = _t(*dots_inputs(q, c, d, seed=q + c + d))
    got = ops.rank_dots(qq.cuda(), x.cuda()).cpu()
    torch.testing.assert_close(got, ref.ref_rank_dots(qq, x), rtol=DOTS_TOL,
                               atol=DOTS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,d", WIDE_DOTS_SHAPES)
def test_rank_dots_kernel_wide_rows_match_plain_on_card(q, c, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, x = _t(*unit_dots_inputs(q, c, d, seed=q + c + d))
    got = ops.rank_dots(qq.cuda(), x.cuda()).cpu()
    torch.testing.assert_close(got, ref.ref_rank_dots(qq, x), rtol=DOTS_TOL,
                               atol=DOTS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("q,c,d", [(3, 700, 100), (2, 50, 1024)])
def test_rank_dots_scalar_and_vector_loads_bit_identical_on_card(q, c, d):
    """A block or query that is not 16-byte aligned takes the kernel's
    scalar loads; they sum the same products in the same order as the
    16-byte loads, so the dots are equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, x = (t.cuda() for t in _t(*dots_inputs(q, c, d, seed=c + d)))
    a = ops.rank_dots(qq, x)
    assert torch.equal(a, ops.rank_dots(qq, _unaligned(x)))
    assert torch.equal(a, ops.rank_dots(_unaligned(qq), x))
    torch.testing.assert_close(a.cpu(), ref.ref_rank_dots(qq.cpu(), x.cpu()),
                               rtol=DOTS_TOL, atol=DOTS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,d", PAIR_SHAPES)
def test_pair_dist_kernel_matches_plain_on_card(q, n, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, x = _t(*pair_inputs(q, n, d, seed=q + n + d))
    got = ops.pair_dist_sq(qq.cuda(), x.cuda()).cpu()
    torch.testing.assert_close(got, ref.ref_pair_dist(qq, x), rtol=PAIR_TOL,
                               atol=PAIR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed", [(1000, 21), (4096, 22)])
def test_pair_dist_self_distances_on_card(n, seed):
    """x holds q's rows exactly, among others (unit vectors, as the
    oracle sees them): each query's distance to its own row is <= 1e-4,
    and its top-10 ids are the plain version's but across near-ties."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 100)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    rows = rng.choice(n, size=300, replace=False)
    qq, xx = _t(x[rows], x)
    got = ops.pair_dist_sq(qq.cuda(), xx.cuda()).cpu()
    want = ref.ref_pair_dist(qq, xx)
    torch.testing.assert_close(got, want, rtol=PAIR_TOL, atol=PAIR_TOL)
    assert float(got[torch.arange(300), torch.from_numpy(rows)].max()) <= 1e-4
    ids = torch.topk(-got, 10, dim=1).indices
    plain_d, plain = torch.topk(-want, 11, dim=1)
    near = (plain_d[:, 9] - plain_d[:, 10]).abs() <= 1e-5
    same = torch.tensor([set(a.tolist()) == set(b.tolist())
                         for a, b in zip(ids, plain[:, :10])])
    assert bool((same | near).all())


LEAD_IN = 256       # uncounted device spins that open a profiler session


def _device_kernels(call, *args):
    """The names of the CUDA kernels one ``call(*args)`` launches, as
    torch.profiler records them (after one warm call), and its result.
    Once one profiler session has run in a process, later ones can lose
    their first device events, now and then all of them: each session
    opens with LEAD_IN one-cycle spins (``spin_kernel``, left out of the
    names) to absorb that, and one with no event past the spins is run
    again, up to three sessions, as ``chip_smoke.kernel_ms`` does."""
    from torch.profiler import ProfilerActivity, profile
    call(*args)                                 # built and warm
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(LEAD_IN):
                torch.cuda._sleep(1)
            out = call(*args)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and "spin_kernel" not in e.name()]
        if names:
            break
    return names, out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,n", [("lsh_hash", 1024), ("lsh_hash", 4096),
                                      ("pair_dist", 700), ("rank_dots", 128),
                                      ("rank_dots", 10000)])
def test_one_call_is_one_kernel_on_card(kernel, n):
    """torch.profiler sees one CUDA kernel for one wrapper call: lsh_hash
    writes its int64 keys itself (no conversion pass), pair_dist sums its
    norms itself (no norm passes) and rank_dots stores its dots itself,
    at ZOrderIndex's 128 candidates a query and MultiProbeFlat's ~10,000."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.lsh_hash import lsh_hash_cuda
    from repro_torch.kernels.pair_dist import pair_dist_cuda
    from repro_torch.kernels.rank_candidates import rank_dots_cuda
    if kernel == "lsh_hash":
        args = tuple(t.cuda() for t in _t(*hash_inputs(n, 100, 10, seed=n)))
        call = lsh_hash_cuda
    elif kernel == "pair_dist":
        args = tuple(t.cuda() for t in _t(*pair_inputs(n, 900, 100, seed=n)))
        call = pair_dist_cuda
    else:
        args = tuple(t.cuda() for t in _t(*dots_inputs(8, n, 100, seed=n)))
        call = rank_dots_cuda
    names, out = _device_kernels(call, *args)
    assert len(names) == 1 and kernel in names[0], names
    assert out.dtype == (torch.int64 if kernel == "lsh_hash"
                         else torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,w", [(1024, 4096, 10), (70, 130, 3)])
def test_hamming_call_is_one_kernel_and_no_conversion_on_card(q, n, w):
    """One hamming_cuda call launches one hamming kernel, which reads the
    int64 keys itself: beside it only the range check's reductions run,
    and no pass converts or copies the keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.hamming import hamming_cuda
    a, b = (t.cuda() for t in _t(*key_inputs(q, n, w, seed=q + n)))
    names, out = _device_kernels(hamming_cuda, a, b)
    kernels = [k for k in names if not k.startswith(("Memcpy", "Memset"))]
    assert sum("hamming" in k for k in kernels) == 1, names
    assert not any(word in k.lower() for k in kernels
                   for word in ("copy", "where")), names
    assert out.dtype == torch.int32 and out.shape == (q, n)


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,w", HAMMING_SHAPES)
def test_hamming_kernel_exact_on_card(q, n, w):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = _t(*key_inputs(q, n, w, seed=q + n + w))
    got = ops.hamming(a.cuda(), b.cuda()).cpu()
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.ref_hamming(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("q,n,w", [(3, 7, 1), (65, 130, 10), (40, 200, 63)])
def test_hamming_kernel_high_keys_exact_on_card(q, n, w):
    """Keys at and above 2^31 (the int32 sign bit) and keys with all 32
    bits set, bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(q + n + w)
    a = rng.integers(2**31, 2**32, size=(q, w), dtype=np.uint64)
    b = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
    a[::2] = 0xFFFFFFFF
    b[::3] = 0xFFFFFFFF
    b[1::3] = 2**31
    a, b = _t(a.astype(np.int64), b.astype(np.int64))
    got = ops.hamming(a.cuda(), b.cuda()).cpu()
    assert torch.equal(got, ref.ref_hamming(a, b))
    assert (got[::2, ::3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [-1, 2**32, 2**40])
def test_hamming_rejects_keys_out_of_range_on_card(bad):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = (t.cuda() for t in _t(*key_inputs(5, 9, 3, seed=4)))
    for x, y in ((a, b), (b, a)):
        x = x.clone()
        x[-1, -1] = bad
        with pytest.raises(ValueError):
            ops.hamming(x, y)


@pytest.mark.cuda
def test_hamming_kernel_all_ones_and_identical_keys_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, _ = _t(*key_inputs(37, 1, 10, seed=9))
    ones = torch.full((5, 10), 0xFFFFFFFF, dtype=torch.int64)
    zeros = torch.zeros((3, 10), dtype=torch.int64)
    same = ops.hamming(a.cuda(), a.cuda()).cpu()
    assert (same.diagonal() == 0).all()
    assert torch.equal(same, same.T)
    assert (ops.hamming(ones.cuda(), ones.cuda()) == 0).all()
    assert (ops.hamming(ones.cuda(), zeros.cuda()) == 320).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_pairwise_rank_and_brute_force_match_plain_on_card(metric):
    """Both metrics through the two wrappers the comparators use: the
    card's answers against the CPU's plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    qq, block = _t(*dots_inputs(7, 130, 100, seed=11))
    valid = torch.from_numpy(np.random.default_rng(12).random((7, 130)) < 0.7)
    got = ops.pairwise_rank(qq.cuda(), block.cuda(), valid.cuda(),
                            metric).cpu()
    want = ops.pairwise_rank(qq, block, valid, metric)
    assert torch.equal(torch.isinf(got), ~valid)
    torch.testing.assert_close(got, want, rtol=DOTS_TOL, atol=DOTS_TOL)
    qq, x = _t(*pair_inputs(33, 1000, 100, seed=13))
    live = torch.from_numpy(np.random.default_rng(14).random(1000) < 0.8)
    idx, d = ops.brute_force_topk(qq.cuda(), x.cuda(), 10, metric,
                                  valid=live.cuda())
    widx, wd = ops.brute_force_topk(qq, x, 10, metric, valid=live)
    assert torch.equal(idx.cpu(), widx)
    torch.testing.assert_close(d.cpu(), wd, rtol=PAIR_TOL, atol=PAIR_TOL)


@pytest.mark.cuda
def test_sparse_store_writes_reads_and_frees_on_card():
    """The SparseStore lands on the card when no device is named, and a
    seeded write / read / free sequence leaves it equal, field for field,
    to the same sequence on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import store
    card, host = store.sparse_init(10, 4), store.sparse_init(10, 4, "cpu")
    assert card.idx.device.type == "cuda"
    rng = np.random.default_rng(15)
    live = []
    for _ in range(30):
        if live and rng.random() < 0.4:
            head = live.pop(int(rng.integers(len(live))))
            card = store.sparse_free(card, head, max_chain=3)
            host = store.sparse_free(host, head, max_chain=3)
        else:
            nnz = int(rng.integers(0, 13))
            idx = np.full(12, -1, np.int32)
            idx[:nnz] = rng.choice(40, nnz, replace=False)
            val = np.where(idx >= 0, rng.normal(size=12), 0).astype(np.float32)
            idx, val = _t(idx, val)
            card, ch, cok = store.sparse_write(card, idx.cuda(), val.cuda())
            host, hh, hok = store.sparse_write(host, idx, val)
            assert int(ch) == int(hh) and bool(cok) == bool(hok)
            if bool(hok):
                live.append(int(hh))
                ci, cv = store.sparse_read(card, ch, 12)
                assert torch.equal(ci.cpu(), idx) and torch.equal(cv.cpu(),
                                                                  val)
        for name, want in host._asdict().items():
            assert torch.equal(getattr(card, name).cpu(), want), name


# ----------------------------------------------------------------------
# the stream engine on the card
# ----------------------------------------------------------------------
def _stream_cfg(cold: bool):
    from repro_torch.core import PFOConfig
    kw = dict(dim=16, L=3, C=2, m=2, l=16, t=4, max_nodes_per_tree=64,
              max_leaves_per_tree=128, main_m=3, main_max_nodes_per_tree=128,
              main_max_leaves_per_tree=1024, store_capacity=8192,
              max_candidates_per_probe=16, max_candidates_total=192,
              max_snapshots=3, max_tombstones=64, bloom_bits=1 << 12,
              snap_prefix_bits=8, snap_budget_per_probe=16)
    if cold:
        kw.update(max_nodes_per_tree=48, max_leaves_per_tree=64,
                  main_max_leaves_per_tree=512, snap_budget_per_probe=64,
                  cold_segments=24, cold_cache_slots=96, cold_fetch_rounds=8)
    return PFOConfig(**kw)


def _hash_alike(proj, cfg, n, seed):
    """Seeded unit vectors whose table and partition projections all lie
    >= MARGIN from zero (float64), so the CPU and the card hash them
    alike."""
    table = proj["table_proj"].double().numpy()
    part = proj["part_proj"].double().numpy()
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        x = rng.normal(size=(4 * n, cfg.dim)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        p = x.astype(np.float64) @ table
        bits = np.where(p >= 0, 1.0, -1.0).reshape(len(x), cfg.L, 32)
        pp = np.einsum("nlm,lmc->nlc", bits, part)
        keep = (np.abs(p).min(1) >= MARGIN) & (np.abs(pp).min((1, 2))
                                               >= MARGIN)
        out.extend(x[keep])
    return np.stack(out[:n])


def _stream_trace(engine, vecs):
    """Inserts, self-queries, deletes, an update storm, a forced seal;
    returns every ticket's result in submission order."""
    tickets = [engine.insert(i, vecs[i]) for i in range(600)]
    tickets += [engine.query(vecs[i], k=5) for i in range(0, 600, 13)]
    res = engine.flush()
    engine.seal()
    for i in range(0, 600, 9):
        tickets.append(engine.delete(i))
    for r in range(3):
        for i in range(1, 40, 6):
            tickets.append(engine.update(i, vecs[600 + 10 * r + i // 6]))
    tickets += [engine.query(vecs[i], k=5) for i in range(600, 640)]
    tickets += [engine.insert(1000 + i, vecs[700 + i]) for i in range(100)]
    tickets += [engine.query(vecs[i], k=5) for i in range(700, 800, 3)]
    res.update(engine.flush())
    return [res[t] for t in tickets]


@pytest.mark.cuda
@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
@pytest.mark.parametrize("ordering", ["strict", "window"])
def test_stream_engine_on_card_matches_cpu(cold, ordering):
    """The same engine and trace on the CPU and on the card: acks, ids,
    stats and sync counts equal, distances within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import tempfile
    from repro_torch.core import PFOIndex
    from repro_torch.serving import StreamConfig, StreamEngine
    cfg = _stream_cfg(cold)
    proj = PFOIndex(cfg, seed=3, device="cpu").state.proj
    vecs = _hash_alike(proj, cfg, 800, seed=21)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cpu", "cuda"):
            eng = StreamEngine(
                PFOIndex(cfg, device=dev, proj=proj,
                         cold_dir=f"{tmp}/{dev}" if cold else None),
                StreamConfig(max_batch=64, min_batch=8, default_k=5,
                             ordering=ordering))
            out[dev] = (_stream_trace(eng, vecs), eng.stats(),
                        eng.index.sync_count, eng.index.maintenance_log)
    (cpu, cst, csync, clog), (gpu, gst, gsync, glog) = out["cpu"], out["cuda"]
    assert (cst, csync, clog) == (gst, gsync, glog)
    assert len(cpu) == len(gpu)
    for a, b in zip(cpu, gpu):
        if isinstance(a, str):
            assert a == b
            continue
        np.testing.assert_array_equal(a[0], b[0])
        fin = np.isfinite(a[1])
        np.testing.assert_array_equal(np.isfinite(b[1]), fin)
        np.testing.assert_allclose(b[1][fin], a[1][fin], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_stream_flush_after_warmup_builds_no_kernel(cold, monkeypatch):
    """warmup() builds and loads every kernel library the rounds launch:
    a flush after it loads no library and builds nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import tempfile
    from repro_torch.core import PFOIndex
    from repro_torch.kernels import _build
    from repro_torch.serving import StreamConfig, StreamEngine
    cfg = _stream_cfg(cold)
    proj = PFOIndex(cfg, seed=3, device="cpu").state.proj
    vecs = _hash_alike(proj, cfg, 800, seed=22)
    with tempfile.TemporaryDirectory() as tmp:
        eng = StreamEngine(PFOIndex(cfg, device="cuda", proj=proj,
                                    cold_dir=tmp if cold else None),
                           StreamConfig(max_batch=64, min_batch=8))
        monkeypatch.setattr(_build, "_FNS", {})
        eng.warmup()
        loaded = set(_build._FNS)
        assert {"lsh_hash", "gather_rank"} <= loaded
        assert cold == ("gather_rank_staged" in loaded)

        def no_build(*a, **kw):
            raise AssertionError("a serving round built a kernel")
        monkeypatch.setattr(_build, "build", no_build)
        ops.reset_launches()
        _stream_trace(eng, vecs)
        assert set(_build._FNS) == loaded
        ranked = "gather_rank_staged" if cold else "gather_rank"
        assert ops.LAUNCHES["lsh_hash"] > 0 and ops.LAUNCHES[ranked] > 0


# ======================================================================
# the LM serving path
# ======================================================================
#: the configs with the newer block kinds (MLA + MoE, RWKV-6, RG-LRU,
#: the encoder-decoder), whose zero-init leaves the card tests draw
FAMILIES = ["deepseek_v2_236b", "rwkv6_7b", "recurrentgemma_9b",
            "whisper_medium"]


def _lm(arch, reduced, dtype=None, device=None, seed=0):
    from repro_torch import configs
    from repro_torch.models import build_model
    cfg = configs.get_config(arch, reduced=reduced)
    if dtype is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = build_model(cfg)
    gen = torch.Generator(device=device or "cuda").manual_seed(seed)
    params = model.init(gen, device=device)
    if arch in FAMILIES:
        _chip_smoke().draw_zero_leaves(model, params, gen)
    return model, params


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, as a module (it imports no JAX
    and touches no card when imported)."""
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def _features(cfg, b, dev, seed=5):
    """Stub frame embeddings for an encoder-decoder config, else none."""
    if cfg.frontend != "audio":
        return {}
    g = torch.Generator().manual_seed(seed)
    return {"features": torch.randn((b, cfg.enc_len, cfg.d_model),
                                    generator=g).to(dev)}


@pytest.mark.cuda
def test_full_width_decode_matches_forward_on_card():
    """smollm_135m at full width in bf16: prefill, then one decode step,
    equals a full forward's last-position logits within the reference's
    own 3e-2 (tests/test_arch_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, params = _lm("smollm_135m", reduced=False)
    assert params.embed.is_cuda and params.embed.dtype == torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 17), generator=g,
                         device="cuda", dtype=torch.int32)
    cache = model.init_cache(2, 24)
    _, cache, _ = model.prefill(params, {"tokens": toks[:, :16]}, cache)
    dec, _ = model.decode_step(params, toks[:, 16:], cache, 16)
    hidden, _ = model.forward(params, {"tokens": toks})
    full = model.logits(params, hidden[:, -1:])
    torch.testing.assert_close(dec.float(), full.float(), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm_135m", "qwen2_7b"])
def test_reduced_model_cpu_equals_card(arch):
    """The same f32 weights and tokens on the CPU and on the card (no
    TF32): forward, prefill and decode logits within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    model, cpu = _lm(arch, reduced=True, dtype=torch.float32, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        params = cpu if dev == "cpu" else cpu.to("cuda")
        toks = torch.arange(24, dtype=torch.int32).reshape(2, 12) * 7 % 512
        toks = toks.to(dev)
        hidden, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(2, 16, device=dev)
        logits, cache, _ = model.prefill(params, {"tokens": toks}, cache)
        dec, _ = model.decode_step(params, toks[:, :1], cache, 12)
        out[dev] = [t.cpu() for t in (hidden, logits, dec)]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_model_cpu_equals_card(arch):
    """The newer block kinds (reduced, f32, zero-init leaves drawn): the
    same weights and tokens on the CPU and on the card (no TF32) give
    forward, prefill and decode logits within 1e-4, and the caches and
    recurrent states after the prefill within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    model, cpu = _lm(arch, reduced=True, dtype=torch.float32, device="cpu")
    out, caches = {}, {}
    for dev in ("cpu", "cuda"):
        params = cpu if dev == "cpu" else cpu.to("cuda")
        toks = torch.arange(24, dtype=torch.int32).reshape(2, 12) * 7 % 512
        batch = {"tokens": toks.to(dev), **_features(model.cfg, 2, dev)}
        hidden, _ = model.forward(params, batch)
        cache = model.init_cache(2, 16, device=dev)
        logits, cache, _ = model.prefill(params, batch, cache)
        # copies: the decode step writes the KV caches in place
        caches[dev] = [t.to("cpu", copy=True) for t in _cache_tensors(cache)]
        dec, _ = model.decode_step(params, batch["tokens"][:, :1], cache, 12)
        out[dev] = [t.cpu() for t in (hidden, logits, dec)]
    for a, b in zip(out["cpu"] + caches["cpu"], out["cuda"] + caches["cuda"]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


def _cache_tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _cache_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _cache_tensors(v)]
    return []                                   # a cache's host length


@pytest.mark.cuda
def test_lm_and_datastore_default_to_the_card():
    """A model, its cache and a datastore built with no device land on
    CUDA, and one full-width generate with the kNN head runs there,
    launching the datastore's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import PFOConfig, PFOIndex
    from repro_torch.serving import ServeConfig, ServingEngine
    model, params = _lm("smollm_135m", reduced=False)
    assert model.init_cache(1, 4)[0][0]["b0"]["kv"].k.is_cuda
    idx = PFOIndex(PFOConfig(dim=model.cfg.d_model, L=4, C=2, m=2, l=32, t=4,
                             max_candidates_total=128))
    assert idx.state.store.data.is_cuda
    g = torch.Generator(device="cuda").manual_seed(2)
    mem = torch.randn((256, model.cfg.d_model), generator=g, device="cuda")
    idx.insert(np.arange(256, dtype=np.int32), mem)
    eng = ServingEngine(model, params, ServeConfig(knn_lambda=0.3),
                        pfo_index=idx,
                        knn_vocab_map=np.arange(1024, dtype=np.int32))
    ops.reset_launches()
    toks = np.arange(32, dtype=np.int32).reshape(4, 8)
    out, stats = eng.generate({"tokens": toks}, max_new=4)
    assert out.shape == (4, 4) and stats["datastore_size"] == 260
    assert ((0 <= out) & (out < model.cfg.vocab_size)).all()
    assert ops.LAUNCHES["lsh_hash"] > 0 and ops.LAUNCHES["gather_rank"] > 0


# ======================================================================
# training
# ======================================================================
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm_135m", "llama4_scout_17b_a16e"]
                         + FAMILIES)
def test_train_steps_cpu_equal_card(arch):
    """Three f32 train steps (remat, AdamW with a master copy) of the
    same reduced model on the CPU and on the card (no TF32): losses and
    grad norms within 1e-4, every param within 1e-4 in norm, and each
    MoE call routed alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import convert
    from repro_torch.data import SyntheticLM
    from repro_torch.models import moe
    from repro_torch.models.transformer import param_dict
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import make_train_step
    assert not torch.backends.cuda.matmul.allow_tf32
    model, cpu = _lm(arch, reduced=True, dtype=torch.float32, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    data = SyntheticLM(model.cfg.vocab_size, 32, 4, seed=3)
    real = moe.routing
    runs = {}
    start = {"cpu": cpu, "cuda": convert.params_from_numpy(
        model.cfg, convert.params_to_numpy(cpu), device="cuda")}
    for dev, params in start.items():
        step = make_train_step(model, None, opt_cfg, 16)
        opt = adamw_init(opt_cfg, param_dict(params))
        metrics, routes = [], []

        def keep(p, cfg, x):
            r = real(p, cfg, x)
            routes.append((r["expert"].cpu(), r["keep"].cpu()))
            return r
        moe.routing = keep
        try:
            for i in range(3):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in data.batch(i).items()}
                batch.update(_features(model.cfg, 4, dev, seed=i))
                params, opt, m = step(params, opt, batch)
                metrics.append([float(m["loss"]), float(m["grad_norm"])])
        finally:
            moe.routing = real
        runs[dev] = (metrics, routes,
                     [t.cpu() for t in tree_leaves(param_dict(params))])
    (m0, r0, p0), (m1, r1, p1) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(m1, m0, rtol=1e-4, atol=0)
    for a, b in zip(p0, p1):
        assert float((b - a).norm() / a.norm()) <= 1e-4
    assert len(r0) == len(r1) and (len(r0) > 0) == (model.cfg.n_experts > 0)
    for (e0, k0), (e1, k1) in zip(r0, r1):
        assert torch.equal(e0, e1) and torch.equal(k0, k1)


@pytest.mark.cuda
def test_trainer_defaults_to_the_card_and_resumes(tmp_path):
    """A ``Trainer`` built with no device trains on CUDA, checkpoints,
    and a restart from its checkpoint lands on the card with the saved
    state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    cfg = configs.get_config("llama4_scout_17b_a16e", reduced=True)
    data = SyntheticLM(cfg.vocab_size, 32, 2)

    def tcfg(steps):
        return TrainConfig(steps=steps, ckpt_every=2, log_every=100,
                           ckpt_dir=str(tmp_path), loss_chunk=16,
                           opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=4))
    first = Trainer(build_model(cfg), data, tcfg(2)).run(resume=False)
    assert first["params"].embed.is_cuda and first["opt"].step.is_cuda
    out = Trainer(build_model(cfg), data, tcfg(4)).run(resume=True)
    assert len(out["losses"]) == 2 and int(out["opt"].step) == 4
    assert np.isfinite(out["losses"]).all()


# ======================================================================
# the LM stack's sharding on a one-rank NCCL DeviceMesh
# ======================================================================
@pytest.fixture
def nccl_mesh(tmp_path):
    """A one-rank NCCL group and its (data, model) = (1, 1) DeviceMesh,
    torn down after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from torch.distributed.tensor import DeviceMesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "pg"), 1), rank=0, world_size=1)
    try:
        yield DeviceMesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [
    ("smollm_135m", "gspmd"), ("llama4_scout_17b_a16e", "shardmap"),
    ("deepseek_v2_236b", "gspmd"), ("recurrentgemma_9b", "gspmd")])
def test_sharded_serving_on_one_rank_nccl(nccl_mesh, arch, impl):
    """Reduced f32: prefill and 4 decode steps with the serve policy
    (params, batch and cache placed) equal the unsharded steps within
    1e-5 relative in norm.  The shard_map MoE's prompt is 2 x 4 tokens:
    on one rank its local capacity cap2 = max(8, 2 n / E) rows then
    holds every pair (the unsharded block drops none)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serving.engine import make_decode_step, \
        make_prefill_step
    from repro_torch.sharding.policy import distribute_cache, make_policy, \
        place_params
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              dtype=torch.float32, moe_impl=impl)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    pol = make_policy(nccl_mesh, cfg, "serve", param_specs=model.param_specs)
    g = torch.Generator(device="cuda").manual_seed(1)
    t = 4 if impl == "shardmap" else 12
    toks = torch.randint(0, cfg.vocab_size, (2, t), generator=g,
                         device="cuda", dtype=torch.int32)
    nxt = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=g,
                        device="cuda", dtype=torch.int32)
    outs = []
    for sharded in (False, True):
        cache = model.init_cache(2, 16, device="cuda")
        p, batch = params, {"tokens": toks}
        prefill, decode = model.prefill, model.decode_step
        if sharded:
            p = place_params(pol, model.param_specs, params)
            cache = distribute_cache(pol, cfg, cache)
            batch = {"tokens": pol.distribute(toks, pol.batch_spec())}
            prefill = make_prefill_step(model, pol)
            decode = make_decode_step(model, pol)
        with torch.no_grad():
            logits, cache, _ = prefill(p, batch, cache)
            got = [logits]
            for i in range(4):
                tok = pol.distribute(nxt[i], pol.batch_spec()) if sharded \
                    else nxt[i]
                logits, cache = decode(p, tok, cache, t + i)
                got.append(logits)
        outs.append([t.full_tensor() if hasattr(t, "full_tensor") else t
                     for t in got])
    for a, b in zip(outs[1], outs[0]):
        assert a.is_cuda and _rel(a, b) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [("smollm_135m", "gspmd"),
                                       ("llama4_scout_17b_a16e", "shardmap")])
def test_sharded_training_on_one_rank_nccl(nccl_mesh, tmp_path, arch, impl):
    """Reduced f32: 3 ``Trainer(policy=)`` steps on the card equal the
    unsharded trainer's within 1e-5 a leaf, and the sharded checkpoint
    restores bit-equal into an unsharded trainer (the shard_map MoE on
    2 x 4-token batches, so that cap2 holds every pair)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.checkpoint.ckpt import flatten_with_paths
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding.policy import make_policy
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import restore_train_checkpoint, state_tree
    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              dtype=torch.float32, moe_impl=impl)
    model = build_model(cfg)
    seq, batch = (4, 2) if impl == "shardmap" else (16, 4)
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=3)

    def trainer(name, policy=None):
        return Trainer(model, data, TrainConfig(
            steps=3, ckpt_every=10 ** 6, log_every=10 ** 6, loss_chunk=8,
            ckpt_dir=str(tmp_path / name), opt=AdamWConfig(
                lr=1e-3, warmup_steps=1, total_steps=10)), policy=policy)

    want = trainer("plain").run(resume=False)
    pol = make_policy(nccl_mesh, cfg, "train", param_specs=model.param_specs)
    got = trainer("sharded", pol).run(resume=False)
    a = dict(flatten_with_paths(state_tree(want["params"], want["opt"])))
    b = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
         for k, v in flatten_with_paths(state_tree(got["params"],
                                                   got["opt"]))}
    assert max(_rel(b[k], a[k]) for k in a) <= 1e-5
    params, opt = trainer("sharded")._init_state()
    params, opt, _ = restore_train_checkpoint(str(tmp_path / "sharded"), 3,
                                              params, opt)
    back = dict(flatten_with_paths(state_tree(params, opt)))
    assert all(torch.equal(back[k], b[k]) for k in b)
