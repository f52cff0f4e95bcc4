"""The port's kernels against the JAX package.

On the CPU each wrapper takes its plain version, so these tests hold the
plain versions against the JAX package's kernels (run in interpret mode
on the CPU, as its own tests run them) on the shape sweeps of
``tests/test_kernels.py`` plus d = 100.  ``lsh_hash`` and ``hamming``
must be exact (``lsh_hash``'s inputs keep every projection at least 1e-4
from zero in float64, so a different float summation order cannot flip
a sign); ``gather_rank`` and ``rank_dots`` use the reference's own
tolerance, 2e-5, and ``pair_dist`` its 1e-4.

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
holds them against the plain versions there and skips elsewhere.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import unit_vec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from test_torch_cuda import (DOTS_SHAPES, DOTS_TOL, HAMMING_SHAPES,
                             HASH_SHAPES, PAIR_SHAPES, PAIR_TOL, RANK_SHAPES,
                             STAGED_SHAPES, TOL, WIDE_DOTS_SHAPES, _t,
                             dots_inputs, hash_inputs, key_inputs, pair_inputs,
                             rank_inputs, staged_inputs, unit_dots_inputs)
from repro_torch.kernels import _build, ops, ref

torch.set_num_threads(1)

@pytest.mark.parametrize("n,d,tables", HASH_SHAPES)
def test_lsh_hash_matches_jax(n, d, tables):
    x, a = hash_inputs(n, d, tables, seed=n * 31 + d)
    want = np.asarray(jops.lsh_hash(jnp.asarray(x), jnp.asarray(a)))
    got = ops.lsh_hash(*_t(x, a))
    assert got.shape == (n, tables) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize("q,c,n,d", RANK_SHAPES)
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_gather_rank_matches_jax(q, c, n, d, metric):
    qq, store, slots, valid = rank_inputs(q, c, n, d, seed=q + 7 * c + n)
    want = np.asarray(jops.gather_rank(jnp.asarray(qq), jnp.asarray(store),
                                       jnp.asarray(slots), jnp.asarray(valid),
                                       metric))
    got = ops.gather_rank(*_t(qq, store, slots, valid), metric).numpy()
    np.testing.assert_array_equal(np.isinf(got), ~valid)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_gather_rank_all_masked_rows_are_inf():
    qq, store, slots, _ = rank_inputs(4, 6, 11, 9, seed=61)
    valid = np.zeros((4, 6), bool)
    valid[1] = True                            # rows 0, 2, 3 all masked
    d = ops.gather_rank(*_t(qq, store, slots, valid), "angular").numpy()
    assert np.isinf(d[[0, 2, 3]]).all() and np.isfinite(d[1]).all()


@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_gather_rank_duplicate_and_out_of_range_slots(metric):
    """Duplicate slots rank equal; slots outside the store clip to its
    ends, as the JAX kernel clips them."""
    qq, store, _, _ = rank_inputs(2, 4, 20, 12, seed=71)
    slots = np.asarray([[3, 3, 3, 7], [-5, 19, 0, 40]], np.int32)
    valid = np.ones((2, 4), bool)
    d = ops.gather_rank(*_t(qq, store, slots, valid), metric).numpy()
    assert d[0, 0] == d[0, 1] == d[0, 2]
    assert d[1, 0] == d[1, 2] and d[1, 1] == d[1, 3]
    want = np.asarray(jops.gather_rank(jnp.asarray(qq), jnp.asarray(store),
                                       jnp.asarray(slots), jnp.asarray(valid),
                                       metric))
    np.testing.assert_allclose(d, want, rtol=TOL, atol=TOL)


def test_gather_rank_topk_matches_jax():
    qq, store, slots, valid = rank_inputs(5, 24, 64, 16, seed=81)
    for metric in ("angular", "l2"):
        jidx, jd = jops.gather_rank_topk(jnp.asarray(qq), jnp.asarray(store),
                                         jnp.asarray(slots),
                                         jnp.asarray(valid), 4, metric)
        idx, d = ops.gather_rank_topk(*_t(qq, store, slots, valid), 4, metric)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_staging_arena_matches_jax_ref(metric):
    """The plain version keeps the cold tier's staging argument: slots
    land in both arenas (past the store's end, and past the staging
    arena's, which clips), held against the JAX package's ref and its
    staged kernel."""
    qq, store, slots, valid = rank_inputs(3, 10, 8, 6, seed=91)
    staging = np.random.default_rng(92).normal(size=(5, 6)).astype(np.float32)
    slots = slots + 3 * (np.arange(10) % 2)    # some slots past the store
    slots[:, -1] = 8 + 9                       # past the staging arena
    assert (slots >= 8).any() and (slots < 8).any()
    args = (jnp.asarray(qq), jnp.asarray(store), jnp.asarray(slots),
            jnp.asarray(valid), metric)
    want = np.asarray(jops.ref.ref_gather_rank(
        *args, staging=jnp.asarray(staging)))
    got = ops.gather_rank(*_t(qq, store, slots, valid), metric,
                          staging=torch.from_numpy(staging)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    kern = np.asarray(jops.gather_rank(*args, staging=jnp.asarray(staging)))
    np.testing.assert_allclose(got, kern, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q,c,n,m,d", STAGED_SHAPES)
@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_gather_rank_staged_matches_jax(q, c, n, m, d, metric):
    """The card tests' staged sweep (both arenas, clipped and masked
    slots, a one-row arena) through the plain version against the JAX
    package's staged kernel."""
    qq, store, staging, slots, valid = staged_inputs(q, c, n, m, d,
                                                     seed=q + 5 * c + m)
    want = np.asarray(jops.gather_rank(
        jnp.asarray(qq), jnp.asarray(store), jnp.asarray(slots),
        jnp.asarray(valid), metric, staging=jnp.asarray(staging)))
    got = ops.gather_rank(*_t(qq, store, slots, valid), metric,
                          staging=torch.from_numpy(staging)).numpy()
    np.testing.assert_array_equal(np.isinf(got), ~valid)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q,c,d", DOTS_SHAPES)
def test_rank_dots_matches_jax(q, c, d):
    """The plain version against the JAX package's ref and its kernel."""
    qq, x = dots_inputs(q, c, d, seed=q + 3 * c + d)
    got = ops.rank_dots(*_t(qq, x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.ref_rank_dots(qq, x)),
                               rtol=DOTS_TOL, atol=DOTS_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.rank_dots(
        jnp.asarray(qq), jnp.asarray(x))), rtol=DOTS_TOL, atol=DOTS_TOL)


@pytest.mark.parametrize("q,c,d", WIDE_DOTS_SHAPES)
def test_rank_dots_wide_rows_match_jax(q, c, d):
    """Past one pass of the kernel's lanes, on unit rows (see
    ``unit_dots_inputs``): the plain version against the JAX package's
    ref and its kernel."""
    qq, x = unit_dots_inputs(q, c, d, seed=q + 3 * c + d)
    got = ops.rank_dots(*_t(qq, x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jref.ref_rank_dots(qq, x)),
                               rtol=DOTS_TOL, atol=DOTS_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.rank_dots(
        jnp.asarray(qq), jnp.asarray(x))), rtol=DOTS_TOL, atol=DOTS_TOL)


@pytest.mark.parametrize("q,n,d", PAIR_SHAPES)
def test_pair_dist_matches_jax(q, n, d):
    qq, x = pair_inputs(q, n, d, seed=q + 5 * n + d)
    got = ops.pair_dist_sq(*_t(qq, x)).numpy()
    assert got.shape == (q, n) and (got >= 0).all()
    np.testing.assert_allclose(got, np.asarray(jref.ref_pair_dist(qq, x)),
                               rtol=PAIR_TOL, atol=PAIR_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.pair_dist_sq(
        jnp.asarray(qq), jnp.asarray(x))), rtol=PAIR_TOL, atol=PAIR_TOL)


@pytest.mark.parametrize("q,n,w", HAMMING_SHAPES)
def test_hamming_matches_jax_exactly(q, n, w):
    """Keys as the port carries them (int64 in [0, 2^32)), against the
    JAX package's uint32 ref and kernel, bit for bit."""
    a, b = key_inputs(q, n, w, seed=q + 7 * n + w)
    got = ops.hamming(*_t(a, b))
    assert got.dtype == torch.int32
    ja, jb = jnp.asarray(a.astype(np.uint32)), jnp.asarray(b.astype(np.uint32))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.ref_hamming(ja, jb)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.hamming(ja, jb)))
    same = ops.hamming(*_t(a, a)).numpy()
    assert (np.diag(same) == 0).all()


@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_pairwise_rank_matches_jax(metric):
    qq, x = dots_inputs(9, 130, 65, seed=17)
    valid = np.random.default_rng(18).random((9, 130)) < 0.7
    want = np.asarray(jops.pairwise_rank(jnp.asarray(qq), jnp.asarray(x),
                                         jnp.asarray(valid), metric))
    got = ops.pairwise_rank(*_t(qq, x, valid), metric).numpy()
    np.testing.assert_array_equal(np.isinf(got), ~valid)
    np.testing.assert_allclose(got, want, rtol=DOTS_TOL, atol=DOTS_TOL)


@pytest.mark.parametrize("metric", ["angular", "l2"])
@pytest.mark.parametrize("masked", [False, True])
def test_brute_force_topk_matches_jax(metric, masked):
    """Unit vectors (``conftest.unit_vec``): no exact ties, so ids are
    equal, not just distances."""
    x = np.stack([unit_vec(i, 0, 32) for i in range(300)])
    qq = np.stack([unit_vec(i, 1, 32) for i in range(40)])
    if metric == "l2":
        x = x * np.linspace(0.5, 2.0, 300, dtype=np.float32)[:, None]
    valid = (np.arange(300) % 3 != 0) if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    jidx, jd = jops.brute_force_topk(jnp.asarray(qq), jnp.asarray(x), 10,
                                     metric, valid=jv)
    idx, d = ops.brute_force_topk(*_t(qq, x), 10, metric,
                                  valid=None if valid is None else
                                  torch.from_numpy(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=PAIR_TOL,
                               atol=PAIR_TOL)


def test_cpu_tensors_take_the_plain_version():
    ops.reset_launches()
    x, a = hash_inputs(9, 16, 2, seed=5)
    assert torch.equal(ops.lsh_hash(*_t(x, a)), ref.ref_lsh_hash(*_t(x, a)))
    qq, store, slots, valid = rank_inputs(3, 5, 7, 16, seed=6)
    args = _t(qq, store, slots, valid)
    assert torch.equal(ops.gather_rank(*args, "l2"),
                       ref.ref_gather_rank(*args, "l2"))
    assert torch.equal(ops.gather_rank(*args, "l2", staging=args[1]),
                       ref.ref_gather_rank(*args, "l2", staging=args[1]))
    qq, x = _t(*pair_inputs(3, 5, 16, seed=7))
    assert torch.equal(ops.pair_dist_sq(qq, x), ref.ref_pair_dist(qq, x))
    qq, block = _t(*dots_inputs(3, 5, 16, seed=8))
    assert torch.equal(ops.rank_dots(qq, block), ref.ref_rank_dots(qq, block))
    a, b = _t(*key_inputs(3, 5, 2, seed=9))
    assert torch.equal(ops.hamming(a, b), ref.ref_hamming(a, b))
    assert ops.LAUNCHES == {"lsh_hash": 0, "gather_rank": 0,
                            "gather_rank_staged": 0, "pair_dist": 0,
                            "rank_dots": 0, "hamming": 0}


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel or raises; here
    a meta tensor, which no kernel takes."""
    x = torch.empty((4, 8), device="meta")
    a = torch.empty((8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.lsh_hash(x, a)
    s = torch.empty((4, 3), dtype=torch.int32, device="meta")
    v = torch.empty((4, 3), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.gather_rank(x, a.t(), s, v, "l2")
    with pytest.raises(ValueError, match="CUDA"):
        ops.pair_dist_sq(x, a.t())
    with pytest.raises(ValueError, match="CUDA"):
        ops.rank_dots(x, torch.empty((4, 3, 8), device="meta"))
    keys = torch.empty((4, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.hamming(keys, keys)


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    p1 = _build._lib_path("lsh_hash")
    assert p1 == _build._lib_path("lsh_hash")
    assert p1.parent == _build.BUILD_DIR and p1.name.startswith("lsh_hash-")
    assert p1 != _build._lib_path("gather_rank")
    # without nvcc the build raises; it never falls back to anything
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["lsh_hash"])


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """An edited shared header renames every library, so a stale build is
    never loaded (edits a copy of csrc, not the real one)."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._lib_path(name) for name in ("lsh_hash",
                                                         "pair_dist")}
    assert before["lsh_hash"] == _build._lib_path("lsh_hash")
    header = csrc / "f32_product.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, path in before.items():
        assert _build._lib_path(name) != path
        assert _build._lib_path(name).name.startswith(f"{name}-")


def test_ptxas_report_parses_each_kernel():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN37_INTERNAL_5ff38615_11_lsh_hash_cu_5ff3861515lsh_hash_kernel"
        "ILi5EEEvPKfS2_' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 128 bytes smem,"
        " 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116pair_dist_kernelEPKfS1_' for 'sm_90a'\n"
        "ptxas info    : Function properties for y\n"
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 127 registers, 400 bytes cmem[0]\n")
    rows = _build.parse_ptxas(log, "src")
    assert [r["kernel"] for r in rows] == [
        "_ZN37_INTERNAL_5ff38615_11_lsh_hash_cu_5ff3861515lsh_hash_kernel"
        "ILi5EEEvPKfS2_", "_ZN12_GLOBAL__N_116pair_dist_kernelEPKfS1_"]
    assert [r["registers"] for r in rows] == [96, 127]
    assert [r["static_smem_bytes"] for r in rows] == [128, 0]
    assert [(r["spill_store_bytes"], r["spill_load_bytes"])
            for r in rows] == [(0, 0), (4, 8)]
