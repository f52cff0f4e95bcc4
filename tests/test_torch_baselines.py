"""The port's comparators (``core/baselines.py``) and SparseStore against
the JAX package's, on the same data and the same projections.

Vectors come from ``conftest.unit_vec`` (no exact distance ties, so ids
are compared exactly); each port comparator gets the ``proj`` of its JAX
twin.  Integer state (z-order values, bucket tables, forests, sparse
blocks) must be equal; distances use the reference's tolerances: 1e-4
for the brute-force oracle (``pair_dist``), 2e-5 for ranked candidates
(``rank_dots``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import unit_vec
from repro.core import baselines as jbase
from repro.core import store as jstore
from repro.core.config import PFOConfig as JConfig
from repro_torch.core import baselines, store
from repro_torch.core.config import PFOConfig

torch.set_num_threads(1)

DOTS_TOL, PAIR_TOL = 2e-5, 1e-4
#: four tables: ZOrderIndex interleaves the first four keys
KW = dict(dim=16, L=4, C=2, m=2, l=16, t=4, max_nodes_per_tree=64,
          max_leaves_per_tree=256, main_m=3, main_max_nodes_per_tree=128,
          main_max_leaves_per_tree=1024, store_capacity=8192,
          max_candidates_per_probe=16, max_candidates_total=192)
N, BATCH = 600, 200
IDS = np.arange(N, dtype=np.int32) * 3 + 1
VECS = np.stack([unit_vec(i, 0, 16) for i in range(N)])
QUERIES = np.stack([unit_vec(i, 1, 16) for i in range(20)])


def _cfgs(**kw):
    return JConfig(**{**KW, **kw}), PFOConfig(**{**KW, **kw})


def _proj(jobj) -> dict:
    return {k: np.array(v) for k, v in jobj.proj.items()}


def _insert_both(jobj, tobj, ids=IDS, vecs=VECS, check=None):
    for s in range(0, len(ids), BATCH):
        jobj.insert(ids[s:s + BATCH], vecs[s:s + BATCH])
        tobj.insert(ids[s:s + BATCH], vecs[s:s + BATCH])
        if check is not None:
            check()


def _assert_answers(got, want, tol):
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    fin = np.isfinite(np.asarray(want[1]))
    np.testing.assert_array_equal(np.isfinite(got[1]), fin)
    np.testing.assert_allclose(got[1][fin], np.asarray(want[1])[fin],
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("metric", ["angular", "l2"])
def test_brute_force_matches_jax(metric):
    jcfg, tcfg = _cfgs(metric=metric)
    j, t = jbase.BruteForce(jcfg), baselines.BruteForce(tcfg, device="cpu")
    vecs = VECS * np.linspace(0.5, 2.0, N, dtype=np.float32)[:, None]
    _insert_both(j, t, vecs=vecs)
    _assert_answers(t.query(QUERIES, 10), j.query(QUERIES, 10), PAIR_TOL)


def test_zorder_matches_jax():
    """z-order values and ids equal after every insert (the global
    stable re-sort), then the windowed answers."""
    jcfg, tcfg = _cfgs()
    j = jbase.ZOrderIndex(jcfg, seed=0)
    t = baselines.ZOrderIndex(tcfg, device="cpu", proj=_proj(j))

    def same_order():
        # the port's int64 has its sign bit flipped (unsigned order)
        z = (t.z.numpy() ^ np.int64(-2**63)).view(np.uint64)
        np.testing.assert_array_equal(z, np.asarray(j.z).astype(np.uint64))
        np.testing.assert_array_equal(t.ids.numpy(), j.ids)
        assert (np.diff(t.z.numpy()) >= 0).all()

    _insert_both(j, t, check=same_order)
    np.testing.assert_array_equal(t.vecs.numpy(), j.vecs)
    _assert_answers(t.query(QUERIES, 10), j.query(QUERIES, 10), DOTS_TOL)


def test_multiprobe_matches_jax():
    """Bucket tables exactly (first come first kept, buckets filled past
    ``bucket_cap``), vectors by id with the last write winning (duplicate
    ids in a batch, an id re-inserted later), then the answers."""
    jcfg, tcfg = _cfgs()
    j = jbase.MultiProbeFlat(jcfg, seed=0, bucket_bits=4, bucket_cap=16)
    t = baselines.MultiProbeFlat(tcfg, bucket_bits=4, bucket_cap=16,
                                 device="cpu", proj=_proj(j))
    ids = IDS.copy()
    ids[BATCH + 5:BATCH + 9] = ids[BATCH]       # duplicates in one batch
    ids[-1] = ids[3]                            # a later re-insert

    def same_tables():
        np.testing.assert_array_equal(t.bucket_ids.numpy(), j.bucket_ids)
        np.testing.assert_array_equal(t.bucket_fill.numpy(), j.bucket_fill)

    _insert_both(j, t, ids=ids, check=same_tables)
    assert j.bucket_fill.max() == 16            # some bucket overflowed
    assert t.vec_ids.numpy().tolist() == sorted(j.vec_by_id)
    for vid, row in zip(t.vec_ids.numpy(), t.vec_rows.numpy()):
        np.testing.assert_array_equal(row, j.vec_by_id[int(vid)])
    _assert_answers(t.query(QUERIES, 10), j.query(QUERIES, 10), DOTS_TOL)


def test_multiprobe_pads_rows_with_few_candidates():
    """Fewer stored items than k: the reference's -1 / +inf pads."""
    jcfg, tcfg = _cfgs()
    j = jbase.MultiProbeFlat(jcfg, seed=0)
    t = baselines.MultiProbeFlat(tcfg, device="cpu", proj=_proj(j))
    _insert_both(j, t, ids=IDS[:6], vecs=VECS[:6])
    got, want = t.query(QUERIES, 10), j.query(QUERIES, 10)
    assert (got[0] == -1).any() and np.isinf(got[1]).any()
    _assert_answers(got, want, DOTS_TOL)


def test_serialized_pfo_forest_matches_jax():
    """Every TreeState field equal after the global sequential apply."""
    jcfg, tcfg = _cfgs()
    j = jbase.SerializedPFO(jcfg, seed=0)
    t = baselines.SerializedPFO(tcfg, device="cpu", proj=_proj(j))
    j.insert(IDS[:BATCH], VECS[:BATCH])
    t.insert(IDS[:BATCH], VECS[:BATCH])
    assert int(np.asarray(j.forest.node_cnt).max()) > 1     # spreads ran
    for name, want in j.forest._asdict().items():
        np.testing.assert_array_equal(
            getattr(t.forest, name).numpy(),
            np.asarray(want).astype(np.int64), err_msg=name)


@pytest.mark.parametrize("make", [
    lambda: baselines.BruteForce(PFOConfig(**KW)),
    lambda: baselines.ZOrderIndex(PFOConfig(**KW)),
    lambda: baselines.MultiProbeFlat(PFOConfig(**KW)),
    lambda: baselines.SerializedPFO(PFOConfig(**KW)),
    lambda: store.sparse_init(n_blocks=8, granule=4),
], ids=["BruteForce", "ZOrderIndex", "MultiProbeFlat", "SerializedPFO",
        "sparse_init"])
def test_entry_points_default_to_cuda(make):
    """With no device named, every entry point lands on the card, and
    raises where there is none (as ``PFOIndex`` does)."""
    if torch.cuda.is_available():
        made = make()
        dev = made.idx.device if hasattr(made, "idx") else made.device
        assert dev.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


# ----------------------------------------------------------------------
# SparseStore (the cases of tests/test_dispatch_store.py, then a random
# sequence against the JAX package field by field)
# ----------------------------------------------------------------------
def test_sparse_store_roundtrip_and_chaining():
    stt = store.sparse_init(n_blocks=16, granule=4, device="cpu")
    idxs = torch.tensor([0, 3, 9, 11, 15, -1, -1, -1], dtype=torch.int32)
    vals = torch.tensor([1., 2., 3., 4., 5., 0, 0, 0])
    stt, head, ok = store.sparse_write(stt, idxs, vals)
    assert bool(ok)
    ri, rv = store.sparse_read(stt, head, 8)
    dense = store.sparse_to_dense(ri, rv, 16)
    assert float(dense[3]) == 2.0 and float(dense[15]) == 5.0
    free_before = int(stt.n_free)
    stt = store.sparse_free(stt, head, max_chain=4)
    assert int(stt.n_free) == free_before + 2   # 5 nnz / granule 4 -> 2


def test_sparse_store_size_class_reuse():
    stt = store.sparse_init(n_blocks=8, granule=4, device="cpu")
    idxs = torch.tensor([1, 2, -1, -1], dtype=torch.int32)
    vals = torch.tensor([1., 1., 0., 0.])
    stt, h1, _ = store.sparse_write(stt, idxs, vals)
    stt = store.sparse_free(stt, h1, max_chain=2)
    stt, h2, _ = store.sparse_write(stt, idxs, vals)
    assert int(h2) == int(h1)                   # freed block reused


def _assert_sparse_equal(t, j):
    for name, want in j._asdict().items():
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(want), err_msg=name)


def test_sparse_store_random_sequence_matches_jax():
    """Writes of 0..12 nonzeros (granule 4, max_nnz 12) and frees in a
    seeded order, past the point where the free list runs dry (a write
    that does not fit returns not-ok): every field, head and read-back
    equal after each step."""
    rng = np.random.default_rng(3)
    n_blocks, granule, max_nnz, dim = 10, 4, 12, 40
    j, t = jstore.sparse_init(n_blocks, granule), store.sparse_init(
        n_blocks, granule, device="cpu")
    live = []
    saw_full = False
    for _ in range(40):
        if live and rng.random() < 0.4:
            head = live.pop(int(rng.integers(len(live))))
            j = jstore.sparse_free(j, jnp.int32(head), max_chain=3)
            t = store.sparse_free(t, head, max_chain=3)
        else:
            nnz = int(rng.integers(0, max_nnz + 1))
            idx = np.full(max_nnz, -1, np.int32)
            idx[:nnz] = rng.choice(dim, nnz, replace=False)
            val = np.where(idx >= 0, rng.normal(size=max_nnz), 0).astype(
                np.float32)
            j, jh, jok = jstore.sparse_write(j, jnp.asarray(idx),
                                             jnp.asarray(val))
            t, th, tok = store.sparse_write(t, torch.from_numpy(idx),
                                            torch.from_numpy(val))
            assert int(th) == int(jh) and bool(tok) == bool(jok)
            saw_full |= not bool(jok)
            if bool(jok):
                live.append(int(th))
                ri, rv = store.sparse_read(t, th, max_nnz)
                jri, jrv = jstore.sparse_read(j, jh, max_nnz)
                np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))
                np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
                np.testing.assert_allclose(
                    store.sparse_to_dense(ri, rv, dim).numpy(),
                    np.asarray(jstore.sparse_to_dense(jri, jrv, dim)))
        _assert_sparse_equal(t, j)
    assert saw_full
