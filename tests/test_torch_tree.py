"""The port's hash forest, Bloom filters and sealed ring against the JAX
package's, bit for bit.

Hash trees: the same mailboxes are replayed into both forests — inserts
that spread buckets, exhaust the node and leaf arenas and grow long
chains of equal keys at the deepest level, then deletes (found, missing,
duplicated) — after which every ``TreeState`` field and every masked
query and lookup must be equal.  Snapshots: after ``seal``, ``probe``,
``lookup_exact``, ``merge`` and ``pop_oldest`` every field must be
equal, with keys near 0xFFFFFFFF in play.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_pfo_config
from repro.core import bloom as jbloom
from repro.core import hash_tree as jtree
from repro.core import snapshots as jsnap
from repro_torch.core import bloom, hash_tree, snapshots
from repro_torch.core.config import PFOConfig

torch.set_num_threads(1)

T, K = 4, 24


def _tree_cfg(mod, **kw):
    base = dict(skip_bits=2, log2_l=4, l=16, t=3, max_depth=7, max_nodes=12,
                max_leaves=64, max_candidates=8)
    base.update(kw)
    return mod.TreeConfig(**base)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_forest_equal(tf, jf):
    for name, a in jf._asdict().items():
        got = _np(getattr(tf, name))
        want = np.asarray(a)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(
        np.int64 if np.asarray(a).dtype == np.uint32 else np.asarray(a).dtype)))


def _mailboxes(rng, rounds):
    """(rounds, T, K) keys and ids: random keys, some repeated many times
    (deep equal-key chains), -1 padding slots."""
    keys = rng.integers(0, 2**32, size=(rounds, T, K),
                        dtype=np.uint64).astype(np.uint32)
    hot = rng.integers(0, 2**32, size=3, dtype=np.uint64).astype(np.uint32)
    pick = rng.random((rounds, T, K)) < 0.3
    keys[pick] = hot[rng.integers(0, 3, size=int(pick.sum()))]
    keys[..., :2] = np.uint32(0xFFFFFFFF)
    ids = rng.integers(0, 200, size=(rounds, T, K)).astype(np.int32)
    ids[rng.random((rounds, T, K)) < 0.15] = -1
    return keys, ids


@pytest.mark.parametrize("seed", [0, 1])
def test_forest_insert_delete_replay_exact(seed):
    rng = np.random.default_rng(seed)
    jcfg, tcfg = _tree_cfg(jtree), _tree_cfg(hash_tree)
    jf = jtree.init_forest(jcfg, T)
    tf = hash_tree.init_forest(tcfg, T)
    keys, ids = _mailboxes(rng, 3)
    vals = rng.integers(0, 1000, size=ids.shape).astype(np.int32)
    for r in range(len(keys)):
        jf = jtree.forest_insert_dispatched(
            jf, jnp.asarray(keys[r]), jnp.asarray(ids[r]), jnp.asarray(vals[r]),
            jcfg)
        hash_tree.forest_insert_dispatched(tf, _t(keys[r]), _t(ids[r]),
                                           _t(vals[r]), tcfg)
        _assert_forest_equal(tf, jax.device_get(jf))
    assert int(np.asarray(jf.overflow).sum()) > 0          # arenas ran out
    assert int(np.asarray(jf.node_cnt).max()) == tcfg.max_nodes

    # deletes: inserted (key, id) pairs (duplicates included: the newest
    # goes first), ids under a wrong key, and padding
    for r in range(len(keys)):
        dk, di = keys[r].copy(), ids[r].copy()
        wrong = rng.random(di.shape) < 0.2
        dk[wrong] ^= np.uint32(0x00F00000)
        di[rng.random(di.shape) < 0.1] = -1
        jf = jtree.forest_delete_dispatched(jf, jnp.asarray(dk),
                                            jnp.asarray(di), jcfg)
        hash_tree.forest_delete_dispatched(tf, _t(dk), _t(di), tcfg)
        _assert_forest_equal(tf, jax.device_get(jf))

    # re-insert into the freed leaves, then read
    jf = jtree.forest_insert_dispatched(
        jf, jnp.asarray(keys[0]), jnp.asarray(ids[0]), jnp.asarray(vals[0]),
        jcfg)
    hash_tree.forest_insert_dispatched(tf, _t(keys[0]), _t(ids[0]),
                                       _t(vals[0]), tcfg)
    _assert_forest_equal(tf, jax.device_get(jf))
    qk = np.concatenate([keys[:, :, :8].reshape(-1),
                         rng.integers(0, 2**32, 20, dtype=np.uint64)
                         .astype(np.uint32)])
    qt = rng.integers(0, T, size=qk.shape).astype(np.int32)
    qid = np.concatenate([ids[:, :, :8].reshape(-1),
                          rng.integers(0, 200, 20).astype(np.int32)])
    for sib in (False, True):
        jc, tc = _tree_cfg(jtree, sibling_probe=sib), \
            _tree_cfg(hash_tree, sibling_probe=sib)
        want = jtree.forest_query_masked(jf, jnp.asarray(qt), jnp.asarray(qk),
                                         jc)
        got = hash_tree.forest_query_masked(tf, _t(qt), _t(qk), tc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    want = jtree.forest_lookup_masked(jf, jnp.asarray(qt), jnp.asarray(qk),
                                      jnp.asarray(qid), jcfg)
    got = hash_tree.forest_lookup_masked(tf, _t(qt), _t(qk), _t(qid), tcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert [int(x) for x in hash_tree.forest_headroom(tf)] == \
        [int(x) for x in jtree.forest_headroom(jf)]


def test_loop_traversal_is_refused():
    with pytest.raises(NotImplementedError, match="masked"):
        hash_tree.init_forest(_tree_cfg(hash_tree, traversal="loop"), 2)


# ----------------------------------------------------------------------
# bloom
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_hashes,bits", [(1, 64), (3, 1024), (7, 4096)])
def test_bloom_build_and_probe_exact(n_hashes, bits):
    rng = np.random.default_rng(n_hashes)
    keys = rng.integers(0, 2**32, size=(2, 300), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[:, :3] = [0, 0xFFFFFFFE, 0xFFFFFFFF]
    mask = rng.random((2, 300)) < 0.6
    got = bloom.build(_t(keys), n_hashes, bits, mask=torch.from_numpy(mask))
    for b in range(2):
        want = jbloom.build(jnp.asarray(keys[b]), n_hashes, bits,
                            mask=jnp.asarray(mask[b]))
        np.testing.assert_array_equal(_np(got[b]).astype(np.uint32),
                                      np.asarray(want))
    probes = np.concatenate([keys[0], rng.integers(0, 2**32, 100,
                                                   dtype=np.uint64)
                             .astype(np.uint32)])
    jwords = jnp.asarray(_np(got).astype(np.uint32))
    np.testing.assert_array_equal(
        _np(bloom.contains(got[0], _t(probes), n_hashes)),
        np.asarray(jbloom.contains(jwords[0], jnp.asarray(probes), n_hashes)))
    np.testing.assert_array_equal(
        _np(bloom.contains_multi(got[None], _t(probes)[None], n_hashes))[0],
        np.asarray(jbloom.contains_multi(jwords, jnp.asarray(probes),
                                         n_hashes)))


# ----------------------------------------------------------------------
# snapshots
# ----------------------------------------------------------------------
def _snap_cfg(**kw):
    base = dict(max_snapshots=4, snapshot_capacity=96, snap_prefix_bits=6,
                snap_budget_per_probe=8, bloom_bits=1 << 10)
    base.update(kw)
    jcfg = small_pfo_config(**base)
    return jcfg, PFOConfig(**jcfg.__dict__)


def _assert_snaps_equal(ts, js):
    for name, a in js._asdict().items():
        np.testing.assert_array_equal(_np(getattr(ts, name)).astype(np.int64),
                                      np.asarray(a).astype(np.int64),
                                      err_msg=name)


def _segment(rng, n, id_lo):
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    keys[:6] = [0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFF00, 0xFC000000, 0, 5]
    ids = rng.integers(id_lo, id_lo + 60, size=n).astype(np.int32)
    vals = rng.integers(0, 1000, size=n).astype(np.int32)
    mask = rng.random(n) < 0.85
    return keys, ids, vals, mask


@pytest.mark.parametrize("probes", [1, 3])
def test_snapshot_ring_exact(probes):
    """seal x3 -> probe -> lookup_exact -> merge with tombstones ->
    probe -> pop_oldest, every field equal along the way."""
    rng = np.random.default_rng(probes)
    jcfg, tcfg = _snap_cfg(snap_probes=probes)
    js = jsnap.init_snapshots(jcfg)
    ts = snapshots.one(snapshots.unbatch(snapshots.init_snapshots(tcfg)))
    for stamp in (1, 2, 3):
        keys, ids, vals, mask = _segment(rng, 80, id_lo=20 * stamp)
        js = jsnap.seal(js, jnp.asarray(keys), jnp.asarray(ids),
                        jnp.asarray(vals), jnp.asarray(mask),
                        jnp.int32(stamp), jcfg)
        ts = snapshots.seal(ts, _t(keys)[None], _t(ids)[None], _t(vals)[None],
                            torch.from_numpy(mask)[None],
                            torch.tensor(stamp, dtype=torch.int32), tcfg)
        _assert_snaps_equal(snapshots.unbatch(ts), js)

    qk = np.concatenate([keys[:30], [0xFFFFFFFF, 0xFFFFFFF0, 0]]).astype(
        np.uint32)

    def check_probe():
        jc, jv = jsnap.probe(js, jnp.asarray(qk), jcfg)
        tc, tv = snapshots.probe(ts, _t(qk)[None], tcfg)
        np.testing.assert_array_equal(_np(tc[0]), np.asarray(jc))
        np.testing.assert_array_equal(_np(tv[0]), np.asarray(jv))

    check_probe()
    mcfg_j, mcfg_t = _snap_cfg(snap_probes=1)
    qid = np.concatenate([ids[:30], [-1, 5, 90]]).astype(np.int32)
    jval, jfound = jax.vmap(lambda h, i: jsnap.lookup_exact(
        js, h, i, mcfg_j))(jnp.asarray(qk), jnp.asarray(qid))
    tval, tfound = snapshots.lookup_exact(ts, _t(qk), _t(qid), mcfg_t)
    np.testing.assert_array_equal(_np(tval), np.asarray(jval))
    np.testing.assert_array_equal(_np(tfound), np.asarray(jfound))

    tombs = np.concatenate([ids[:10], [-1, -1]]).astype(np.int32)
    js = jsnap.merge(js, jcfg, jnp.asarray(tombs))
    ts = snapshots.merge(ts, tcfg, _t(tombs))
    _assert_snaps_equal(snapshots.unbatch(ts), js)
    check_probe()

    js, jpop = jsnap.pop_oldest(js, jcfg)
    ts, tpop = snapshots.pop_oldest(ts, tcfg)
    _assert_snaps_equal(snapshots.unbatch(ts), js)
    for k, v in jpop.items():
        np.testing.assert_array_equal(_np(tpop[k][0]).astype(np.int64),
                                      np.asarray(v).astype(np.int64))


def test_probe_prefixes_exact():
    jcfg, tcfg = _snap_cfg(snap_probes=4)
    keys = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF], np.uint32)
    np.testing.assert_array_equal(
        _np(snapshots.probe_prefixes(_t(keys), tcfg)),
        np.asarray(jsnap.probe_prefixes(jnp.asarray(keys), jcfg)))
