"""The port's lsh, dispatch, store and membership modules against the
JAX package's, bit for bit, on seeded numpy inputs (ids of -1 and the
int32 extremes, duplicate frees, a full store)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import small_pfo_config
from repro.core import config as jconfig
from repro.core import dispatch as jdispatch
from repro.core import lsh as jlsh
from repro.core import membership as jmember
from repro.core import store as jstore
from repro_torch.core import config as tconfig
from repro_torch.core import dispatch, lsh, membership, store

torch.set_num_threads(1)

I32 = np.iinfo(np.int32)
EDGE_IDS = np.array([-1, 0, 1, I32.min, I32.max, I32.min + 1, I32.max - 1,
                     -2, 123456789], np.int32)


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def _u32(rng, n):
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    keys[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    return keys


# ----------------------------------------------------------------------
# config
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{}, dict(bloom_bits=0, snapshot_capacity=300),
                                dict(dim=100, max_nodes_per_tree=512,
                                     max_leaves_per_tree=4096,
                                     main_max_nodes_per_tree=1024,
                                     main_max_leaves_per_tree=16384,
                                     store_capacity=1 << 20)])
def test_config_fields_and_derived_properties_equal(kw):
    j = jconfig.PFOConfig(**kw)
    t = tconfig.PFOConfig(**kw)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("log2_l", "n_partitions", "trees_per_partition", "n_trees",
                 "main_n_trees", "max_depth", "main_max_depth",
                 "cold_enabled", "bloom_keys_expected", "bloom_bits_eff",
                 "bloom_hashes_eff"):
        assert getattr(j, prop) == getattr(t, prop), prop


# ----------------------------------------------------------------------
# lsh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_murmur_fmix32_exact(seed):
    rng = np.random.default_rng(seed)
    keys = _u32(rng, 500)
    for s in (0, 7, 12345):
        _eq(lsh.murmur3_fmix32(torch.from_numpy(keys.astype(np.int64)), s),
            jlsh.murmur3_fmix32(jnp.asarray(keys), s))
    _eq(lsh.murmur3_fmix32(torch.from_numpy(EDGE_IDS)),
        jlsh.murmur3_fmix32(jnp.asarray(EDGE_IDS).astype(jnp.uint32)))


@pytest.mark.parametrize("start,width", [(0, 4), (4, 7), (25, 7), (0, 32),
                                         (31, 1), (6, 0)])
def test_key_bits_exact(start, width):
    """Equal bits (the reference returns them as int32, the port as
    non-negative int64, so a full 32-bit field is compared as uint32)."""
    keys = _u32(np.random.default_rng(start + width), 300)
    want = np.asarray(jlsh.key_bits(jnp.asarray(keys), start, width))
    _eq(lsh.key_bits(torch.from_numpy(keys.astype(np.int64)), start, width),
        want.astype(np.uint32))


def test_llcp_and_bit_packing_exact():
    rng = np.random.default_rng(9)
    a, b = _u32(rng, 400), _u32(rng, 400)
    b[10:20] = a[10:20]                         # equal keys: llcp 32
    b[20:30] = a[20:30] ^ 1                     # differ only in the LSB
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    _eq(lsh.llcp_int(ta, tb), jlsh.llcp_int(jnp.asarray(a), jnp.asarray(b)))
    for width in (32, 5):
        bits = lsh.unpack_bits_msb(ta, width)
        _eq(bits, jlsh.unpack_bits_msb(jnp.asarray(a), width))
    _eq(lsh.pack_bits_msb(lsh.unpack_bits_msb(ta)), a)


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_partition_region_ids_exact(seed):
    """Inputs keep every projection >= 1e-4 from zero (float64), so both
    sides must agree on every bit."""
    cfg = small_pfo_config()
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(cfg.dim, cfg.L * 32)).astype(np.float32)
    part = rng.normal(size=(cfg.L, 32, cfg.C)).astype(np.float32)
    x = rng.normal(size=(200, cfg.dim)).astype(np.float32)
    p = x.astype(np.float64) @ table.astype(np.float64)
    bits = np.where(p >= 0, 1.0, -1.0).reshape(len(x), cfg.L, 32)
    pp = np.einsum("nlm,lmc->nlc", bits, part.astype(np.float64))
    keep = (np.abs(p).min(1) >= 1e-4) & (np.abs(pp).min((1, 2)) >= 1e-4)
    x = x[keep]
    h_t = lsh.hash_vectors(torch.from_numpy(x), torch.from_numpy(table), 32)
    h_j = jlsh.hash_vectors(jnp.asarray(x), jnp.asarray(table), 32)
    _eq(h_t, h_j)
    tcfg = tconfig.PFOConfig(**cfg.__dict__)
    _eq(lsh.partition_ids(h_t, torch.from_numpy(part), tcfg),
        jlsh.partition_ids(h_j, jnp.asarray(part), cfg))
    _eq(lsh.region_ids(h_t, torch.from_numpy(part), tcfg),
        jlsh.region_ids(h_j, jnp.asarray(part), cfg))


def test_main_table_keys_exact_for_edge_ids():
    cfg = small_pfo_config()
    ids = np.concatenate([EDGE_IDS, np.random.default_rng(4).integers(
        I32.min, I32.max, 300, dtype=np.int32)])
    th, tt = lsh.main_table_keys(torch.from_numpy(ids),
                                 tconfig.PFOConfig(**cfg.__dict__))
    jh, jt = jlsh.main_table_keys(jnp.asarray(ids), cfg)
    _eq(th, jh)
    _eq(tt, jt)


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,trees,cap", [(1, 1, 1), (50, 4, 8), (300, 16, 5),
                                         (257, 33, 40)])
def test_dispatch_to_trees_exact(n, trees, cap):
    rng = np.random.default_rng(n + trees)
    tids = rng.integers(-1, trees, size=n).astype(np.int32)
    tids[: n // 3] = rng.integers(0, 2, size=n // 3)      # hot trees overflow
    mbox, ovf = dispatch.dispatch_to_trees(torch.from_numpy(tids), trees, cap)
    jmbox, jovf = jdispatch.dispatch_to_trees(jnp.asarray(tids), trees, cap)
    _eq(mbox, jmbox)
    _eq(ovf, jovf)
    ids = np.concatenate([EDGE_IDS, rng.integers(I32.min, I32.max, n,
                                                 dtype=np.int32)])[:n]
    payload = rng.normal(size=(n, 3)).astype(np.float32)
    _eq(dispatch.mailbox_ids(mbox, torch.from_numpy(ids)),
        jdispatch.mailbox_ids(jmbox, jnp.asarray(ids)))
    (g,) = dispatch.gather_mailbox(mbox, torch.from_numpy(payload))
    (jg,) = jdispatch.gather_mailbox(jmbox, jnp.asarray(payload))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))


def test_pack_round_flags_and_names():
    assert dispatch.FLAG_NAMES == jdispatch.FLAG_NAMES
    for bits in range(16):
        b = [bool(bits >> i & 1) for i in range(4)]
        got = dispatch.pack_round_flags(*(torch.tensor(v) for v in b))
        want = jdispatch.pack_round_flags(*(jnp.bool_(v) for v in b))
        assert int(got) == int(want) and got.dtype == torch.int32
    got = dispatch.pack_round_flags(*(torch.tensor(True),) * 4,
                                    store_full=torch.tensor(True))
    assert int(got) == 15 + dispatch.FLAG_STORE_FULL


def test_host_ticket_helpers_equal():
    qs = [[(i, "q", None, 0.0) for i in range(n)] for n in (3, 0, 5, 1)]
    assert dispatch.merge_client_queues(qs) == \
        jdispatch.merge_client_queues(qs)
    t = dispatch.client_ticket(7, 12345)
    assert t == jdispatch.client_ticket(7, 12345)
    assert dispatch.ticket_client(t) == 7


# ----------------------------------------------------------------------
# store
# ----------------------------------------------------------------------
def _store_fields(st):
    return [np.asarray(f.numpy() if torch.is_tensor(f) else f) for f in st]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_store_alloc_free_sequence_exact(seed):
    """Allocations until the store is full, frees with duplicates, -1
    slots and masked rows, then re-allocation: every field equal."""
    rng = np.random.default_rng(seed)
    cap, dim = 40, 3
    ts, js = store.dense_init(cap, dim), jstore.dense_init(cap, dim)
    for step in range(8):
        n = int(rng.integers(1, 17))
        vecs = rng.normal(size=(n, dim)).astype(np.float32)
        mask = rng.random(n) < 0.8
        ts, tslots, tok = store.dense_alloc(ts, torch.from_numpy(vecs),
                                            torch.from_numpy(mask))
        js, jslots, jok = jstore.dense_alloc(js, jnp.asarray(vecs),
                                             jnp.asarray(mask))
        _eq(tslots, jslots)
        _eq(tok, jok)
        for a, b in zip(_store_fields(ts), _store_fields(js)):
            _eq(a, b)
        if step % 2:
            live = np.flatnonzero(np.asarray(js.live))
            pick = rng.choice(live, size=min(len(live), 6), replace=False) \
                if len(live) else np.zeros(0, np.int64)
            slots = np.concatenate([pick, pick[:2], [-1, 0, cap - 1]])
            slots = slots.astype(np.int32)
            fmask = rng.random(len(slots)) < 0.9
            ts = store.dense_free(ts, torch.from_numpy(slots),
                                  torch.from_numpy(fmask))
            js = jstore.dense_free(js, jnp.asarray(slots), jnp.asarray(fmask))
            for a, b in zip(_store_fields(ts), _store_fields(js)):
                _eq(a, b)
    assert int(js.free_top) < cap
    idx = rng.integers(-1, cap, size=20).astype(np.int32)
    np.testing.assert_array_equal(
        store.dense_read(ts, torch.from_numpy(idx)).numpy(),
        np.asarray(jstore.dense_read(js, jnp.asarray(idx))))


def test_dense_store_full_refuses_without_clobbering():
    ts, js = store.dense_init(5, 2), jstore.dense_init(5, 2)
    vecs = np.arange(16, dtype=np.float32).reshape(8, 2)
    mask = np.ones(8, bool)
    ts, tslots, _ = store.dense_alloc(ts, torch.from_numpy(vecs),
                                      torch.from_numpy(mask))
    js, jslots, _ = jstore.dense_alloc(js, jnp.asarray(vecs),
                                       jnp.asarray(mask))
    _eq(tslots, jslots)
    assert (tslots.numpy()[5:] == -1).all() and int(ts.free_top) == 0
    for a, b in zip(_store_fields(ts), _store_fields(js)):
        _eq(a, b)


def test_dense_read_tiered_exact():
    rng = np.random.default_rng(3)
    js = jstore.dense_init(6, 4)
    js, _, _ = jstore.dense_alloc(js, jnp.asarray(rng.normal(size=(6, 4)),
                                                  jnp.float32),
                                  jnp.ones(6, bool))
    ts = store.DenseStore(*(torch.from_numpy(np.array(f)) for f in js))
    staging = rng.normal(size=(3, 4)).astype(np.float32)
    slots = np.array([-1, 0, 5, 6, 8, 20], np.int32)
    np.testing.assert_array_equal(
        store.dense_read_tiered(ts, torch.from_numpy(staging),
                                torch.from_numpy(slots)).numpy(),
        np.asarray(jstore.dense_read_tiered(js, jnp.asarray(staging),
                                            jnp.asarray(slots))))


# ----------------------------------------------------------------------
# membership
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,m", [(1, 1), (50, 7), (300, 300), (10, 0)])
def test_member_sorted_exact(n, m):
    rng = np.random.default_rng(n * 7 + m)
    table = np.concatenate([EDGE_IDS, rng.integers(-5, 50, size=m,
                                                   dtype=np.int32)])[:m]
    x = np.concatenate([EDGE_IDS, rng.integers(-5, 50, size=n,
                                               dtype=np.int32)])
    x = x.reshape(-1, 1) if n % 2 else x
    _eq(membership.member_sorted(torch.from_numpy(x), torch.from_numpy(table)),
        jmember.member_sorted(jnp.asarray(x), jnp.asarray(table)))
