"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU.

* Generic checkpoints: round trips of a nested tree (NamedTuples, dicts,
  lists, ``None``), ``latest_step``, the raw codec (``zstandard`` made
  absent) and the atomic publish: a half-written ``.tmp_*`` directory is
  never read.
* Index checkpoints against the JAX package, hot and cold (file-backed
  segments): a checkpoint written by the JAX ``save_index_checkpoint``
  loads into the port, and one written by the port loads into the JAX
  package.  Either way every leaf of the two restored states is equal
  (integers exactly, floats within 1e-5) and the same queries give the
  same ids, distances within 1e-5.  The leaf paths are the JAX
  package's strings.
* A port-to-port round trip keeps the store's slot owners and answers
  bit-identically; cold segments are hardlinked, not copied.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from conftest import small_pfo_config
from repro.checkpoint import ckpt as jckpt
from repro.core import PFOIndex as JaxIndex
from repro_torch import convert
from repro_torch.checkpoint import (latest_step, load_index_checkpoint,
                                    restore_checkpoint, save_checkpoint,
                                    save_index_checkpoint)
from repro_torch.checkpoint import ckpt
from repro_torch.core import PFOConfig, PFOIndex
from test_torch_cold import _assert_equal, _assert_query_equal, cold_cfg
from test_torch_index import _safe_vectors

torch.set_num_threads(1)


# ======================================================================
# generic checkpoints
# ======================================================================
def _tree():
    from typing import NamedTuple

    class Part(NamedTuple):
        a: torch.Tensor
        b: object = None
        c: object = None

    g = torch.Generator().manual_seed(0)
    return {
        "z": Part(a=torch.randn(3, 4, generator=g),
                  c=[torch.arange(5, dtype=torch.int64) * (2**40),
                     torch.tensor(True)]),
        "k": {"u8": torch.arange(7, dtype=torch.uint8),
              "i32": torch.tensor(-3, dtype=torch.int32)},
        "empty": None,
    }


def _equal_trees(a, b):
    pa, pb = ckpt.flatten_with_paths(a), ckpt.flatten_with_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_generic_round_trip_and_latest_step(tmp_path):
    tree = _tree()
    paths = [p for p, _ in ckpt.flatten_with_paths(tree)]
    # NamedTuple fields in order, dict keys sorted, None skipped
    assert paths == ["k/i32", "k/u8", "z/.a", "z/.c/0", "z/.c/1"]
    assert latest_step(str(tmp_path / "none")) is None
    for step in (1, 5, 3):
        save_checkpoint(str(tmp_path), step, tree, extra={"step": step})
    assert latest_step(str(tmp_path)) == 5
    got, extra = restore_checkpoint(str(tmp_path), 3, tree)
    assert extra == {"step": 3}
    _equal_trees(got, tree)
    assert got["empty"] is None and got["z"].b is None
    assert got["k"]["i32"].shape == ()            # 0-d stays 0-d
    man = ckpt.read_manifest(str(tmp_path), 5)
    codec = "raw" if ckpt._zstd() is None else "zstd"
    assert {e["codec"] for e in man["leaves"]} == {codec}


def test_raw_codec_round_trip(tmp_path, monkeypatch):
    """Without ``zstandard`` the leaves are raw bytes, and read back."""
    monkeypatch.setattr(ckpt, "_zstd", lambda: None)
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    man = ckpt.read_manifest(str(tmp_path), 1)
    assert {e["codec"] for e in man["leaves"]} == {"raw"}
    _equal_trees(restore_checkpoint(str(tmp_path), 1, tree)[0], tree)


@pytest.mark.parametrize("raw", [True, False])
def test_read_rows_is_a_slice(tmp_path, monkeypatch, raw):
    """A shard's rows of a stacked leaf: of a raw leaf only their bytes
    are read; a zstd leaf is decoded whole and sliced."""
    if raw:
        monkeypatch.setattr(ckpt, "_zstd", lambda: None)
    elif ckpt._zstd() is None:
        pytest.skip("zstandard is not installed")
    x = np.arange(4 * 3 * 5, dtype=np.uint32).reshape(4, 3, 5)
    save_checkpoint(str(tmp_path), 1, {"x": torch.from_numpy(
        x.astype(np.int64)), "y": torch.zeros(2)},
        to_numpy=lambda p, v: x if p == "x" else v.numpy())
    src = os.path.join(str(tmp_path), "step_00000001")
    (e,) = [e for e in ckpt.read_manifest(str(tmp_path), 1)["leaves"]
            if e["path"] == "x"]
    assert e["codec"] == ("raw" if raw else "zstd")
    for lo, hi in ((0, 1), (1, 3), (3, 4), (0, 4)):
        np.testing.assert_array_equal(ckpt._read_rows(src, e, lo, hi),
                                      x[lo:hi])


def test_atomic_publish(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 2, tree)
    # a crashed writer: its temp dir holds a manifest but is never read
    tmp = tmp_path / ".tmp_crashed"
    tmp.mkdir()
    (tmp / "manifest.json").write_text("{}")

    def boom(_):
        raise OSError("disk full")

    with pytest.raises(OSError):
        save_checkpoint(str(tmp_path), 9, tree, write_extra=boom)
    assert not (tmp_path / "step_00000009").exists()
    assert latest_step(str(tmp_path)) == 2
    # a step written again replaces the old one whole
    tree["k"]["i32"] = torch.tensor(11, dtype=torch.int32)
    save_checkpoint(str(tmp_path), 2, tree)
    got, _ = restore_checkpoint(str(tmp_path), 2, tree)
    assert int(got["k"]["i32"]) == 11


def test_zstd_leaf_needs_the_package(tmp_path, monkeypatch):
    """A leaf recorded as zstd is read only with ``zstandard``; an
    unknown codec is refused."""
    tree = {"x": torch.arange(4)}
    path = save_checkpoint(str(tmp_path), 1, tree)
    man = json.load(open(os.path.join(path, "manifest.json")))
    man["leaves"][0]["codec"] = "zstd"
    json.dump(man, open(os.path.join(path, "manifest.json"), "w"))
    monkeypatch.setattr(ckpt, "_zstd", lambda: None)
    with pytest.raises(RuntimeError, match="zstandard"):
        restore_checkpoint(str(tmp_path), 1, tree)
    man["leaves"][0]["codec"] = "lz9"
    json.dump(man, open(os.path.join(path, "manifest.json"), "w"))
    with pytest.raises(ValueError, match="codec"):
        restore_checkpoint(str(tmp_path), 1, tree)


# ======================================================================
# index checkpoints against the JAX package
# ======================================================================
@pytest.fixture(scope="module", params=["hot", "cold"])
def pair(request, tmp_path_factory):
    """A JAX index and a port index fed the same inserts and deletes,
    with the JAX index's projections: sealed segments hot, spilled
    file-backed segments cold."""
    cold = request.param == "cold"
    cfg = (cold_cfg(max_tombstones=128) if cold
           else small_pfo_config(max_leaves_per_tree=64, max_snapshots=3,
                                 max_tombstones=64))
    root = tmp_path_factory.mktemp(request.param)
    seg = (lambda name: str(root / name)) if cold else (lambda name: None)
    jidx = JaxIndex(cfg, seed=0, cold_dir=seg("jax"))
    proj = {k: np.asarray(v) for k, v in jidx.state.proj.items()}
    tcfg = PFOConfig(**cfg.__dict__)
    tidx = PFOIndex(tcfg, device="cpu", proj=convert.proj_from_numpy(proj),
                    cold_dir=seg("port"))
    wave = 400
    ids, vecs = _safe_vectors(proj, cfg, 4 * wave, ver=3)
    for w in range(4):
        sl = slice(w * wave, (w + 1) * wave)
        jidx.insert(ids[sl], vecs[sl])
        tidx.insert(ids[sl], vecs[sl])
    gone = ids[wave:wave + 40]
    jidx.delete(gone)
    tidx.delete(gone)
    if cold:
        assert tidx.cold.n_cold >= 1 and jidx.cold.n_cold == tidx.cold.n_cold
    else:
        assert int(tidx.state.main_snaps.n_snaps) >= 1
    return dict(cfg=cfg, tcfg=tcfg, jidx=jidx, tidx=tidx, root=root,
                seg=seg, q=vecs[::37], cold=cold)


def _restored_equal(js, ts):
    """Every leaf of a restored JAX state equals the port's."""
    js = jax.device_get(js)
    for part in ("lsh_forest", "main_forest", "store", "lsh_snaps",
                 "main_snaps", "tombstones", "n_tombstones", "stamp", "proj",
                 "cold"):
        _assert_equal(getattr(ts, part), getattr(js, part), part)


def test_leaf_paths_are_the_jax_strings(pair):
    jpaths, _, _ = jckpt._flatten_with_paths(pair["jidx"].state)
    tpaths = [p for p, _ in ckpt.flatten_with_paths(pair["tidx"].state)]
    assert ".store/.owner" in tpaths
    assert [p for p in tpaths if p != ".store/.owner"] == jpaths
    assert len(jpaths) == (63 if pair["cold"] else 43)


def test_jax_checkpoint_loads_into_port(pair, tmp_path):
    cfg, tcfg, jidx = pair["cfg"], pair["tcfg"], pair["jidx"]
    jckpt.save_index_checkpoint(str(tmp_path), 7, jidx)
    tidx = load_index_checkpoint(str(tmp_path), 7, tcfg, device="cpu",
                                 cold_dir=pair["seg"]("p_from_j"))
    jrest = jckpt.load_index_checkpoint(str(tmp_path), 7, cfg,
                                        cold_dir=pair["seg"]("j_from_j"))
    assert tidx.state.store.owner is None       # the JAX package keeps none
    assert tidx.n_inserted == jidx.n_inserted == jrest.n_inserted
    _restored_equal(jrest.state, tidx.state)
    if pair["cold"]:
        assert tidx.cold.n_cold == jrest.cold.n_cold >= 1
        assert tidx.cold.counters == jrest.cold.counters
    _assert_query_equal(jrest, tidx, pair["q"])
    if pair["cold"]:
        _restored_equal(jrest.state, tidx.state)   # the same fetches


def test_port_checkpoint_loads_into_jax(pair, tmp_path):
    cfg, tcfg, tidx = pair["cfg"], pair["tcfg"], pair["tidx"]
    path = save_index_checkpoint(str(tmp_path), 4, tidx)
    man = json.load(open(os.path.join(path, "manifest.json")))
    dtypes = {e["path"]: e["dtype"] for e in man["leaves"]}
    assert dtypes[".lsh_forest/.leaf_key"] == "uint32"
    assert dtypes[".lsh_forest/.slots"] == "int32"
    assert dtypes[".lsh_snaps/.blooms"] == "uint32"
    jrest = jckpt.load_index_checkpoint(str(tmp_path), 4, cfg,
                                        cold_dir=pair["seg"]("j_from_p"))
    trest = load_index_checkpoint(str(tmp_path), 4, tcfg, device="cpu",
                                  cold_dir=pair["seg"]("p_from_p"))
    _restored_equal(jrest.state, trest.state)
    assert jrest.n_inserted == tidx.n_inserted
    _assert_query_equal(jrest, trest, pair["q"])


def test_port_round_trip_keeps_owners(pair, tmp_path):
    tcfg, tidx = pair["tcfg"], pair["tidx"]
    save_index_checkpoint(str(tmp_path), 1, tidx)
    back = load_index_checkpoint(str(tmp_path), 1, tcfg, device="cpu",
                                 cold_dir=pair["seg"]("p_again"))
    assert back.state.store.owner is not None
    for (p, a), (q, b) in zip(ckpt.flatten_with_paths(tidx.state),
                              ckpt.flatten_with_paths(back.state)):
        assert p == q
        if "_cache/" in p:
            continue                            # caches restart empty
        assert a.dtype == b.dtype and torch.equal(a, b), p
    if tidx.cold is not None:
        # the original's caches, flushed, equal the restored empty ones
        assert int(back.state.cold.lsh_cache.segs.max()) == -1
        assert int(back.state.cold.main_cache.segs.max()) == -1
        assert back.cold.n_cold == tidx.cold.n_cold
    want = tidx.query(pair["q"], 10)
    got = back.query(pair["q"], 10)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])   # bit-identical


def test_cold_segments_are_hardlinked(pair, tmp_path):
    """Cold segments (and their payload blocks) are linked into the
    checkpoint, sharing the store's inodes; a hot index writes none."""
    tidx = pair["tidx"]
    path = save_index_checkpoint(str(tmp_path), 2, tidx)
    man = json.load(open(os.path.join(path, "manifest.json")))
    if not pair["cold"]:
        assert "cold_manifest" not in man["extra"]
        assert not os.path.exists(os.path.join(path, "segments"))
        return
    cman = man["extra"]["cold_manifest"]
    gids = [e["gid"] for row in cman["lsh"] for e in row] \
        + [e["gid"] for e in cman["main"]]
    assert len(gids) == (pair["tcfg"].L + 1) * tidx.cold.n_cold
    store = tidx.cold.store
    for gid in gids:
        link = os.path.join(path, "segments", f"seg_{gid:08d}.npy")
        assert os.stat(link).st_ino == os.stat(store.path(gid)).st_ino
    for e in cman["main"]:
        link = os.path.join(path, "segments", f"seg_{e['gid']:08d}.vec.npy")
        assert os.stat(link).st_ino == os.stat(
            store.vec_path(e["gid"])).st_ino
