"""Checkpoints: atomic, in the JAX package's on-disk format.

Layout: ``<dir>/step_<k>/manifest.json`` plus one ``leaf_<i>.npz`` file
of raw bytes per array leaf (zstd-compressed when the ``zstandard``
package is installed; the ``codec`` field of each manifest entry says
which, so either build reads both).  A leaf's ``path`` is the JAX
package's string for it: ``.field`` for a NamedTuple field, the key for
a dict entry (dicts in sorted key order), the index for a list entry,
joined by ``/``; ``None`` leaves are skipped.  Writes go to a
``.tmp_*`` directory that is published with one ``os.replace``, so a
crashed writer leaves nothing ``latest_step`` or a restore would read.

Index states are written in the JAX package's dtypes
(``convert._leaf_to_numpy``: uint32 keys and Bloom words, int32 tree
arenas), so a checkpoint written by either package restores into the
other.  The port's store also writes its slot owners
(``.store/.owner``), which the JAX package does not read; a checkpoint
without them restores with ``owner`` None, as ``state_from_numpy``
builds it.

Cold segments are write-once files, so an index checkpoint does not
re-dump them: the hot state goes through the leaf dump, and the cold
segments are hardlinked under ``segments/`` (a real copy across
filesystems or from a RAM-backed store), with the cold layout in
``extra["cold_manifest"]``.  A distributed backend's checkpoint keeps
the JAX package's logical layout — every sharded leaf with the shard
axis first, gathered to rank 0, which writes the files — and one cold
manifest per shard in ``extra["cold_manifests"]``, each rank
hardlinking its own segments under ``segments/shard<k>/``.

A tree with DTensor leaves (a sharded model or trainer) is written in
the same layout: every rank gathers each leaf whole once, rank 0 writes
the files, and every rank leaves after a barrier.  ``restore_checkpoint``
with ``shardings`` places each leaf's shard on the mesh it names (the
elastic restart: the mesh that wrote the checkpoint does not matter).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

from .. import convert

_CTX: dict = {}                # lazily built, reused zstd contexts


def _zstd():
    try:
        import zstandard
    except ImportError:        # optional: fall back to raw bytes
        return None
    return zstandard


def _compress(raw: bytes) -> tuple[bytes, str]:
    zstd = _zstd()
    if zstd is None:
        return raw, "raw"
    if "c" not in _CTX:
        _CTX["c"] = zstd.ZstdCompressor(level=3)
    return _CTX["c"].compress(raw), "zstd"


def _decompress(blob: bytes, codec: str) -> bytes:
    if codec == "raw":
        return blob
    if codec != "zstd":
        raise ValueError(f"unknown checkpoint codec {codec!r}")
    zstd = _zstd()
    if zstd is None:
        raise RuntimeError("checkpoint was written with zstd but the "
                           "'zstandard' package is not installed")
    if "d" not in _CTX:
        _CTX["d"] = zstd.ZstdDecompressor()
    return _CTX["d"].decompress(blob)


# ======================================================================
# the flattener: NamedTuples, dicts, lists and tensors, as JAX names them
# ======================================================================
def _is_leaf(node) -> bool:
    return torch.is_tensor(node) or isinstance(node, (np.ndarray, np.generic,
                                                      int, float, bool))


def _children(node):
    """(path part, child) pairs of an inner node, in flattening order."""
    if hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def flatten_with_paths(tree) -> list[tuple[str, object]]:
    """``(path, leaf)`` for every array leaf of ``tree``, in the JAX
    package's order and path strings; ``None`` leaves are skipped."""
    out: list = []

    def walk(node, parts):
        if node is None:
            return
        if _is_leaf(node):
            out.append(("/".join(parts), node))
            return
        for part, child in _children(node):
            walk(child, parts + [part])

    walk(tree, [])
    return out


def _rebuild(like, leaves: dict, parts=()):
    """``like`` with every leaf replaced by ``leaves[path]``."""
    if like is None:
        return None
    if _is_leaf(like):
        return leaves["/".join(parts)]
    kids = {part: _rebuild(child, leaves, parts + (part,))
            for part, child in _children(like)}
    if hasattr(like, "_fields"):
        return type(like)(**{f: kids["." + f] for f in like._fields})
    if isinstance(like, dict):
        return {k: kids[str(k)] for k in like}
    return type(like)(kids[str(i)] for i in range(len(like)))


def _plain_numpy(path: str, leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def state_numpy(path: str, leaf) -> np.ndarray:
    """A ``PFOState`` leaf in the JAX package's dtype, named by the last
    part of its path."""
    name = path.rsplit("/", 1)[-1].lstrip(".")
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    return convert._leaf_to_numpy(name, leaf)


# ======================================================================
# generic checkpoints
# ======================================================================
def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, tree, extra: dict | None = None,
                    write_extra=None, to_numpy=None) -> str:
    """Write ``tree`` as ``step_<step>`` under ``ckpt_dir``; returns its
    path.  ``to_numpy(path, leaf)`` chooses each leaf's on-disk array
    (default: the tensor's own dtype).  ``write_extra(tmp_dir)``, when
    given, runs before the atomic publish, so the side files it writes
    (segment hardlinks) appear all-or-nothing with the manifest."""
    to_numpy = to_numpy or _plain_numpy
    flat = flatten_with_paths(tree)
    if not any(_is_dtensor(leaf) for _, leaf in flat):
        return _write(ckpt_dir, step, ((path, to_numpy(path, leaf))
                                       for path, leaf in flat),
                      extra, write_extra)
    import torch.distributed as dist
    # every rank gathers every leaf (a collective), rank 0 writes
    arrays = [(path, to_numpy(path, leaf.full_tensor()
                              if _is_dtensor(leaf) else leaf))
              for path, leaf in flat]
    final = _step_dir(ckpt_dir, step)
    if dist.get_rank() == 0:
        final = _write(ckpt_dir, step, arrays, extra, write_extra)
    dist.barrier()
    return final


def _is_dtensor(leaf) -> bool:
    return torch.is_tensor(leaf) and hasattr(leaf, "placements")


def _write(ckpt_dir: str, step: int, arrays, extra, write_extra) -> str:
    """Write ``(path, array)`` leaves and the manifest; publish."""
    final = _step_dir(ckpt_dir, step)
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (path, arr) in enumerate(arrays):
        arr = np.asarray(arr, order="C")      # keeps 0-d leaves 0-d
        fn = f"leaf_{i:05d}.npz"
        blob, codec = _compress(arr.tobytes())
        with open(os.path.join(tmp, fn), "wb") as f:
            f.write(blob)
        manifest["leaves"].append({
            "path": path, "file": fn, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "codec": codec})
    if write_extra is not None:
        write_extra(tmp)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete step under ``ckpt_dir`` (None if none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d[len("step_"):]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def _read_leaf(src: str, entry: dict) -> np.ndarray:
    with open(os.path.join(src, entry["file"]), "rb") as f:
        raw = _decompress(f.read(), entry.get("codec", "zstd"))
    return np.frombuffer(raw, dtype=np.dtype(entry["dtype"])).reshape(
        entry["shape"])


def _read_rows(src: str, entry: dict, lo: int, hi: int) -> np.ndarray:
    """Rows ``[lo, hi)`` of a leaf's leading axis.  A raw leaf reads only
    their bytes (a shard's slice of a stacked leaf); a compressed one is
    decoded whole first."""
    if entry.get("codec", "zstd") != "raw":
        return _read_leaf(src, entry)[lo:hi]
    dt = np.dtype(entry["dtype"])
    shape = entry["shape"]
    row = dt.itemsize * int(np.prod(shape[1:], dtype=np.int64))
    with open(os.path.join(src, entry["file"]), "rb") as f:
        f.seek(lo * row)
        raw = f.read((hi - lo) * row)
    return np.frombuffer(raw, dtype=dt).reshape([hi - lo] + shape[1:])


def _as_like(arr: np.ndarray, like, path: str):
    """A loaded array in the type, dtype and device of ``like``."""
    if not torch.is_tensor(like):
        return np.array(arr)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {path} has shape "
                         f"{tuple(arr.shape)}, the target {tuple(like.shape)}"
                         " (a different config?)")
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr)).to(device=like.device,
                                              dtype=like.dtype)


def _sharding_at(shardings, parts):
    """The node of ``shardings`` at a leaf path of ``like`` (None where
    the tree holds None)."""
    node = shardings
    for part in parts:
        if node is None or hasattr(node, "placements"):
            break
        if part.startswith(".") and hasattr(node, "_fields"):
            node = getattr(node, part[1:])
        elif isinstance(node, dict):
            node = node[part] if part in node else node[int(part)]
        else:
            node = node[int(part)]
    return node


def restore_checkpoint(ckpt_dir: str, step: int, like,
                       optional: tuple = (), shardings=None):
    """Restore into the structure (types, dtypes, devices) of ``like``;
    returns ``(tree, extra)``.  A leaf whose path is in ``optional`` and
    that the checkpoint lacks comes back None.  ``shardings``, a tree
    shaped like ``like`` whose leaves have ``mesh`` and ``placements``
    (``sharding.policy.NamedSharding``) or are None, places each such
    leaf as a DTensor: every rank reads the full leaf and keeps its own
    block (the elastic-restart path, old mesh -> new mesh)."""
    src = _step_dir(ckpt_dir, step)
    manifest = read_manifest(ckpt_dir, step)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    leaves = {}
    for path, leaf in flatten_with_paths(like):
        e = by_path.get(path)
        if e is None:
            if path not in optional:
                raise KeyError(f"checkpoint has no leaf {path}")
            leaves[path] = None
            continue
        leaves[path] = _as_like(_read_leaf(src, e), leaf, path)
        sh = _sharding_at(shardings, path.split("/")) \
            if shardings is not None else None
        if sh is not None:
            from torch.distributed.tensor import distribute_tensor
            leaves[path] = distribute_tensor(leaves[path], sh.mesh,
                                             sh.placements,
                                             src_data_rank=None)
    return _rebuild(like, leaves), manifest["extra"]


# ======================================================================
# PFO index checkpoints: hot state + cold-segment manifest
# ======================================================================
_OWNER = ".store/.owner"          # the port's extra leaf


def _segment_paths(man: dict, seg_dir: str) -> dict:
    """Manifest gid -> its file under ``seg_dir``."""
    entries = [e for row in man["lsh"] for e in row] + man["main"]
    return {e["gid"]: os.path.join(seg_dir, f"seg_{e['gid']:08d}.npy")
            for e in entries}


def _export_segments(mgr, man: dict, seg_dir: str) -> None:
    os.makedirs(seg_dir, exist_ok=True)
    for gid, path in _segment_paths(man, seg_dir).items():
        mgr.store.export(gid, path)


def save_index_checkpoint(ckpt_dir: str, step: int, index) -> str:
    """Checkpoint a ``repro_torch.core.PFOIndex`` (cold tier included)."""
    extra = {"kind": "pfo_index", "n_inserted": int(index.n_inserted)}
    write_extra = None
    if index.cold is not None:
        man = index.cold.manifest()
        extra["cold_manifest"] = man

        def write_extra(tmp):
            _export_segments(index.cold, man, os.path.join(tmp, "segments"))

    return save_checkpoint(ckpt_dir, step, index.state, extra=extra,
                           write_extra=write_extra, to_numpy=state_numpy)


def _fresh_caches(cold, cfg, lsh_cfg, main_cfg, device):
    """``cold`` with both segment caches empty (the main one with its
    vector pages, so restored staging slots resolve after a fetch)."""
    from ..core import coldtier
    return cold._replace(
        lsh_cache=coldtier._empty_cache(cfg, lsh_cfg.snapshot_capacity,
                                        device),
        main_cache=coldtier._empty_cache(cfg, main_cfg.snapshot_capacity,
                                         device, dim=cfg.dim))


def load_index_checkpoint(ckpt_dir: str, step: int, cfg, seed: int = 0,
                          cold_dir: str | None = None, device=None):
    """Restore a :func:`save_index_checkpoint` (or the JAX package's)
    into a fresh ``PFOIndex`` on ``device`` (None means CUDA).

    ``cfg`` must match the checkpointed one (it sizes every leaf).  Cold
    segments are adopted into the new index's own store (``cold_dir``
    selects its backing); both device segment caches restart empty, and
    residency rebuilds on first touch."""
    from ..core.index import PFOIndex, _snap_cfg_lsh, _snap_cfg_main

    idx = PFOIndex(cfg, seed=seed, device=device, cold_dir=cold_dir)
    state, extra = restore_checkpoint(ckpt_dir, step, idx.state,
                                      optional=(_OWNER,))
    idx.n_inserted = extra.get("n_inserted", 0)
    man = extra.get("cold_manifest")
    if idx.cold is not None and man is not None:
        seg_dir = os.path.join(_step_dir(ckpt_dir, step), "segments")
        idx.cold.adopt_manifest(man, _segment_paths(man, seg_dir))
        state = state._replace(cold=_fresh_caches(
            state.cold, cfg, _snap_cfg_lsh(cfg), _snap_cfg_main(cfg),
            idx.device))
    idx.state = state
    return idx


# ======================================================================
# distributed backend checkpoints: the logical layout + per-shard cold
# manifests
# ======================================================================
#: how a shard's leaf sits in the JAX package's logical (stacked) state:
#: forests own a contiguous block of trees, the mixed LSH ring is already
#: a batch of one, the replicated leaves are every rank's own, and every
#: other leaf gains a leading shard axis
_REPLICATED = (".tombstones", ".n_tombstones", ".stamp", ".proj")
_CONCAT = (".lsh_forest", ".main_forest", ".lsh_snaps")


def _layout(path: str) -> str:
    top = path.split("/", 1)[0]
    if top in _REPLICATED:
        return "replicated"
    return "concat" if top in _CONCAT else "stack"


def _gather_logical(backend) -> list | None:
    """The distributed state in the JAX package's logical layout, as
    ``(path, numpy)`` pairs in its dtypes on the writing rank (world rank
    0), None elsewhere.  Replica 0's shards send their leaves to rank 0
    (one ``gather`` a leaf over its model group)."""
    import torch.distributed as dist

    mesh = backend.mesh
    if mesh.data_index:
        return None
    writer = mesh.rank == 0
    out = []
    for path, leaf in flatten_with_paths(backend.state):
        how = _layout(path)
        if how == "replicated":
            if writer:
                out.append((path, state_numpy(path, leaf)))
            continue
        x = leaf if how == "concat" else leaf[None]
        # bools travel as bytes (not every backend reduces or gathers bool)
        x = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        parts = ([torch.empty_like(x) for _ in range(mesh.n_model)]
                 if writer else None)
        dist.gather(x, parts, dst=0, group=mesh.model_group)
        if writer:
            out.append((path, state_numpy(path, torch.cat(parts).to(
                leaf.dtype))))
    return out if writer else None


def save_dist_checkpoint(ckpt_dir: str, step: int, backend) -> str:
    """Checkpoint a ``DistBackend`` (a collective: every rank calls it).
    Rank 0 writes the leaves in the JAX package's logical layout and the
    manifest; every rank of data replica 0 hardlinks its own shard's
    cold segments under ``segments/shard<k>/`` before rank 0 publishes.
    Returns the checkpoint's path on every rank."""
    import torch.distributed as dist

    mesh = backend.mesh
    world = mesh.world_group
    arrays = _gather_logical(backend)
    mans = None
    if backend.cold_mgr is not None:
        mine = backend.cold_mgr.manifest() if mesh.data_index == 0 else None
        mans = [None] * (mesh.n_model * mesh.n_data)
        dist.all_gather_object(mans, mine, group=world)
        mans = mans[:mesh.n_model]

    def export_mine(tmp):
        """Every rank learns rank 0's temp dir, replica 0 exports its
        shard's segments into it, and all wait until every link is in."""
        box = [tmp]
        dist.broadcast_object_list(box, src=0, group=world)
        if mans is not None and mesh.data_index == 0:
            _export_segments(backend.cold_mgr, mans[mesh.shard],
                             os.path.join(box[0], "segments",
                                          f"shard{mesh.shard}"))
        dist.barrier(group=world)

    final = [None]
    if mesh.rank == 0:
        extra = {"kind": "pfo_dist", "n_inserted": int(backend.n_inserted),
                 "n_model": backend.dcfg.n_model}
        if mans is not None:
            extra["cold_manifests"] = mans
        final[0] = _write(ckpt_dir, step, arrays, extra, export_mine)
    else:
        export_mine(None)
    dist.broadcast_object_list(final, src=0, group=world)   # published
    return final[0]


def load_dist_checkpoint(ckpt_dir: str, step: int, backend):
    """Restore :func:`save_dist_checkpoint` (or the JAX package's) into a
    fresh ``DistBackend`` of the same config: every rank calls it and
    reads its own shard, with no collective (of a raw leaf, only its
    shard's bytes; a zstd leaf is decoded whole).  Its ``cold_dir``
    selects the new segment backing.  A checkpoint of another
    ``n_model`` raises: per-shard cold chains cannot be resharded.  Each
    rank re-adopts its own shard's manifest, in order, so the restored
    routing tables stay valid; both device caches restart empty."""
    from ..core import distributed as dist_mod

    dcfg, mesh = backend.dcfg, backend.mesh
    manifest = read_manifest(ckpt_dir, step)
    extra = manifest["extra"]
    n_model = extra.get("n_model")
    if n_model is not None and n_model != dcfg.n_model:
        raise ValueError(
            f"checkpoint has {n_model} model shards, the backend has "
            f"{dcfg.n_model}: per-shard cold chains cannot be resharded")
    src = _step_dir(ckpt_dir, step)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    s = mesh.shard
    leaves = {}
    for path, like in flatten_with_paths(backend.state):
        e = by_path.get(path)
        if e is None:
            if path != _OWNER:
                raise KeyError(f"checkpoint has no leaf {path}")
            leaves[path] = None
            continue
        how = _layout(path)
        if how == "concat":
            n = like.shape[0]
            arr = _read_rows(src, e, s * n, (s + 1) * n)
        elif how == "stack":
            arr = _read_rows(src, e, s, s + 1)[0]
        else:
            arr = _read_leaf(src, e)
        leaves[path] = _as_like(arr, like, path)
    state = _rebuild(backend.state, leaves)
    backend.n_inserted = extra.get("n_inserted", 0)
    mans = extra.get("cold_manifests")
    if backend.cold_mgr is not None and mans is not None:
        man = mans[s]
        backend.cold_mgr.adopt_manifest(man, _segment_paths(
            man, os.path.join(src, "segments", f"shard{s}")))
        state = state._replace(cold=_fresh_caches(
            state.cold, dist_mod.shard_cold_cfg(dcfg),
            dist_mod.shard_snap_cfg(dcfg),
            dist_mod.shard_main_snap_cfg(dcfg), mesh.device))
    backend.state = state
    backend._flags = None
    return backend
