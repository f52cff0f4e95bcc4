"""Host-resident sealed-segment store — the cold tier's flash level.

The paper scales capacity past RAM by writing sealed partitions to
flash as sequential Index+Data files (§3.2.2).  This module is that
file layer: each *segment* is one sealed, bucket-major-sorted
(key, id, val) record block, written exactly once and read by mmap —
the device keeps only the segment's Bloom filter/stamp/count in its
routing table (``core.coldtier``) and fetches segment payloads on
filter match.

Two backings share one interface:

* **RAM** (``root=None``) — pinned host numpy arrays in a dict; the
  default for tests and for deployments where "cold" just means
  "host DRAM instead of HBM".
* **files** (``root=<dir>``) — one write-once ``.npy`` per segment
  (structured dtype, so a single sequential write), read back with
  ``mmap_mode="r"`` so a fetch touches only the pages it copies to
  device.  Files are generation-numbered and never mutated:
  compaction writes *new* generations and deletes the old ones, which
  is what lets checkpoints reference segments by hardlink instead of
  re-dumping them (the JAX package's ``save_index_checkpoint``; the
  port's checkpoints come with a later slice).

A segment may carry a **vector payload block** — a (cap, d) f32 array
with row r holding entry r's vector (the tiered dense store's flash
level; MainTable segments only).  It lives in a sibling write-once
``seg_<gid>.vec.npy`` file (or RAM array) sharing the segment's
lifecycle: written in the same ``put``, deleted/exported/imported with
the index block, mmap'd on read.

Pure numpy — no torch — so the store can be driven from background
compaction threads without touching device runtime state.  This is the
port's own copy of the JAX package's ``storage/segments.py``, unchanged
in behaviour, so segment files written by either read in both.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

#: one sealed record: compound key (sorted-by ascending), vector id
#: (-1 == padding), payload (store slot for the MainTable, id for LSH).
SEGMENT_DTYPE = np.dtype([("key", "<u4"), ("id", "<i4"), ("val", "<i4")])


class SegmentStore:
    """Write-once segment blobs addressed by generation id (gid)."""

    def __init__(self, root: str | None = None):
        self.root = root
        if root is not None:
            os.makedirs(root, exist_ok=True)
        self._mem: dict[int, np.ndarray] = {}
        self._mem_vec: dict[int, np.ndarray] = {}
        # one cached mmap view per segment/payload file: readers share
        # it, and delete() closes it before unlinking — without this,
        # every get() opened a fresh fd that outlived the file, so long
        # compaction churn accumulated unlinked-but-open fds and the
        # disk they pinned
        self._views: dict[int, np.ndarray] = {}
        self._vec_views: dict[int, np.ndarray] = {}
        self._meta: dict[int, dict] = {}   # gid -> {count, stamp[, vec_dim]}
        self._next_gid = 0
        self.bytes_written = 0

    # -- core API ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._meta)

    def __contains__(self, gid: int) -> bool:
        return gid in self._meta

    def path(self, gid: int) -> str | None:
        if self.root is None:
            return None
        return os.path.join(self.root, f"seg_{gid:08d}.npy")

    def vec_path(self, gid: int) -> str | None:
        """Sibling file carrying the segment's vector payload block."""
        if self.root is None:
            return None
        return os.path.join(self.root, f"seg_{gid:08d}.vec.npy")

    def put(self, keys: np.ndarray, ids: np.ndarray, vals: np.ndarray,
            count: int, stamp: int,
            payload: np.ndarray | None = None) -> int:
        """Persist one sealed segment; returns its gid (write-once).
        ``payload`` (cap, d) f32 rows travel in a sibling ``.vec.npy``
        block (the MainTable tier's spilled vectors)."""
        cap = keys.shape[0]
        rec = np.empty((cap,), SEGMENT_DTYPE)
        rec["key"] = np.asarray(keys, np.uint32)
        rec["id"] = np.asarray(ids, np.int32)
        rec["val"] = np.asarray(vals, np.int32)
        gid = self._next_gid
        self._next_gid += 1
        if self.root is None:
            self._mem[gid] = rec
        else:
            np.save(self.path(gid), rec)
        self._meta[gid] = {"count": int(count), "stamp": int(stamp)}
        self.bytes_written += rec.nbytes
        if payload is not None:
            payload = np.asarray(payload, np.float32)
            if self.root is None:
                self._mem_vec[gid] = payload
            else:
                np.save(self.vec_path(gid), payload)
            self._meta[gid]["vec_dim"] = int(payload.shape[1])
            self.bytes_written += payload.nbytes
        return gid

    def get(self, gid: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(keys, ids, vals) views of a segment — mmap'd in file mode.

        The view is cached (segments are write-once, so it never goes
        stale) and MUST NOT outlive the segment: ``delete`` closes it.
        Every consumer copies what it keeps (``np.asarray`` /
        ``np.ascontiguousarray``) before the next maintenance epoch.
        """
        if self.root is None:
            rec = self._mem[gid]
        else:
            rec = self._views.get(gid)
            if rec is None:
                rec = np.load(self.path(gid), mmap_mode="r")
                self._views[gid] = rec
        return rec["key"], rec["id"], rec["val"]

    def get_payload(self, gid: int) -> np.ndarray | None:
        """(cap, d) f32 payload view (mmap'd, cached like ``get``);
        None when the segment carries no vector block."""
        if "vec_dim" not in self._meta[gid]:
            return None
        if self.root is None:
            return self._mem_vec[gid]
        vec = self._vec_views.get(gid)
        if vec is None:
            vec = np.load(self.vec_path(gid), mmap_mode="r")
            self._vec_views[gid] = vec
        return vec

    def meta(self, gid: int) -> dict:
        return dict(self._meta[gid])

    @staticmethod
    def _close_view(view: np.ndarray | None) -> None:
        """Release a cached mmap view's fd (np.load wraps the buffer in
        an ``np.memmap`` whose ``_mmap`` holds it open)."""
        mm = getattr(view, "_mmap", None)
        if mm is not None:
            mm.close()

    def delete(self, gid: int) -> None:
        meta = self._meta.pop(gid)
        if self.root is None:
            self._mem.pop(gid)
            self._mem_vec.pop(gid, None)
        else:
            self._close_view(self._views.pop(gid, None))
            os.remove(self.path(gid))
            if "vec_dim" in meta:
                self._close_view(self._vec_views.pop(gid, None))
                os.remove(self.vec_path(gid))

    # -- checkpoint support --------------------------------------------
    @staticmethod
    def vec_sibling(path: str) -> str:
        """Payload file path next to a segment file path."""
        assert path.endswith(".npy")
        return path[:-len(".npy")] + ".vec.npy"

    def export(self, gid: int, dest_path: str) -> None:
        """Materialize a segment (and its payload block, if any) at
        ``dest_path`` (payload at the ``.vec.npy`` sibling).

        File mode hardlinks (the segment file is immutable, so the link
        shares the inode at zero copy cost — "manifest, not re-dump");
        cross-device or RAM-backed stores fall back to a real write.
        """
        def materialize(src, dest, mem):
            if src is not None:
                try:
                    os.link(src, dest)
                except OSError:
                    shutil.copyfile(src, dest)
            else:
                np.save(dest, mem)
        materialize(self.path(gid), dest_path, self._mem.get(gid))
        if "vec_dim" in self._meta[gid]:
            materialize(self.vec_path(gid), self.vec_sibling(dest_path),
                        self._mem_vec.get(gid))

    def import_file(self, src_path: str, meta: dict) -> int:
        """Adopt a checkpointed segment file (and its ``.vec.npy``
        payload sibling, when the manifest records one) into this
        store."""
        rec = np.load(src_path)
        payload = None
        if "vec_dim" in meta:
            payload = np.load(self.vec_sibling(src_path))
        return self.put(rec["key"], rec["id"], rec["val"],
                        meta["count"], meta["stamp"], payload=payload)
