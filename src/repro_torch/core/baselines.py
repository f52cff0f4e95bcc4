"""Comparator systems for the paper's evaluation (Table 1, Figs. 6/7/10),
in PyTorch.

``BruteForce``     — exact kNN oracle (ground truth for Eq. 1's error
                     ratio and for recall); rides the ``pair_dist``
                     kernel through ``ops.brute_force_topk``.
``ZOrderIndex``    — the LSB-Tree stand-in (paper §7.3/§7.5): compound
                     keys mapped to z-order values held in a sorted
                     array; queries binary-search and rank the z-nearest
                     window; **every insert re-sorts the whole array**,
                     the read-friendly/write-hostile trade the paper
                     criticizes.  Ranks through ``ops.pairwise_rank``
                     (the ``rank_dots`` kernel).
``MultiProbeFlat`` — Multi-Probe-LSH stand-in: one flat bucket table per
                     LSH table, probing the query bucket and the buckets
                     one prefix bit away; ranks the candidate union
                     through ``ops.pairwise_rank``.
``SerializedPFO``  — PFO's forest with every request applied in one
                     global sequential order (no per-tree dispatch): the
                     comparator of Fig. 7.

Each is the counterpart of the JAX package's class of the same name and
gives the same answers on the same data and projections.  The JAX
package draws projections with ``jax.random``; as in ``PFOIndex`` each
comparator takes ``proj`` (``table_proj``, ``part_proj``), else draws
its own from a ``torch.Generator`` seeded with ``seed``.  State lives on
the comparator's device; ``query`` returns host numpy arrays, as
``PFOIndex.query`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops as kops
from .config import PFOConfig
from .device import default_device
from .hash_tree import TreeState, _tree_insert, init_forest
from .index import lsh_tree_config
from .lsh import make_projections, region_ids
from .scatter import masked_put_

#: the rows of a (Q, C, d) candidate block ranked in one launch: bounds
#: the block MultiProbeFlat gathers to 1 GiB of f32
_BLOCK_ELEMS = 1 << 28


class _Comparator:
    """Device, projections and input conversion shared by the
    comparators."""

    def __init__(self, cfg: PFOConfig, seed: int, device, proj):
        self.cfg = cfg
        self.device = default_device(device)
        if proj is None:
            proj = make_projections(cfg, torch.Generator().manual_seed(seed),
                                    self.device)
        self.proj = {k: torch.as_tensor(v, dtype=torch.float32).to(
            self.device) for k, v in proj.items()}

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids).to(self.device, torch.int32)

    def _vecs(self, vecs) -> torch.Tensor:
        return torch.as_tensor(vecs).to(self.device, torch.float32)

    def _keys(self, vecs: torch.Tensor) -> torch.Tensor:
        """(N, d) -> (N, L) compound keys in [0, 2^32) (int64)."""
        return kops.lsh_hash(vecs, self.proj["table_proj"], self.cfg.M)


def _host(ids: torch.Tensor, dists: torch.Tensor):
    return (ids.cpu().numpy().astype(np.int32),
            dists.cpu().numpy().astype(np.float32))


# ======================================================================
class BruteForce:
    """Exact kNN over an append-only store."""

    def __init__(self, cfg: PFOConfig, device=None):
        self.cfg = cfg
        self.device = default_device(device)
        self.vecs = torch.zeros((0, cfg.dim), dtype=torch.float32,
                                device=self.device)
        self.ids = torch.zeros((0,), dtype=torch.int32, device=self.device)

    def insert(self, ids, vecs) -> None:
        self.ids = torch.cat([self.ids, torch.as_tensor(ids).to(
            self.device, torch.int32)])
        self.vecs = torch.cat([self.vecs, torch.as_tensor(vecs).to(
            self.device, torch.float32)])

    def query(self, q, k: int = 10):
        q = torch.as_tensor(q).to(self.device, torch.float32)
        idx, d = kops.brute_force_topk(q, self.vecs, k, self.cfg.metric)
        return _host(self.ids[idx], d)


# ======================================================================
#: flipping bit 63 maps uint64 order onto int64 order
_SIGN = -(1 << 63)


def _zorder_interleave(h: torch.Tensor, bits_per_key: int,
                       n_keys: int) -> torch.Tensor:
    """Interleave the top ``bits_per_key`` bits of ``n_keys`` compound
    keys into one z-order value (the LSB-Tree's space-filling map): the
    JAX package's uint64, here int64 with the sign bit flipped, so that
    int64 order is the unsigned order.  (The JAX package runs without
    64-bit types, so its values are uint32: the two agree while
    ``bits_per_key * n_keys <= 32``, as at the defaults 8 x 4.)"""
    out = torch.zeros(h.shape[:-1], dtype=torch.int64, device=h.device)
    for b in range(bits_per_key):
        for j in range(n_keys):
            out = (out << 1) | ((h[..., j] >> (31 - b)) & 1)
    return out ^ _SIGN


class ZOrderIndex(_Comparator):
    """Sorted z-order array — the read-optimized B-Tree analogue."""

    def __init__(self, cfg: PFOConfig, seed: int = 0, zkeys: int = 4,
                 zbits: int = 8, window: int = 64, *, device=None,
                 proj: dict | None = None):
        super().__init__(cfg, seed, device, proj)
        self.zkeys, self.zbits, self.window = zkeys, zbits, window
        self.z = torch.zeros((0,), dtype=torch.int64, device=self.device)
        self.ids = torch.zeros((0,), dtype=torch.int32, device=self.device)
        self.vecs = torch.zeros((0, cfg.dim), dtype=torch.float32,
                                device=self.device)

    def _zvals(self, vecs: torch.Tensor) -> torch.Tensor:
        h = self._keys(vecs)
        return _zorder_interleave(h[:, :self.zkeys], self.zbits, self.zkeys)

    def insert(self, ids, vecs) -> None:
        """The write path the paper faults: keep a global sorted order."""
        vecs = self._vecs(vecs)
        self.z = torch.cat([self.z, self._zvals(vecs)])
        self.ids = torch.cat([self.ids, self._ids(ids)])
        self.vecs = torch.cat([self.vecs, vecs])
        order = torch.sort(self.z, stable=True).indices   # the re-sort cost
        self.z, self.ids, self.vecs = (self.z[order], self.ids[order],
                                       self.vecs[order])

    def query(self, q, k: int = 10):
        q = self._vecs(q)
        lo = torch.searchsorted(self.z, self._zvals(q))
        w, n = self.window, self.z.shape[0]
        cand = (lo[:, None] + torch.arange(-w, w, device=self.device)).clamp(
            0, max(n - 1, 0))
        valid = torch.full(cand.shape, n > 0, device=self.device)
        d = kops.pairwise_rank(q, self.vecs[cand], valid, self.cfg.metric)
        neg, idx = torch.topk(-d, k, dim=1)
        return _host(self.ids[cand].gather(1, idx), -neg)


# ======================================================================
class MultiProbeFlat(_Comparator):
    """Flat-bucket multi-probe LSH: each table's buckets are its keys'
    top ``bucket_bits`` bits."""

    def __init__(self, cfg: PFOConfig, seed: int = 0, bucket_bits: int = 10,
                 bucket_cap: int = 128, n_probes: int = 8, *, device=None,
                 proj: dict | None = None):
        super().__init__(cfg, seed, device, proj)
        self.bb, self.cap, self.n_probes = bucket_bits, bucket_cap, n_probes
        nb = 1 << bucket_bits
        i32 = dict(dtype=torch.int32, device=self.device)
        self.bucket_ids = torch.full((cfg.L, nb, bucket_cap), -1, **i32)
        self.bucket_fill = torch.zeros((cfg.L, nb), **i32)
        # the JAX package's id -> vector dict: ids sorted, one row each,
        # the last write winning
        self.vec_ids = torch.zeros((0,), dtype=torch.int64,
                                   device=self.device)
        self.vec_rows = torch.zeros((0, cfg.dim), dtype=torch.float32,
                                    device=self.device)

    def _buckets(self, vecs: torch.Tensor):
        """(N, d) -> buckets (N, L) and keys (N, L), int64."""
        h = self._keys(vecs)
        return h >> (32 - self.bb), h

    def insert(self, ids, vecs) -> None:
        """Rows in order, first come first kept: row r's id goes to slot
        ``fill`` of its bucket in each table while ``fill < bucket_cap``.
        Vectorised per bucket: a stable sort by bucket gives each row its
        rank among the batch's rows of that bucket."""
        ids, vecs = self._ids(ids), self._vecs(vecs)
        L, nb = self.cfg.L, 1 << self.bb
        b, _ = self._buckets(vecs)
        key = (b + torch.arange(L, device=self.device)[None] * nb).reshape(-1)
        skey, order = torch.sort(key, stable=True)
        rank = (torch.arange(key.shape[0], device=self.device)
                - torch.searchsorted(skey, skey))
        fill = self.bucket_fill.view(-1)
        pos = fill[skey] + rank
        masked_put_(self.bucket_ids.view(-1), (skey * self.cap + pos,),
                    ids.repeat_interleave(L)[order], pos < self.cap)
        fill.copy_((fill + torch.bincount(key, minlength=L * nb))
                   .clamp_max(self.cap))
        # vectors by id, the batch's rows after the stored ones
        all_ids = torch.cat([self.vec_ids, ids.to(torch.int64)])
        s, order = torch.sort(all_ids, stable=True)
        last = torch.ones_like(s, dtype=torch.bool)
        last[:-1] = s[:-1] != s[1:]
        self.vec_ids = s[last]
        self.vec_rows = torch.cat([self.vec_rows, vecs])[order[last]]

    def _candidates(self, b: torch.Tensor) -> torch.Tensor:
        """(Q, L) query buckets -> (Q, C) the sorted unique ids stored in
        every probed bucket of every table, padded with -1 (C the largest
        union; one readback sizes it)."""
        nq, L = b.shape
        flips = torch.tensor([0] + [1 << i for i in range(self.n_probes - 1)],
                             device=self.device)
        probes = (b[:, :, None] ^ flips) & ((1 << self.bb) - 1)  # (Q, L, P)
        tl = torch.arange(L, device=self.device)[None, :, None]
        ids = self.bucket_ids[tl, probes].to(torch.int64)     # (Q, L, P, cap)
        held = (torch.arange(self.cap, device=self.device)
                < self.bucket_fill[tl, probes][..., None])
        none = torch.iinfo(torch.int64).max                   # sorts last
        cand = torch.where(held & (ids != -1), ids, none).reshape(nq, -1)
        cand = torch.sort(cand, dim=1).values
        keep = cand != none
        keep[:, 1:] &= cand[:, 1:] != cand[:, :-1]
        width = int(keep.sum(1).max()) if nq else 0
        pos = torch.where(keep, keep.cumsum(1) - 1, width)
        out = torch.full((nq, width + 1), -1, dtype=torch.int64,
                         device=self.device)
        out.scatter_(1, pos, torch.where(keep, cand, -1))
        return out[:, :width].contiguous()

    def query(self, q, k: int = 10):
        q = self._vecs(q)
        nq = q.shape[0]
        out_ids = torch.full((nq, k), -1, dtype=torch.int64,
                             device=self.device)
        out_d = torch.full((nq, k), float("inf"), device=self.device)
        cl = self._candidates(self._buckets(q)[0])
        width = cl.shape[1]
        if width:
            valid = cl >= 0
            at = torch.searchsorted(self.vec_ids, cl).clamp_max(
                self.vec_ids.shape[0] - 1)
            step = max(1, _BLOCK_ELEMS // (width * self.cfg.dim))
            d = torch.cat([kops.pairwise_rank(
                q[s:s + step], self.vec_rows[at[s:s + step]],
                valid[s:s + step], self.cfg.metric)
                for s in range(0, nq, step)])
            kk = min(k, width)
            neg, idx = torch.topk(-d, kk, dim=1)
            hit = torch.isfinite(neg)
            out_ids[:, :kk] = torch.where(hit, cl.gather(1, idx), -1)
            out_d[:, :kk] = -neg
        return _host(out_ids, out_d)


# ======================================================================
class SerializedPFO(_Comparator):
    """PFO's exact index, concurrency management removed (Fig. 7): every
    (vector, table) request goes into its tree one after another, in one
    global order, one ``_tree_insert`` per request over that tree alone."""

    def __init__(self, cfg: PFOConfig, seed: int = 0, *, device=None,
                 proj: dict | None = None):
        super().__init__(cfg, seed, device, proj)
        self.tcfg = lsh_tree_config(cfg)
        self.forest = init_forest(self.tcfg, cfg.L * cfg.n_trees, self.device)

    def insert(self, ids, vecs) -> None:
        cfg = self.cfg
        ids, vecs = self._ids(ids), self._vecs(vecs)
        h = self._keys(vecs)                                       # (N, L)
        region = region_ids(h, self.proj["part_proj"], cfg)
        off = torch.arange(cfg.L, device=self.device)[None] * cfg.n_trees
        trees = (region + off).reshape(-1).tolist()   # the host's order
        flat_h = h.reshape(-1)
        flat_id = ids.to(torch.int64).repeat_interleave(cfg.L)
        row = torch.zeros(1, dtype=torch.int64, device=self.device)
        act = torch.ones(1, dtype=torch.bool, device=self.device)
        for i, t in enumerate(trees):
            tree = TreeState(*(a[t:t + 1] for a in self.forest))   # views
            _tree_insert(tree, row, flat_h[i:i + 1], flat_id[i:i + 1],
                         flat_id[i:i + 1], act, self.tcfg)
