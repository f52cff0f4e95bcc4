"""Sealed snapshot tier (paper §3.2.2) — the device-resident sealed ring.

When a hot partition fills past its threshold, its live entries are
*sealed* into an immutable segment: sorted by compound key (a
bucket-major, read-friendly layout), with a Bloom filter over the
occupied ``snap_prefix_bits``-bit bucket prefixes, and the hot arena
resets.  Queries walk segments newest-first, probing every Bloom filter
in one shot and binary-searching only segments whose filter matched;
merges fold segments together, dropping superseded and deleted ids.

Every function works on a batch of rings with a leading axis B (the L
LSH tables; the MainTable's ring is a batch of one, see :func:`one`).
Keys are uint32 values held in int64; the pad key is 0xFFFFFFFF.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import bloom as bloom_mod
from .config import PFOConfig
from .membership import member_sorted

PAD_KEY = 0xFFFFFFFF
INT_MAX = 2**31 - 1


class SnapshotSet(NamedTuple):
    keys: torch.Tensor     # u32 as i64 (B, S, cap) sorted per segment
    ids: torch.Tensor      # i32 (B, S, cap) vector ids; -1 pad
    vals: torch.Tensor     # i32 (B, S, cap) payloads
    counts: torch.Tensor   # i32 (B, S) live entries per segment
    blooms: torch.Tensor   # u32 as i64 (B, S, W) packed filters
    n_snaps: torch.Tensor  # i32 (B,) segments in use (newest == n_snaps-1)
    stamps: torch.Tensor   # i32 (B, S) seal sequence number


def one(snaps: SnapshotSet) -> SnapshotSet:
    """View an unbatched ring (no leading axis) as a batch of one."""
    return SnapshotSet(*(f.unsqueeze(0) for f in snaps))


def unbatch(snaps: SnapshotSet) -> SnapshotSet:
    """The single ring of a batch of one, without the leading axis."""
    return SnapshotSet(*(f.squeeze(0) for f in snaps))


def init_snapshots(cfg: PFOConfig, batch: int = 1, device=None) -> SnapshotSet:
    S, cap = cfg.max_snapshots, cfg.snapshot_capacity
    i32 = dict(dtype=torch.int32, device=device)
    return SnapshotSet(
        keys=torch.full((batch, S, cap), PAD_KEY, dtype=torch.int64,
                        device=device),
        ids=torch.full((batch, S, cap), -1, **i32),
        vals=torch.zeros((batch, S, cap), **i32),
        counts=torch.zeros((batch, S), **i32),
        blooms=torch.zeros((batch, S, cfg.bloom_bits_eff // 32),
                           dtype=torch.int64, device=device),
        n_snaps=torch.zeros((batch,), **i32),
        stamps=torch.zeros((batch, S), **i32),
    )


def _prefix(keys: torch.Tensor, bits: int) -> torch.Tensor:
    return keys >> (32 - bits)


def probe_prefixes(hs: torch.Tensor, cfg: PFOConfig) -> torch.Tensor:
    """Multi-probe bucket prefixes: (..., N) keys -> (..., N, P).  Column
    0 is the landing prefix, then its xor-adjacent neighbours."""
    pfx = _prefix(hs, cfg.snap_prefix_bits)
    return pfx[..., None] ^ torch.arange(cfg.snap_probes, device=hs.device)


def seal(snaps: SnapshotSet, keys: torch.Tensor, ids: torch.Tensor,
         vals: torch.Tensor, mask: torch.Tensor, stamp: torch.Tensor,
         cfg: PFOConfig) -> SnapshotSet:
    """Seal live entries into the next segment of each ring, in place.

    keys/ids/vals/mask: (B, N) with N <= snapshot_capacity; ``mask``
    marks live rows.  A ring that is already full drops the segment (as
    the reference's out-of-bounds scatter does)."""
    cap = cfg.snapshot_capacity
    b, n = keys.shape
    S = snaps.keys.shape[1]
    dev = keys.device
    assert n <= cap, f"seal batch {n} exceeds snapshot capacity {cap}"
    sort_key = torch.where(mask, keys, PAD_KEY)
    skeys, order = torch.sort(sort_key, dim=1, stable=True)
    sids = torch.where(mask.gather(1, order), ids.gather(1, order), -1)
    svals = vals.gather(1, order)
    count = mask.sum(1, dtype=torch.int32)

    pad = cap - n
    if pad:
        skeys = torch.cat([skeys, torch.full((b, pad), PAD_KEY,
                                             dtype=torch.int64, device=dev)], 1)
        sids = torch.cat([sids, torch.full((b, pad), -1, dtype=sids.dtype,
                                           device=dev)], 1)
        svals = torch.cat([svals, torch.zeros((b, pad), dtype=svals.dtype,
                                              device=dev)], 1)
    filt = bloom_mod.build(_prefix(skeys, cfg.snap_prefix_bits),
                           cfg.bloom_hashes_eff, cfg.bloom_bits_eff,
                           mask=sids >= 0)

    s = snaps.n_snaps.to(torch.int64)
    fits = s < S
    rows = torch.arange(b, device=dev)
    sc = s.clamp_max(S - 1)

    def put(dst, new):
        cur = dst[rows, sc]
        m = fits.reshape(b, *([1] * (new.dim() - 1)))
        dst[rows, sc] = torch.where(m, new.to(dst.dtype), cur)

    put(snaps.keys, skeys)
    put(snaps.ids, sids)
    put(snaps.vals, svals)
    put(snaps.counts, count)
    put(snaps.blooms, filt)
    put(snaps.stamps, stamp.expand(b))
    return snaps._replace(n_snaps=snaps.n_snaps + 1)


def span_gather(keys: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
                act: torch.Tensor, pfx: torch.Tensor, cfg: PFOConfig):
    """Gather bucket spans of sorted segments for probe prefixes.

    keys/ids/vals: (..., cap) segments; act/pfx: (..., M) probe masks and
    prefixes.  Returns (cids, cvals, cpos, matched): (..., M, budget)
    candidate ids / vals / positions (-1 pad) and a (..., M) bool marking
    probes whose span was non-empty.
    """
    cap = keys.shape[-1]
    budget = cfg.snap_budget_per_probe
    shift = 32 - cfg.snap_prefix_bits
    lo_key = pfx << shift
    lo = torch.searchsorted(keys, lo_key)
    # int64 keys do not wrap: the all-ones prefix's upper bound 2^32 lies
    # past every key (pad included), so its span runs to the end
    hi = torch.searchsorted(keys, lo_key + (1 << shift))
    pos = lo[..., None] + torch.arange(budget, device=keys.device)
    ok = (pos < hi[..., None]) & act[..., None] & (pos < cap)
    safe = torch.where(ok, pos, 0)
    flat = safe.reshape(*safe.shape[:-2], -1)
    cids = torch.where(ok, ids.gather(-1, flat).reshape(ok.shape), -1)
    cvals = torch.where(ok, vals.gather(-1, flat).reshape(ok.shape), -1)
    cpos = torch.where(ok, pos, -1)
    return cids, cvals, cpos, act & (hi > lo)


def probe(snaps: SnapshotSet, hs: torch.Tensor, cfg: PFOConfig):
    """Search every segment for bucket-prefix matches of query keys.

    hs: (B, N) keys.  Returns (ids, vals): (B, N, S * P * budget)
    candidates (-1 pad), newest segment first per query, the landing
    probe first within a segment.
    """
    b, S, _ = snaps.keys.shape
    n, P = hs.shape[1], cfg.snap_probes
    pfx = probe_prefixes(hs, cfg).reshape(b, -1)                 # (B, N*P)
    hit = bloom_mod.contains_multi(snaps.blooms, pfx,
                                   cfg.bloom_hashes_eff)         # (B, S, N*P)
    live = (torch.arange(S, device=hs.device)[None, :]
            < snaps.n_snaps[:, None])                            # (B, S)
    active = live[..., None] & hit
    cids, cvals, _, _ = span_gather(
        snaps.keys, snaps.ids, snaps.vals, active,
        pfx[:, None, :].expand(b, S, n * P).contiguous(), cfg)   # (B,S,NP,bud)
    rev = torch.arange(S - 1, -1, -1, device=hs.device)

    def flat(c):                                         # (B, N, S*P*bud)
        c = c[:, rev].permute(0, 2, 1, 3).reshape(b, n, P, S, -1)
        return c.permute(0, 1, 3, 2, 4).reshape(b, n, -1)

    return flat(cids), flat(cvals)


def lookup_exact(snaps: SnapshotSet, hs: torch.Tensor, vids: torch.Tensor,
                 cfg: PFOConfig):
    """Exact (key, id) lookups in a batch-of-one ring (MainTable path),
    newest segment first: (N,) -> (val, found).

    The JAX package's search: the first ``snap_budget_per_probe`` entries
    of the key's prefix bucket.  The index searches its MainTable ring
    with :func:`lookup_key_run` instead."""
    cids, cvals = probe(snaps, hs[None], cfg)
    cids, cvals = cids[0], cvals[0]
    match = (cids >= 0) & (cids == vids[:, None])
    idx = match.to(torch.uint8).argmax(1)                        # first hit
    found = match.any(1)
    val = cvals.gather(1, idx[:, None])[:, 0]
    return torch.where(found, val, -1), found


def lookup_key_run(snaps: SnapshotSet, hs: torch.Tensor, vids: torch.Tensor,
                   cfg: PFOConfig):
    """Id lookups in a batch-of-one MainTable ring, newest segment first:
    (N,) -> (val, found), as :func:`lookup_exact` returns them.

    ``hs`` are the ids' MainTable keys.  A MainTable key is its id's
    hash, so every copy of an id in a sorted segment lies in the run of
    entries whose key is the query key, and each segment is searched over
    the first ``snap_budget_per_probe`` entries from the run's start.
    :func:`lookup_exact` searches as many entries from the start of the
    key's prefix bucket, which holds the run: the two agree while a bucket
    fits the budget, but a bucket outgrows it once a segment holds a few
    entries a prefix (~120 at 500,000 sealed items and 12 prefix bits).
    The bucket search then misses an id past the budget, which is neither
    found nor deleted and comes back once a merge shrinks its bucket, and
    finds an older copy of an id whose newer copy lies past it."""
    _, S, cap = snaps.keys.shape
    n, dev = hs.shape[0], hs.device
    keys, ids = snaps.keys[0], snaps.ids[0]                      # (S, cap)
    lo = torch.searchsorted(keys, hs.to(keys.dtype)[None].expand(S, n)
                            .contiguous())                       # (S, N)
    pos = lo[..., None] + torch.arange(cfg.snap_budget_per_probe,
                                       device=dev)               # (S, N, bud)
    got = ids.gather(1, pos.clamp_max(cap - 1).reshape(S, -1)).reshape(
        pos.shape)
    live = (torch.arange(S, device=dev) < snaps.n_snaps[0])[:, None, None]
    match = live & (pos < cap) & (got >= 0) & (got == vids[:, None])
    # the newest segment with a hit, then its first hit
    seg = (match.any(2) * torch.arange(1, S + 1, device=dev)[:, None]
           ).amax(0) - 1                                         # (N,)
    found = seg >= 0
    seg = seg.clamp_min(0)
    col = torch.arange(n, device=dev)
    first = match[seg, col].to(torch.uint8).argmax(1)
    at = (lo[seg, col] + first).clamp_max(cap - 1)
    val = snaps.vals[0][seg, at]
    return torch.where(found, val, -1), found


#: a mixed view's padding: past every (table << 32 | key)
_VIEW_PAD = 1 << 62


def mixed_view(keys: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor):
    """Mixed-table segments (..., cap) — a distributed shard's ring or
    cold chain, sorted by key with the LSH table id in ``vals`` — seen
    sorted by (table, key): the composite keys ``table << 32 | key``
    (padding last) with the ids and vals in that order.  A table's
    entries of a prefix bucket are then one run, so a probe of the view
    reads the first ``snap_budget_per_probe`` entries *of its table*,
    exactly the span a single-device per-table segment gives, where the
    mixed segment's own bucket span is shared by every table."""
    comp = torch.where(ids >= 0, (vals.to(torch.int64) << 32) | keys,
                       _VIEW_PAD)
    comp, order = torch.sort(comp, dim=-1, stable=True)
    return comp, ids.gather(-1, order), vals.gather(-1, order)


def table_prefixes(hs: torch.Tensor, cfg: PFOConfig) -> torch.Tensor:
    """Composite probe prefixes of a mixed view: (L, N) keys ->
    (L, N, P) ``table << prefix_bits | prefix``."""
    L = hs.shape[0]
    table = torch.arange(L, device=hs.device)[:, None, None]
    return (table << cfg.snap_prefix_bits) | probe_prefixes(hs, cfg)


def probe_mixed(snaps: SnapshotSet, view, hs: torch.Tensor, cfg: PFOConfig):
    """:func:`probe` of a batch-of-one mixed ring through its
    :func:`mixed_view`: hs (L, N) keys of table l in row l -> ids
    (L, N, S * P * budget), newest segment first.  The Bloom filters are
    the ring's own (over every table's prefixes)."""
    _, S, _ = snaps.keys.shape
    L, n = hs.shape
    P = cfg.snap_probes
    pfx = probe_prefixes(hs, cfg).reshape(1, -1)                # (1, LNP)
    hit = bloom_mod.contains_multi(snaps.blooms, pfx,
                                   cfg.bloom_hashes_eff)[0]    # (S, LNP)
    live = torch.arange(S, device=hs.device) < snaps.n_snaps[0]
    comp, vids, vvals = (v[0] for v in view)
    cp = table_prefixes(hs, cfg).reshape(1, -1).expand(S, -1).contiguous()
    cids, _, _, _ = span_gather(comp, vids, vvals, live[:, None] & hit, cp,
                                cfg)                           # (S, LNP, B)
    rev = torch.arange(S - 1, -1, -1, device=hs.device)
    c = cids[rev].reshape(S, L, n, P, -1).permute(1, 2, 0, 3, 4)
    return c.reshape(L, n, -1)


def pop_oldest(snaps: SnapshotSet, cfg: PFOConfig):
    """Pop each ring's oldest segment (index 0).  Returns (shifted_set,
    popped) with ``popped`` a dict of the evicted segments' tensors —
    the device half of a cold-tier spill.  Callers ensure n_snaps > 0."""
    popped = {"keys": snaps.keys[:, 0], "ids": snaps.ids[:, 0],
              "vals": snaps.vals[:, 0], "count": snaps.counts[:, 0],
              "bloom": snaps.blooms[:, 0], "stamp": snaps.stamps[:, 0]}

    def shift(a, fill):
        out = torch.roll(a, -1, dims=1)
        out[:, -1] = fill
        return out

    shifted = SnapshotSet(
        keys=shift(snaps.keys, PAD_KEY), ids=shift(snaps.ids, -1),
        vals=shift(snaps.vals, 0), counts=shift(snaps.counts, 0),
        blooms=shift(snaps.blooms, 0), stamps=shift(snaps.stamps, 0),
        n_snaps=(snaps.n_snaps - 1).clamp_min(0))
    return shifted, popped


def merge(snaps: SnapshotSet, cfg: PFOConfig,
          deleted_ids: torch.Tensor | None = None,
          group_by_val: bool = False,
          drop: torch.Tensor | None = None) -> SnapshotSet:
    """Merge compaction: fold each ring's segments into one, newest
    version of each id wins, deleted ids dropped.  Returns fresh rings
    holding a single segment (at most one segment's worth is kept).

    ``group_by_val`` keeps the newest version per (val, id) instead of
    per id: a distributed shard seals all of its trees into one mixed
    ring with the LSH table id in ``vals``, where an id lives once per
    table.  Tombstones still match by id.  ``drop`` (b, S, cap) marks
    entries the fold must not keep (a distributed shard's entries that
    a newer entry on another shard supersedes)."""
    b, S, cap = snaps.keys.shape
    dev = snaps.keys.device
    keys = snaps.keys.reshape(b, -1)
    ids = snaps.ids.reshape(b, -1)
    vals = snaps.vals.reshape(b, -1)
    rank = snaps.stamps[:, :, None].expand(b, S, cap).reshape(b, -1)
    live = ids >= 0
    if deleted_ids is not None and deleted_ids.shape[0] > 0:
        live = live & ~member_sorted(ids, deleted_ids)
    if drop is not None:
        live = live & ~drop.reshape(b, -1)

    # order by ([val,] id, newest stamp first), ties in storage order:
    # stable sorts chained from the least significant key (the lexsort)
    ikey = torch.where(live, ids, INT_MAX)
    order = torch.sort(-rank, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(ikey.gather(1, order), dim=1,
                                       stable=True).indices)
    if group_by_val:
        gkey = torch.where(live, vals, 0)
        order = order.gather(1, torch.sort(gkey.gather(1, order), dim=1,
                                           stable=True).indices)
    sids = torch.where(live.gather(1, order), ids.gather(1, order), -1)
    new_id = sids[:, 1:] != sids[:, :-1]
    if group_by_val:
        sgrp = gkey.gather(1, order)
        new_id = new_id | (sgrp[:, 1:] != sgrp[:, :-1])
    first_of_id = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=dev), new_id],
        1) & (sids >= 0)
    keep_keys = torch.where(first_of_id, keys.gather(1, order), PAD_KEY)
    keep_ids = torch.where(first_of_id, sids, -1)
    keep_vals = torch.where(first_of_id, vals.gather(1, order), 0)

    take = min(cap, keep_keys.shape[1])
    korder = torch.sort((keep_ids < 0).to(torch.uint8), dim=1,
                        stable=True).indices[:, :take]
    keep_keys, keep_ids, keep_vals = (keep_keys.gather(1, korder),
                                      keep_ids.gather(1, korder),
                                      keep_vals.gather(1, korder))
    merged = init_snapshots(cfg, b, dev)
    return seal(merged, keep_keys, keep_ids, keep_vals, keep_ids >= 0,
                snaps.stamps.max(1).values, cfg)
