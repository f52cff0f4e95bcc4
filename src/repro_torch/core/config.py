"""PFO configuration (paper §3-§5 notation, Table 2).

Every field mirrors a symbol in the paper:
  L  — number of LSH tables
  C  — number of partition-level LSH functions (2^C partitions / table)
  m  — bits of the compound key used to pick the hash tree (2^m trees
       per partition)
  l  — slots per non-leaf (directory) node; each tree level consumes
       log2(l) bits of the key
  t  — max leaves chained under one slot before a spread-to-next-level
  M  — compound key length in bits (uint32 keys => M == 32)

Capacity knobs size the pre-allocated off-heap arenas (device tensors
standing in for the paper's off-heap segments) and the sealed-snapshot
tier.  This is the PyTorch port's own copy of the JAX package's
``PFOConfig``: the same fields, defaults and derived properties, so a
config built from the same keywords sizes both systems identically.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PFOConfig:
    dim: int = 64                 # vector dimensionality d
    L: int = 10                   # LSH tables
    C: int = 4                    # partition-level hash functions
    m: int = 4                    # tree-selection bits
    l: int = 128                  # directory-node slots (power of two)
    t: int = 4                    # bucket spread threshold
    M: int = 32                   # compound key bits (uint32)

    # --- arena capacities (per tree) -------------------------------
    max_nodes_per_tree: int = 128
    max_leaves_per_tree: int = 1024

    # --- MainTable -------------------------------------------------
    main_m: int = 6               # murmur tree-selection bits for MainTable
    main_max_nodes_per_tree: int = 256
    main_max_leaves_per_tree: int = 4096
    store_capacity: int = 65536   # vector store slots

    # --- query shaping ----------------------------------------------
    max_candidates_per_probe: int = 32   # leaves collected per tree probe
    max_candidates_total: int = 512      # after union over L tables+snaps

    # --- traversal discipline ----------------------------------------
    # "masked" (default): fixed-trip descent + static-length chain
    # gather; batched query rows run in lockstep so large query batches
    # amortize.  "loop" is the JAX package's data-dependent walk, kept
    # there for differential testing; the port accepts the field so
    # configs stay interchangeable but raises on "loop" (hash_tree.py).
    traversal: str = "masked"
    # static chain-gather bound for the masked path; 0 means "use
    # max_candidates_per_probe", which makes the masked path return
    # bit-identical results to the loop path (a chain can never
    # contribute more than max_candidates leaves to a probe).
    max_chain: int = 0

    # --- hierarchical memory (sealed snapshot tier) -----------------
    seal_threshold: float = 0.85         # hot-tier fill fraction triggering seal
    max_snapshots: int = 8
    max_tombstones: int = 1024           # pending-delete buffer (merge drains it)
    snapshot_capacity: int = 65536       # entries per sealed segment
    snap_prefix_bits: int = 12           # bucket-prefix resolution of snapshot probes
    snap_budget_per_probe: int = 32      # candidates gathered per snapshot probe
    # sealed/cold-tier multi-probe: prefixes probed per (row, table) in
    # xor-adjacent order (p=0 == the landing prefix; fixed-trip, so the
    # probe shape is static).  1 == the paper's single-bucket probe.
    snap_probes: int = 1
    # Bloom sizing: 0 (default) auto-derives from the segment's expected
    # distinct-prefix count and ``bloom_fp_target`` (the classic
    # m = -n ln p / (ln 2)^2, k = (m/n) ln 2 formulas); an explicit
    # value pins it (the pre-auto-sizing behavior).
    bloom_bits: int = 0
    bloom_hashes: int = 0
    bloom_fp_target: float = 0.01

    # --- cold tier (host/flash-resident sealed segments) -------------
    # cold_segments > 0 enables the cold tier: when the device snapshot
    # ring fills, the oldest sealed segment of every table spills to a
    # host-resident SegmentStore while its Bloom filter/stamp/count stay
    # device-resident in a compact routing table.  Queries probe all
    # filters (hot + cold) in one shot and fetch only matched cold
    # segments into a small device-resident LRU cache.
    cold_segments: int = 0               # routing-table slots per tier (0 = off)
    cold_cache_slots: int = 2            # device LRU cache entries per tier kind
    cold_fetch_rounds: int = 4           # max fetch/re-probe rounds per query
    # Tiered vector store: sealed cold MainTable segments carry their
    # own vector payloads, and a spill frees the store slots of every
    # entry it takes sole custody of — so the dense store only has to
    # hold the hot + ring working set, not the whole dataset.  When the
    # free list falls below this watermark the flag word raises
    # STORE_FULL and the host loop spills (seal-then-spill if the ring
    # is empty) until allocation headroom returns.  0 disables the
    # proactive path (the store must then be sized for the full
    # dataset, the pre-tiered behavior).
    store_low_watermark: int = 0

    # --- metric ------------------------------------------------------
    metric: str = "angular"              # "angular" | "l2"
    # beyond-paper: multi-probe the landing node's sibling slots
    sibling_probe: bool = False

    # ------------------------------------------------------------------
    @property
    def log2_l(self) -> int:
        return int(math.log2(self.l))

    @property
    def n_partitions(self) -> int:
        return 1 << self.C

    @property
    def trees_per_partition(self) -> int:
        return 1 << self.m

    @property
    def n_trees(self) -> int:
        """Total regions per LSH table: 2^(C+m) (paper §4.1)."""
        return 1 << (self.C + self.m)

    @property
    def main_n_trees(self) -> int:
        return 1 << self.main_m

    @property
    def max_depth(self) -> int:
        """Tree levels available after the first m bits pick the tree."""
        return (self.M - self.m) // self.log2_l

    @property
    def main_max_depth(self) -> int:
        return (self.M - self.main_m) // self.log2_l

    @property
    def cold_enabled(self) -> bool:
        return self.cold_segments > 0

    @property
    def bloom_keys_expected(self) -> int:
        """Distinct Bloom keys a full segment can contribute: occupied
        bucket prefixes, bounded by both the segment fill and the prefix
        space."""
        return max(1, min(self.snapshot_capacity, 1 << self.snap_prefix_bits))

    @property
    def bloom_bits_eff(self) -> int:
        """Filter size in bits: explicit value, else auto-derived from
        ``bloom_keys_expected`` and ``bloom_fp_target`` (rounded up to a
        whole number of u32 words)."""
        if self.bloom_bits:
            return self.bloom_bits
        n = self.bloom_keys_expected
        bits = math.ceil(-n * math.log(self.bloom_fp_target)
                         / (math.log(2) ** 2))
        return max(64, ((bits + 31) // 32) * 32)

    @property
    def bloom_hashes_eff(self) -> int:
        """Hash count: explicit value, else the optimal (m/n) ln 2."""
        if self.bloom_hashes:
            return self.bloom_hashes
        k = round(self.bloom_bits_eff / self.bloom_keys_expected
                  * math.log(2))
        return max(1, min(8, k))

    def __post_init__(self):
        assert self.traversal in ("loop", "masked")
        assert self.max_chain >= 0
        assert self.l & (self.l - 1) == 0, "l must be a power of two"
        assert self.M == 32, "uint32 compound keys"
        assert self.C + self.m <= 16
        assert self.max_depth >= 1, "need at least one directory level"
        assert self.snap_probes >= 1
        assert self.snap_probes <= (1 << self.snap_prefix_bits)
        assert 0.0 < self.bloom_fp_target < 1.0
        assert self.bloom_bits % 32 == 0
        if self.cold_enabled:
            assert self.cold_cache_slots >= 1
            assert self.cold_fetch_rounds >= 1
        assert self.store_low_watermark >= 0
        if self.store_low_watermark:
            assert self.cold_enabled, (
                "store_low_watermark needs the cold tier: spilled "
                "payloads are the only way slots leave the store")
            assert self.store_low_watermark < self.store_capacity
