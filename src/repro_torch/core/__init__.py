"""The port's PFO core: config, LSH, dispatch, stores, hash forests,
Bloom filters, the sealed ring, the cold tier and the PFOIndex host
loop, with the step functions a stream engine drives, and the
distributed rounds on ``torch.distributed``."""
from .coldtier import ColdManager, ColdState
from .config import PFOConfig
from .distributed import (DistConfig, dist_init_state, make_dist_delete_round,
                          make_dist_insert, make_dist_insert_round,
                          make_dist_merge, make_dist_query,
                          make_dist_round_flags, make_dist_seal,
                          shard_occupancy)
from .dispatch import (FLAG_ANY_PENDING, FLAG_COLD_FULL, FLAG_COLD_MISS,
                       FLAG_COLD_SPILL, FLAG_NEED_SEAL, FLAG_SNAPS_FULL,
                       FLAG_TOMBS_FULL, pack_round_flags)
from .index import (PFOIndex, PFOState, delete_step, delete_step_cold,
                    init_state, insert_step, merge_step, query_step,
                    query_step_cold, round_flags, seal_step)

__all__ = [
    "PFOConfig", "PFOIndex", "PFOState", "init_state", "insert_step",
    "query_step", "query_step_cold", "delete_step", "delete_step_cold",
    "seal_step", "merge_step", "round_flags",
    "ColdManager", "ColdState",
    "DistConfig", "dist_init_state", "make_dist_query", "make_dist_insert",
    "make_dist_insert_round", "make_dist_delete_round", "make_dist_seal",
    "make_dist_merge", "make_dist_round_flags", "shard_occupancy",
    "FLAG_ANY_PENDING", "FLAG_NEED_SEAL", "FLAG_SNAPS_FULL",
    "FLAG_TOMBS_FULL", "FLAG_COLD_SPILL", "FLAG_COLD_FULL",
    "FLAG_COLD_MISS", "pack_round_flags",
]
