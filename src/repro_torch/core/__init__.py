"""The port's PFO core: config, LSH, dispatch, stores, hash forests,
Bloom filters, the sealed ring and the PFOIndex host loop."""
from .config import PFOConfig
from .index import PFOIndex, PFOState, init_state

__all__ = ["PFOConfig", "PFOIndex", "PFOState", "init_state"]
