"""The port's cold-tier file layer (its own copy of the JAX package's
``storage`` package: pure numpy, no torch)."""
from .segments import SEGMENT_DTYPE, SegmentStore

__all__ = ["SEGMENT_DTYPE", "SegmentStore"]
