"""Deterministic data generators (numpy only)."""
from .pipeline import SyntheticLM, VectorStream

__all__ = ["SyntheticLM", "VectorStream"]
