"""Step-cost analysis: per-device FLOPs, memory traffic and collectives
of one step (``cost``), and the analytic model FLOPs (``model_flops``)."""
from .cost import StepStats, analyze_step, local_bytes

__all__ = ["StepStats", "analyze_step", "local_bytes"]
