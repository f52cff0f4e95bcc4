"""The port's optimizer: AdamW on trees of tensors."""
from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule"]
