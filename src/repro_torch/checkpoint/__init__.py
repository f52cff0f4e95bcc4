"""Checkpoints of the port, in the JAX package's on-disk format."""
from .ckpt import (latest_step, load_dist_checkpoint, load_index_checkpoint,
                   restore_checkpoint, save_checkpoint, save_dist_checkpoint,
                   save_index_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "save_index_checkpoint", "load_index_checkpoint",
           "save_dist_checkpoint", "load_dist_checkpoint"]
