"""The port's training loop."""
from .loop import TrainConfig, Trainer, make_train_step

__all__ = ["TrainConfig", "Trainer", "make_train_step"]
