"""The port's serving layer: the stream engine over a ``PFOIndex``."""
from .stream import (LocalBackend, StreamClient, StreamConfig, StreamEngine,
                     drive)

__all__ = ["StreamConfig", "StreamEngine", "StreamClient", "LocalBackend",
           "drive"]
