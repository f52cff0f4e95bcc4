"""The port's serving layer: the stream engine over a ``PFOIndex`` or a
distributed shard (``DistBackend``)."""
from .stream import (DistBackend, DistStreamEngine, LocalBackend,
                     StreamClient, StreamConfig, StreamEngine, drive)

__all__ = ["StreamConfig", "StreamEngine", "StreamClient", "LocalBackend",
           "DistBackend", "DistStreamEngine", "drive"]
