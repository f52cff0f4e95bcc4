"""The port's serving layer: the LM serving engine with its kNN-LM head,
and the stream engine over a ``PFOIndex`` or a distributed shard
(``DistBackend``)."""
from .engine import (ServeConfig, ServingEngine, make_decode_step,
                     make_prefill_step)
from .stream import (DistBackend, DistStreamEngine, LocalBackend,
                     StreamClient, StreamConfig, StreamEngine, drive)

__all__ = ["ServeConfig", "ServingEngine", "make_prefill_step",
           "make_decode_step", "StreamConfig", "StreamEngine",
           "DistStreamEngine", "StreamClient", "LocalBackend",
           "DistBackend", "drive"]
