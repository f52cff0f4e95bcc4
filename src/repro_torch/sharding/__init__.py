"""Process layout of the port's distributed engine."""
from .policy import StreamMesh, stream_mesh

__all__ = ["StreamMesh", "stream_mesh"]
