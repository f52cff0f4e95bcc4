"""The benchmark of ``repro_torch``: online query/update streams through
``StreamEngine`` on one NVIDIA H100 (``run.py``; see README.md)."""
