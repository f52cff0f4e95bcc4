"""Rounds of every kind (query rounds too) a window of the stream engine
ran (``StreamEngine.stats()["rounds_by_kind"]``)."""
from pfo_bench.spans import rounds


def read(run):
    return sum(rounds(run).values()) / run["windows"]
