"""Self time of the ``dispatch`` spans of insert, delete and update
rounds (the write path's steps, enqueue and host work) a write round."""
from pfo_bench.spans import rounds, self_us

WRITES = ("insert", "delete", "update")


def read(run):
    if "spans" not in run or run["spans_dropped"]:
        return None
    n = sum(v for k, v in rounds(run).items() if k in WRITES)
    if not n:
        return None
    us = self_us(run["spans"], lambda name, a: name == "dispatch"
                 and a.get("kind") in WRITES)
    return us / 1e3 / n
