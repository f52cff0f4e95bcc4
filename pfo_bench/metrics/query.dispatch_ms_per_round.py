"""Self time of the query rounds' ``dispatch`` and ``result_pickup``
spans (the query path's steps and the wait for its answers) a query
round."""
from pfo_bench.spans import rounds, self_us


def read(run):
    if "spans" not in run or run["spans_dropped"]:
        return None
    n = rounds(run)["query"]
    if not n:
        return None
    us = self_us(run["spans"], lambda name, a: name in (
        "dispatch", "result_pickup") and a.get("kind") == "query")
    return us / 1e3 / n
