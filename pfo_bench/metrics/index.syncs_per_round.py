"""Implicit host syncs a round: every sync ``torch.cuda.set_sync_debug_mode
("warn")`` reports, less the one flag readback of each write round and
the one result pickup of each query round."""
from pfo_bench.spans import rounds


def read(run):
    if run.get("syncs") is None:
        return None
    r = rounds(run)
    readbacks = run["after"]["readbacks"] - run["before"]["readbacks"]
    return (run["syncs"] - readbacks - r["query"]) / sum(r.values())
