"""Self time of the engine's ``pack`` spans (host batch packing) a round."""
from pfo_bench.spans import rounds, self_us


def read(run):
    if "spans" not in run or run["spans_dropped"]:
        return None
    n = sum(rounds(run).values())
    return self_us(run["spans"], lambda name, a: name == "pack") / 1e3 / n
