"""The share of the traced window in which no operation ran on the
device (the union of kernel, copy and set intervals)."""


def read(run):
    if "busy_s" not in run:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
