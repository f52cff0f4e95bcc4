"""The least time of the window's ``ops.gather_rank`` calls over the device
time of the kernels launched inside them (``pfo_bench/roofline.py``)."""


def read(run):
    r = run.get("roofline", {}).get("gather_rank")
    return None if r is None else 100.0 * r["least_s"] / r["device_s"]
