"""The traced run's device side: a ``torch.profiler`` session over the
window, reduced to busy time, kernel time by name, the idle gaps named
by what the host was doing, and the device time of the kernels each
``record_function`` range of the benchmark launched.

Once one profiler session has run in a process, later ones lose their
first device events; every session therefore opens with ``LEAD_IN``
one-cycle spins whose kernel no measured call launches, and the count of
those lost is reported.
"""
from __future__ import annotations

import numpy as np
import torch

LEAD_IN = 256
SPIN = "spin_kernel"
RANGE_PREFIX = "pfo_bench."     # a kernel entry's range: pfo_bench.<kernel>
WINDOW = "pfo_bench:window"     # the measured window's range
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def start():
    """A started profiler session over host and device, opened by the
    lead-in spins."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(LEAD_IN):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    return prof


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[float, list]:
    """Total length of the union of [start, end) intervals and the gaps
    between its pieces as (start, end) pairs."""
    if starts.size == 0:
        return 0.0, []
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, bool)
    new[1:] = s[1:] > reach[:-1]
    piece_s = s[new]
    piece_e = np.append(reach[np.flatnonzero(new)[1:] - 1], reach[-1])
    gaps = list(zip(piece_e[:-1], piece_s[1:]))
    return float((piece_e - piece_s).sum()), gaps


def _kind(ev) -> str:
    """The event's Kineto activity type.  Where this torch's events do not
    say (2.11), it is read from the event: device events are ``device``
    (kernels, copies, sets, and the device side of annotations, which
    :func:`reduce` drops by name), host calls into CUDA ``cuda_runtime``,
    operators ``cpu_op``, the rest annotations."""
    get = getattr(ev, "activity_type", None)
    if get is not None:
        return get()
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
        return "device"
    name = ev.name()
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op" if "::" in name else "user_annotation"


def reduce(prof) -> dict:
    """What the session saw inside the ``WINDOW`` range: ``window_s``,
    ``busy_s`` (union of device activity),
    ``device_ops`` [[name, s]] (top 10), ``idle_gaps`` [[host activity,
    s]] (the 10 longest), ``ranges`` {range name: {"device_s", "kernels"}}
    and ``lead_in_lost``."""
    events = prof.profiler.kineto_results.events()
    cpu_s, cpu_e, cpu_name, cpu_ann = [], [], [], []
    launch_at: dict = {}
    dev_s, dev_e, dev_name, dev_link = [], [], [], []
    spins = 0
    t0_ns = t1_ns = None
    for ev in events:
        kind = _kind(ev)
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if kind not in DEVICE_KINDS + ("device",):
                continue
            name = ev.name()
            if SPIN in name:
                spins += 1
                continue
            dev_s.append(ev.start_ns())
            dev_e.append(ev.start_ns() + ev.duration_ns())
            dev_name.append(name)
            dev_link.append(ev.linked_correlation_id()
                            or ev.correlation_id())
        elif kind in ("cuda_runtime", "cuda_driver"):
            launch_at[ev.correlation_id()] = ev.start_ns()
        elif kind == "user_annotation" and ev.name() == WINDOW:
            t0_ns, t1_ns = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        elif kind in ("cpu_op", "user_annotation"):
            cpu_s.append(ev.start_ns())
            cpu_e.append(ev.start_ns() + ev.duration_ns())
            cpu_name.append(ev.name())
            cpu_ann.append(kind == "user_annotation")
    if t0_ns is None:
        raise RuntimeError(f"the profiler recorded no {WINDOW} range")
    ds, de = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    notes = {n for n, a in zip(cpu_name, cpu_ann) if a} | {WINDOW}
    real = np.asarray([n not in notes for n in dev_name], bool)
    inside = (de > t0_ns) & (ds < t1_ns) & real
    cs = np.clip(ds, t0_ns, t1_ns)
    ce = np.clip(de, t0_ns, t1_ns)
    if not inside.any():
        raise RuntimeError(f"the profiler kept no device event inside "
                           f"{WINDOW} ({LEAD_IN - spins} of {LEAD_IN} "
                           f"lead-in spins lost)")
    busy_ns, gaps = _union(cs[inside], ce[inside])

    per: dict = {}
    for i in np.flatnonzero(inside):
        per[dev_name[i]] = per.get(dev_name[i], 0) + int(ce[i] - cs[i])
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]

    c_s, c_e = np.asarray(cpu_s, np.int64), np.asarray(cpu_e, np.int64)
    c_ann = np.asarray(cpu_ann, bool)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        idle.append([_host_at(mid, c_s, c_e, c_ann, cpu_name),
                     (g1 - g0) / 1e9])

    ranges: dict = {}
    spans = [(c_s[i], c_e[i], cpu_name[i]) for i in np.flatnonzero(c_ann)
             if cpu_name[i].startswith(RANGE_PREFIX)]
    if spans:
        spans.sort()
        r_s = np.asarray([s[0] for s in spans], np.int64)
        r_e = np.asarray([s[1] for s in spans], np.int64)
        for i in np.flatnonzero(inside):
            at = launch_at.get(dev_link[i])
            if at is None:
                continue
            j = int(np.searchsorted(r_s, at, side="right")) - 1
            if j >= 0 and at <= r_e[j]:
                acc = ranges.setdefault(spans[j][2][len(RANGE_PREFIX):],
                                        {"device_s": 0.0, "kernels": 0})
                acc["device_s"] += (de[i] - ds[i]) / 1e9
                acc["kernels"] += 1
    return dict(window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy_ns / 1e9,
                device_ops=[[n[:120], ns / 1e9] for n, ns in top],
                idle_gaps=idle, ranges=ranges, lead_in_lost=LEAD_IN - spins,
                device_events=int(inside.sum()))


def _host_at(t: int, c_s, c_e, c_ann, names) -> str:
    """The innermost span and the innermost operator the host was in at
    ``t``, as ``span > op`` (``-`` where none)."""
    cover = (c_s <= t) & (c_e >= t)
    out = []
    for sel in (cover & c_ann, cover & ~c_ann):
        idx = np.flatnonzero(sel)
        out.append(names[idx[np.argmin(c_e[idx] - c_s[idx])]]
                   if idx.size else "-")
    return " > ".join(out)
