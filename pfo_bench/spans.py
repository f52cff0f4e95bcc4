"""Self time of the program's host spans (``repro_torch.obs`` tracer
events: ``(name, ts_us, dur_us, tid, args)``), for the per-layer
metrics."""
from __future__ import annotations


def self_us(events: list, keep) -> float:
    """Summed self time, in us, of the spans ``keep(name, args)`` selects:
    each span's duration less the parts its child spans (on its thread)
    cover."""
    total = 0.0
    by_tid: dict = {}
    for ev in events:
        by_tid.setdefault(ev[3], []).append(ev)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e[1], -e[2]))
        stack: list = []            # [end, child_us, selected]
        for name, ts, dur, _, args in evs:
            while stack and stack[-1][0] <= ts:
                total += _close(stack.pop())
            if stack:
                stack[-1][1] += dur
            stack.append([ts + dur, 0.0, keep(name, args), dur])
        while stack:
            total += _close(stack.pop())
    return total


def _close(frame) -> float:
    end, child, selected, dur = frame
    return dur - child if selected else 0.0


def rounds(run: dict) -> dict:
    """Rounds by kind the engine ran in the window."""
    a, b = run["after"]["rounds_by_kind"], run["before"]["rounds_by_kind"]
    return {k: a[k] - b[k] for k in a}
