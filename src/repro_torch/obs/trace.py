"""Phase spans recorded into a bounded ring buffer, exportable as
Chrome/Perfetto ``trace_event`` JSON.

A span times a *host-side* phase of the serving loop::

    with tracer.span("dispatch", kind="insert", bucket=64):
        ...               # the jitted round is dispatched here

Spans never block on device values — what they measure is the host
wall-clock of the phase (for an async dispatch that is the enqueue
cost; the blocking ``flag_readback`` span absorbs the device time), so
tracing respects the one-readback-per-round invariant by construction.

The ring holds the most recent ``capacity`` completed spans as plain
tuples; wraparound overwrites oldest-first, so a long-running server
keeps a bounded trace of its recent rounds.  ``export()`` emits the
standard ``{"traceEvents": [...]}`` JSON object format (``ph: "X"``
complete events, microsecond timestamps) that ``chrome://tracing`` and
https://ui.perfetto.dev load directly; thread-name metadata events
(``ph: "M"``) label each host thread.

When the optional ``profiler_annotations`` bridge is on, every span
also enters a ``torch.profiler.record_function`` so the phases line up
with device activity inside a captured ``torch.profiler`` trace.

:data:`NULL_TRACER` is the disabled twin: ``span()`` returns a shared
no-op context manager — one branch + two empty calls per span, nothing
recorded.
"""
from __future__ import annotations

import json
import threading
import time


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every span is the shared no-op singleton."""
    enabled = False
    dropped = 0

    def span(self, name: str, **args):
        return NULL_SPAN

    def events(self) -> list:
        return []

    def export(self) -> dict:
        return {"traceEvents": []}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tracer", "name", "args", "t0", "_ann")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        tr = self._tracer
        if tr._annotate is not None:
            self._ann = tr._annotate(self.name)
            self._ann.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(*exc)
        self._tracer._record(self.name, self.t0, t1, self.args)
        return False


class Tracer:
    """Span recorder with a bounded ring buffer (module docstring)."""
    enabled = True

    def __init__(self, capacity: int = 65536,
                 profiler_annotations: bool = False):
        assert capacity >= 1
        self._cap = capacity
        self._buf: list = [None] * capacity
        self._n = 0                       # total spans ever recorded
        self._t0 = time.perf_counter_ns()
        self._tids: dict[int, int] = {}
        self._tid_names: dict[int, str] = {}
        self._lock = threading.Lock()
        self._annotate = None
        if profiler_annotations:
            from torch.profiler import record_function
            self._annotate = record_function

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _record(self, name: str, t0_ns: int, t1_ns: int,
                args: dict) -> None:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
                self._tid_names[tid] = threading.current_thread().name
            self._buf[self._n % self._cap] = (
                name, (t0_ns - self._t0) // 1000,
                max(1, (t1_ns - t0_ns) // 1000), tid, args)
            self._n += 1

    # -- extraction ------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wraparound."""
        return max(0, self._n - self._cap)

    def events(self) -> list:
        """Retained spans oldest-first:
        ``(name, ts_us, dur_us, tid, args)`` tuples."""
        with self._lock:
            n, cap = self._n, self._cap
            if n <= cap:
                return [e for e in self._buf[:n]]
            start = n % cap
            return self._buf[start:] + self._buf[:start]

    def export(self) -> dict:
        """Chrome/Perfetto ``trace_event`` JSON object format."""
        events = []
        for tid, tname in sorted(self._tid_names.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid, "args": {"name": tname}})
        for name, ts, dur, tid, args in self.events():
            ev = {"name": name, "ph": "X", "cat": "pfo", "pid": 0,
                  "tid": tid, "ts": ts, "dur": dur}
            if args:
                ev["args"] = {k: v for k, v in args.items()}
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)
