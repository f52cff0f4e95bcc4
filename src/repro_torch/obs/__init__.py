"""Observability substrate: metrics registry + phase tracing.

:class:`Obs` bundles the two halves behind one handle that threads
through the engine stack (``PFOIndex`` -> ``LocalBackend`` ->
``StreamEngine``, ``DistBackend`` -> ``DistStreamEngine``,
``ServingEngine``):

* **metrics** — a :class:`~repro_torch.obs.metrics.MetricsRegistry` of
  counters / gauges / HDR-style log-bucketed histograms (p50/p90/p99
  extraction, no per-sample allocation).  On by default: recording is
  a couple of host arithmetic ops.
* **tracing** — :class:`~repro_torch.obs.trace.Tracer` phase spans
  (``obs.span("dispatch")``...) into a bounded ring buffer, exportable
  as Chrome/Perfetto ``trace_event`` JSON.  Off by default; when off a
  span costs ONE branch returning a shared no-op context manager.

The hard invariant: recording a metric or span never touches a device
tensor — tracing adds ZERO device readbacks to a steady-state round.

This is the PyTorch port's own copy of the JAX package's ``obs``
(same metric names and trace-event schema); the only difference is the
profiler bridge, which enters ``torch.profiler.record_function``.
"""
from __future__ import annotations

import warnings

from . import report
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      NULL_METRIC, render_name)
from .trace import NULL_SPAN, NULL_TRACER, NullTracer, Tracer


class Obs:
    """One observability handle: registry + tracer (module docstring)."""

    def __init__(self, metrics: bool = True, trace: bool = False,
                 trace_capacity: int = 65536,
                 profiler_annotations: bool = False):
        self.registry = MetricsRegistry(enabled=metrics)
        self.tracer = Tracer(trace_capacity, profiler_annotations) if trace \
            else NULL_TRACER
        if metrics and trace:
            # lazy mirror: ring-wraparound loss surfaces as a gauge so
            # a truncated trace is never silently misread
            self.on_snapshot("trace", lambda: self.gauge(
                "obs.trace_dropped").set(self.tracer.dropped))

    # -- capability flags (hot-path guards) -----------------------------
    @property
    def enabled(self) -> bool:
        """True when the metrics registry records."""
        return self.registry.enabled

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    @property
    def active(self) -> bool:
        """Anything on at all — instrumented code skips even its
        ``time.perf_counter()`` calls when this is False."""
        return self.registry.enabled or self.tracer.enabled

    # -- delegation ------------------------------------------------------
    def span(self, name: str, **args):
        """Phase span context manager; the disabled path is one branch
        returning the shared no-op span."""
        tr = self.tracer
        if not tr.enabled:
            return NULL_SPAN
        return tr.span(name, **args)

    def counter(self, name: str, **labels):
        return self.registry.counter(name, **labels)

    def gauge(self, name: str, **labels):
        return self.registry.gauge(name, **labels)

    def histogram(self, name: str, lo: float = Histogram.DEFAULT_LO,
                  hi: float = Histogram.DEFAULT_HI, sub: int = 32,
                  **labels):
        return self.registry.histogram(name, lo, hi, sub, **labels)

    def on_snapshot(self, key: str, fn) -> None:
        self.registry.on_snapshot(key, fn)

    def snapshot(self) -> dict:
        """Registry snapshot plus the ``derived`` rate section
        (:func:`repro_torch.obs.report.with_derived`)."""
        return report.with_derived(self.registry.snapshot())

    def format(self, title: str = "metrics") -> str:
        return report.format_table(self.snapshot(), title=title)

    def save_trace(self, path: str) -> None:
        dropped = self.tracer.dropped
        if dropped:
            warnings.warn(
                f"trace ring overwrote {dropped} span(s); the saved "
                f"trace holds only the most recent "
                f"{self.tracer._cap} — raise trace_capacity",
                RuntimeWarning, stacklevel=2)
        self.tracer.save(path)


#: shared fully-disabled handle — safe default for library code
NULL_OBS = Obs(metrics=False, trace=False)

__all__ = ["Obs", "NULL_OBS", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "Tracer", "NullTracer", "NULL_TRACER",
           "NULL_SPAN", "NULL_METRIC", "render_name", "report"]
