"""Metrics primitives: counters, gauges, log-bucketed histograms.

Everything here is **host-side**: recording a metric never touches a
device tensor, so instrumentation can sit inside the one-readback-per-
round serving loop without adding device syncs.

Histograms are HDR-style log-linear: the value range ``[lo, hi)`` is
split into power-of-two octaves, each octave into ``sub`` equal linear
sub-buckets, so the relative quantization error is bounded by
``1/sub`` (default 32 -> ~3%).  The bucket array is allocated once at
construction and ``observe`` only increments ``counts[idx]`` — no
per-sample allocation or retained sample list in steady state.
Percentiles (p50/p90/p99/...) are extracted by a cumulative walk with
linear interpolation inside the landing bucket, clamped to the exact
observed min/max.

A :class:`MetricsRegistry` interns metrics by ``(name, labels)``.  A
*disabled* registry hands out shared null singletons whose methods are
no-ops, so instrumented code pays one attribute call per record and
one branch per span (see ``obs.trace``).
"""
from __future__ import annotations

import math
import threading


def render_name(name: str, labels: dict | None) -> str:
    """Canonical snapshot key: ``name{k=v,...}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


# ======================================================================
# null metrics (disabled registry)
# ======================================================================
class _NullMetric:
    """Shared do-nothing metric: every recording method is a no-op."""
    __slots__ = ()
    value = 0.0
    count = 0
    total = 0.0

    def inc(self, n: int = 1) -> None:
        pass

    def add(self, n) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass

    def percentile(self, q: float) -> float:
        return 0.0

    def summary(self) -> dict:
        return {}


NULL_METRIC = _NullMetric()


# ======================================================================
# real metrics
# ======================================================================
class Counter:
    """Monotonic count (requests, rounds, flag bits fired, ...)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def add(self, n) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value (queue depth, hit rate)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v

    def add(self, n) -> None:
        self.value += n


class Histogram:
    """Log-bucketed latency/size histogram (module docstring).

    ``lo``/``hi`` bound the resolvable range (values outside clamp to
    the edge buckets); ``sub`` linear sub-buckets per octave bound the
    relative error at ``1/sub``.
    """
    __slots__ = ("lo", "sub", "n_octaves", "counts", "count", "total",
                 "vmin", "vmax")

    DEFAULT_LO = 1e-6
    DEFAULT_HI = 1e9

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 sub: int = 32):
        assert lo > 0 and hi > lo and sub >= 1
        self.lo = float(lo)
        self.sub = int(sub)
        self.n_octaves = max(1, math.ceil(math.log2(hi / lo)))
        self.counts = [0] * (self.n_octaves * self.sub)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # -- recording (hot path: index math + one increment) ---------------
    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        r = v / self.lo
        if r < 1.0:
            idx = 0
        else:
            mant, exp = math.frexp(r)          # r = mant * 2^exp, mant in [.5,1)
            octave = exp - 1
            if octave >= self.n_octaves:
                idx = len(self.counts) - 1
            else:
                idx = octave * self.sub + int((mant * 2.0 - 1.0) * self.sub)
        self.counts[idx] += 1

    # -- extraction ------------------------------------------------------
    def _edges(self, idx: int) -> tuple[float, float]:
        octave, s = divmod(idx, self.sub)
        base = self.lo * (2.0 ** octave)
        return (base * (1.0 + s / self.sub),
                base * (1.0 + (s + 1) / self.sub))

    def percentile(self, q: float) -> float:
        """q in [0, 100]; linear interpolation inside the landing
        bucket, clamped to the exact observed min/max."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        cum = 0
        for idx, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c >= target:
                frac = (target - cum) / c
                a, b = self._edges(idx)
                v = a + frac * (b - a)
                return min(max(v, self.vmin), self.vmax)
            cum += c
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.percentile(50.0),
            "p90": self.percentile(90.0),
            "p99": self.percentile(99.0),
        }


# ======================================================================
# registry
# ======================================================================
class MetricsRegistry:
    """Interning registry of counters / gauges / histograms.

    ``enabled=False`` hands out the shared :data:`NULL_METRIC` — all
    recording collapses to no-op method calls and ``snapshot()``
    reports the registry as disabled.

    ``on_snapshot(key, fn)`` registers a keyed callback run at the top
    of every :meth:`snapshot` — the hook lazily mirrors host-side state
    (engine round counters, cold-tier cache stats, per-shard occupancy)
    into gauges *only when someone asks*, keeping the hot path free of
    double bookkeeping.  Re-registering a key replaces the callback, so
    re-binding an engine to a registry never duplicates hooks.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._metrics: dict[str, object] = {}
        self._kinds: dict[str, str] = {}
        self._callbacks: dict[str, object] = {}
        self._lock = threading.Lock()

    # -- interning -------------------------------------------------------
    def _get(self, kind: str, name: str, labels: dict | None, factory):
        if not self.enabled:
            return NULL_METRIC
        key = render_name(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = factory()
                self._kinds[key] = kind
            else:
                assert self._kinds[key] == kind, \
                    f"{key} already registered as a {self._kinds[key]}"
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, lo: float = Histogram.DEFAULT_LO,
                  hi: float = Histogram.DEFAULT_HI, sub: int = 32,
                  **labels) -> Histogram:
        return self._get("histogram", name, labels,
                         lambda: Histogram(lo, hi, sub))

    # -- snapshot --------------------------------------------------------
    def on_snapshot(self, key: str, fn) -> None:
        """Register (or replace) a lazy-mirror hook (class docstring)."""
        if self.enabled:
            self._callbacks[key] = fn

    def snapshot(self) -> dict:
        """Materialize every metric into plain dicts:
        ``{"enabled", "counters", "gauges", "histograms"}``."""
        if not self.enabled:
            return {"enabled": False, "counters": {}, "gauges": {},
                    "histograms": {}}
        for fn in list(self._callbacks.values()):
            fn()
        out = {"enabled": True, "counters": {}, "gauges": {},
               "histograms": {}}
        with self._lock:
            items = list(self._metrics.items())
        for key, m in items:
            kind = self._kinds[key]
            if kind == "counter":
                out["counters"][key] = m.value
            elif kind == "gauge":
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out
