"""Deadline classes and SLO accounting for the serving engines.

PFO's claim is interactive latency under mixed online query/update
traffic; this module turns the per-request accounting (``req.e2e_ms``
and friends, recorded by ``serving.stream.StreamEngine``) into an SLO
view a serving front-end can alert on:

* **deadline classes** — a client opened with
  ``StreamEngine.client(deadline_ms=...)`` belongs to the deadline
  class of that bound.  Classes are keyed by the bound itself (two
  clients with the same ``deadline_ms`` share counters), so the metric
  cardinality is the number of *distinct SLAs*, not clients.
* **violation counters** — every completed request from a deadline
  client increments ``slo.requests{deadline_ms=X}``; those whose
  end-to-end latency exceeded the bound also increment
  ``slo.violations{deadline_ms=X}``.
* **burn-rate gauges** — mirrored lazily at snapshot time:
  ``slo.burn_rate{deadline_ms=X}`` is the observed violation rate
  divided by the class's error budget (``1 - target``, default target
  0.99).  Burn rate 1.0 means the budget is being consumed exactly at
  the allowed pace; 100.0 means every request violates a 99% target.

Everything here is host-side arithmetic on host wall-clock timestamps
— recording never touches a device tensor, preserving the engine's
one-readback-per-round invariant (asserted in
``tests/test_torch_stream.py``).

The flush-policy half, :func:`edf_order`, is the deadline-aware bucket
prioritizer: a ``window``-mode flush may freely reorder its *query*
half (every query in the window probes the same post-update state —
module docstring of ``serving.stream``), so the engine sorts queries
earliest-absolute-deadline-first before micro-batching.  Deadline-
critical requests therefore form the window's first buckets and
dispatch before best-effort traffic; the update half is never
reordered (the ordering contract forbids it), and ``strict`` mode
bypasses the policy entirely.
"""
from __future__ import annotations

import math

from ..core.dispatch import ticket_client

#: default SLO target: this fraction of a class's requests must meet
#: the deadline; the error budget is the remainder.
DEFAULT_TARGET = 0.99


class SLOTracker:
    """Per-deadline-class accounting into an ``Obs`` handle.

    Classes materialize lazily on first :meth:`observe` — the counters
    intern in the registry by ``deadline_ms`` label, so re-binding an
    engine to the same registry resumes the same counters.
    """

    def __init__(self, obs, target: float = DEFAULT_TARGET):
        assert 0.0 < target < 1.0
        self.obs = obs
        self.target = target
        self._classes: dict[float, tuple] = {}
        obs.on_snapshot("slo", self._mirror)

    def observe(self, deadline_ms: float, e2e_ms: float) -> None:
        """Record one completed request of the ``deadline_ms`` class."""
        cls = self._classes.get(deadline_ms)
        if cls is None:
            cls = self._classes[deadline_ms] = (
                self.obs.counter("slo.requests", deadline_ms=deadline_ms),
                self.obs.counter("slo.violations", deadline_ms=deadline_ms),
            )
        requests, violations = cls
        requests.inc()
        if e2e_ms > deadline_ms:
            violations.inc()

    def violation_rate(self, deadline_ms: float) -> float:
        cls = self._classes.get(deadline_ms)
        if cls is None or not cls[0].value:
            return 0.0
        return cls[1].value / cls[0].value

    def burn_rate(self, deadline_ms: float) -> float:
        """Observed violation rate over the class's error budget."""
        return self.violation_rate(deadline_ms) / (1.0 - self.target)

    def _mirror(self) -> None:
        """Lazy snapshot hook: rates -> gauges, only when asked."""
        g = self.obs.gauge
        for dl in self._classes:
            g("slo.violation_rate", deadline_ms=dl).set(
                round(self.violation_rate(dl), 6))
            g("slo.burn_rate", deadline_ms=dl).set(
                round(self.burn_rate(dl), 4))


def edf_order(queue: list, deadlines: dict) -> list:
    """Earliest-deadline-first stable ordering of a window's query half.

    ``queue`` holds the engine's ``(ticket, kind, payload, t_enq)``
    request tuples; ``deadlines`` maps client id -> deadline_ms.  A
    request's absolute deadline is its enqueue wall-clock plus its
    client's bound; requests from clients without a deadline sort last,
    keeping their relative submission order (the sort is stable).
    """
    if not deadlines:
        return queue

    def _deadline(req) -> float:
        dl = deadlines.get(ticket_client(req[0]))
        return req[3] + dl / 1e3 if dl is not None else math.inf

    return sorted(queue, key=_deadline)
