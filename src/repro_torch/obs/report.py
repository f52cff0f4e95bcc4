"""Snapshot post-processing: derived rates + human-readable tables.

:func:`per_round` is THE readbacks-per-round derivation — both
``StreamEngine.stats()`` (single-chip and distributed, which share the
method) and :meth:`repro_torch.obs.Obs.snapshot` call it, so the two views
cannot drift on the zero-rounds guard (a flush with ``update_rounds ==
0`` reports 0.0, never a ZeroDivisionError or a stale carried value).
"""
from __future__ import annotations


def per_round(readbacks: int, rounds: int, digits: int = 4) -> float:
    """Readbacks-per-round with the zero-rounds guard.  Steady state
    this is exactly 1.0; warmup/capacity-growth flag probes can push it
    epsilon above (assert on deltas); no update rounds -> 0.0."""
    if not rounds:
        return 0.0
    return round(readbacks / rounds, digits)


def with_derived(snap: dict) -> dict:
    """Attach a ``derived`` section to a registry snapshot: rates that
    combine two metrics and therefore must be computed in one place."""
    snap = dict(snap)
    derived: dict = {}
    g = snap.get("gauges", {})
    c = snap.get("counters", {})

    def pick(key):
        return g.get(key, c.get(key))

    readbacks = pick("index.readbacks")
    rounds = pick("stream.rounds")
    if readbacks is not None and rounds is not None:
        derived["readbacks_per_round"] = per_round(int(readbacks),
                                                   int(rounds))
    flushes = pick("stream.flushes")
    reqs = pick("stream.requests")
    if reqs is not None and flushes:
        derived["requests_per_flush"] = round(int(reqs) / int(flushes), 4)
    snap["derived"] = derived
    return snap


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def format_table(snap: dict, title: str = "metrics") -> str:
    """Render a snapshot (from :meth:`Obs.snapshot`) as an aligned
    plain-text table: counters + gauges first, then one row per
    histogram with count/mean/p50/p90/p99, then derived rates."""
    if not snap.get("enabled", True):
        return f"-- {title}: registry disabled --"
    lines = [f"-- {title} --"]
    scalars = [("counter", k, v) for k, v in
               sorted(snap.get("counters", {}).items())]
    scalars += [("gauge", k, v) for k, v in
                sorted(snap.get("gauges", {}).items())]
    scalars += [("derived", k, v) for k, v in
                sorted(snap.get("derived", {}).items())]
    if scalars:
        w = max(len(k) for _, k, _ in scalars)
        for kind, k, v in scalars:
            lines.append(f"  {k:<{w}}  {_fmt(v):>12}  [{kind}]")
    hists = sorted(snap.get("histograms", {}).items())
    if hists:
        w = max(len(k) for k, _ in hists)
        lines.append(f"  {'histogram':<{w}}  {'count':>8} {'mean':>10} "
                     f"{'p50':>10} {'p90':>10} {'p99':>10}")
        for k, s in hists:
            if not s.get("count"):
                lines.append(f"  {k:<{w}}  {0:>8}")
                continue
            lines.append(
                f"  {k:<{w}}  {s['count']:>8} {_fmt(s['mean']):>10} "
                f"{_fmt(s['p50']):>10} {_fmt(s['p90']):>10} "
                f"{_fmt(s['p99']):>10}")
    return "\n".join(lines)
