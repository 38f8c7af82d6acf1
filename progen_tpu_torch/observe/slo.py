"""Declarative SLOs evaluated as error-budget burn rates over registry
histograms — ONE code path for offline bench math and the live fleet.

An :class:`SLOSpec` states an objective ("95% of requests complete
within 2s", "99% of admitted requests are served, not shed").  Against a
registry snapshot it yields the achieved good fraction and the **burn
rate**: ``(1 - frac_good) / (1 - target)`` — the rate the error budget
is being spent at (1.0 = exactly on target, >1 = burning faster than
the objective allows, the standard SRE multi-window alert signal).

Latency objectives are evaluated from histogram bucket counts (the same
sparse buckets that ride heartbeat frames and merge fleet-wide), so the
live driver, a worker's own /statusz, and ``bench_serving.py --slo``
all agree bucket-for-bucket.  Ratio objectives divide two counters
(goodput vs shed).

:class:`BurnRateTracker` adds the *multi-window* part: it keeps a ring
of timed cumulative snapshots and evaluates each spec over trailing
windows by diffing cumulative counts (monotone, so diffs are exact),
publishing ``slo.<name>.burn_<w>s`` gauges for /metricsz and a JSON
block for /statusz.  Pure stdlib; never touches a device value.

Copied from progen_tpu/observe/slo.py (standard library only); the port
keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from collections import deque

from progen_tpu_torch.observe import metrics as _metrics

__all__ = [
    "SLOSpec",
    "BurnRateTracker",
    "burn_rate",
    "evaluate",
    "frac_within",
    "frac_within_values",
]


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One objective.

    ``kind="latency"``: ``frac_good`` is the fraction of ``metric``'s
    (histogram) observations at or under ``threshold_s``.
    ``kind="ratio"``: ``frac_good = good / (good + bad)`` over the two
    named counters (e.g. served vs shed — a goodput objective).
    ``target`` is the objective fraction in (0, 1)."""

    name: str
    target: float
    kind: str = "latency"
    metric: str = "cluster.latency_s"
    threshold_s: float = 1.0
    good: str = "cluster.completions_ok"
    bad: str = "cluster.completions_shed"

    def __post_init__(self):
        if self.kind not in ("latency", "ratio"):
            raise ValueError(f"kind {self.kind!r}: want 'latency' or 'ratio'")
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {self.target}")


def _full_counts(snap, bounds):
    counts = [0] * (len(bounds) + 1)
    for i, c in snap.get("buckets", ()):
        counts[i] += c
    return counts


def frac_within(snap, threshold_s: float) -> float | None:
    """Fraction of a histogram snapshot's observations <= ``threshold_s``
    — the cumulative-bucket walk with linear interpolation inside the
    straddling bucket (the same estimate family as ``percentile``),
    clamped by the observed min/max when the snapshot carries them.
    ``None`` when the histogram is empty."""
    count = snap.get("count", 0)
    if not count:
        return None
    mn = snap.get("min")
    mx = snap.get("max")
    if mx is not None and threshold_s >= mx:
        return 1.0
    if mn is not None and threshold_s < mn:
        return 0.0
    bounds = _metrics.snapshot_bounds(snap)
    counts = _full_counts(snap, bounds)
    j = bisect.bisect_left(bounds, threshold_s)
    within = sum(counts[:j])
    if j < len(counts) and counts[j]:
        lo = bounds[j - 1] if j > 0 else min(
            mn if mn is not None else 0.0, 0.0)
        hi = bounds[j] if j < len(bounds) else (
            mx if mx is not None else threshold_s)
        if hi > lo:
            within += counts[j] * min(1.0, (threshold_s - lo) / (hi - lo))
        else:
            within += counts[j]
    return min(1.0, within / count)


def frac_within_values(values, threshold_s: float,
                       name: str = "slo.eval_latency_s") -> float:
    """Offline form: rate raw latencies through a registry histogram and
    evaluate THAT — so a bench's ``within_slo_frac`` goes through the
    identical bucket math as the live fleet's burn rates."""
    h = _metrics.get_registry().histogram(name)
    h.reset()
    for v in values:
        h.observe(v)
    out = frac_within(h.snapshot(), threshold_s)
    return 1.0 if out is None else out


def burn_rate(frac_good: float | None, target: float) -> float | None:
    """Error-budget burn: ``(1 - frac_good) / (1 - target)``.  None in =
    None out (no data is not a burning budget)."""
    if frac_good is None:
        return None
    bad = max(0.0, 1.0 - frac_good)
    budget = 1.0 - target
    if budget <= 0.0:
        return math.inf if bad > 0 else 0.0
    return bad / budget


def evaluate(spec: SLOSpec, snapshot: dict) -> dict:
    """One spec against one registry snapshot -> JSON-safe result."""
    if spec.kind == "latency":
        snap = snapshot.get(spec.metric, {})
        frac = frac_within(snap, spec.threshold_s)
        count = snap.get("count", 0)
    else:
        good = snapshot.get(spec.good, {}).get("value", 0)
        bad = snapshot.get(spec.bad, {}).get("value", 0)
        count = good + bad
        frac = (good / count) if count else None
    rate = burn_rate(frac, spec.target)
    return {
        "name": spec.name,
        "kind": spec.kind,
        "target": spec.target,
        "count": count,
        "frac_good": None if frac is None else round(frac, 6),
        "burn_rate": None if rate is None else (
            round(rate, 4) if rate != math.inf else "inf"),
    }


def _diff_metric(new: dict, old: dict | None) -> dict:
    """Windowed view of a cumulative metric: new minus old.  Counts are
    monotone so the diff is exact; a window diff has no meaningful
    min/max (raw values are gone), so those fields are dropped and
    ``frac_within`` falls back to pure bucket math."""
    if old is None:
        return new
    if new.get("type") == "counter":
        return {"type": "counter",
                "value": max(0, new.get("value", 0) - old.get("value", 0))}
    if new.get("type") != "histogram":
        return new
    bounds = _metrics.snapshot_bounds(new)
    counts = _full_counts(new, bounds)
    for i, c in old.get("buckets", ()):
        counts[i] -= c
    counts = [max(0, c) for c in counts]
    out = {"type": "histogram",
           "count": max(0, new.get("count", 0) - old.get("count", 0)),
           "sum": new.get("sum", 0.0) - old.get("sum", 0.0),
           "buckets": [[i, c] for i, c in enumerate(counts) if c]}
    if "bounds" in new:
        out["bounds"] = new["bounds"]
    return out


class BurnRateTracker:
    """Multi-window burn rates over a ring of timed registry snapshots.

    Call :meth:`sample` with a monotonic ``now`` and the current
    (cumulative) snapshot — on the driver that is the fleet-merged view,
    in a worker its own registry.  :meth:`evaluate` computes every spec
    over every trailing window by diffing the newest sample against the
    oldest sample inside the window, publishes ``slo.*`` gauges into the
    registry, and returns the JSON block /statusz embeds."""

    def __init__(self, specs, *, windows=(60.0, 300.0, 900.0),
                 registry=None):
        self.specs = tuple(specs)
        self.windows = tuple(sorted(windows))
        self._registry = registry
        self._samples: deque = deque()

    def sample(self, now: float, snapshot: dict) -> None:
        self._samples.append((now, snapshot))
        horizon = now - (self.windows[-1] if self.windows else 0.0) - 1.0
        while len(self._samples) > 2 and self._samples[1][0] < horizon:
            self._samples.popleft()

    def evaluate(self, now: float | None = None) -> list[dict]:
        if not self._samples:
            return [evaluate(s, {}) | {"windows": {}} for s in self.specs]
        t_new, newest = self._samples[-1]
        if now is None:
            now = t_new
        registry = self._registry or _metrics.get_registry()
        out = []
        for spec in self.specs:
            res = evaluate(spec, newest)  # lifetime view
            res["windows"] = {}
            for w in self.windows:
                old = None
                t_old = None
                for t, snap in self._samples:
                    if t >= now - w:
                        break
                    old, t_old = snap, t
                names = ([spec.metric] if spec.kind == "latency"
                         else [spec.good, spec.bad])
                windowed = {n: _diff_metric(newest.get(n, {}),
                                            None if old is None
                                            else old.get(n))
                            for n in names}
                wres = evaluate(spec, windowed)
                span = round(now - (t_old if t_old is not None
                                    else self._samples[0][0]), 3)
                res["windows"][f"{w:g}s"] = {
                    "span_s": span,
                    "count": wres["count"],
                    "frac_good": wres["frac_good"],
                    "burn_rate": wres["burn_rate"],
                }
                rate = wres["burn_rate"]
                g = registry.gauge(f"slo.{spec.name}.burn_{w:g}s")
                g.set(-1.0 if rate is None
                      else (math.inf if rate == "inf" else rate))
            frac = res["frac_good"]
            registry.gauge(f"slo.{spec.name}.frac_good").set(
                -1.0 if frac is None else frac)
            out.append(res)
        return out
