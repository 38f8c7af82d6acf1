"""Typed metrics registry: Counter / Gauge / Histogram with fixed
log-spaced latency buckets.

One registry per process (``get_registry()``).  Serving workers publish
``registry.snapshot()`` on every heartbeat frame and again in their final
stats flush, so ``ServeCluster.stats()`` reports live numbers from every
process; ``bench_serving.py`` computes its p50/p95 fields through the same
``Histogram`` code path (``latency_percentiles``) instead of a private
``np.percentile`` call.

Pure stdlib (bisect + math): safe to import from anywhere, including the
engine hot path and the stdlib-only watchdog.

Copied from progen_tpu/observe/metrics.py (standard library only); the
port keeps its own copy because it imports nothing of the JAX package.  The
64 log-spaced bounds are unchanged, so snapshots from either package merge."""

import bisect
import math

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "labeled",
    "latency_buckets",
    "LATENCY_BUCKETS",
    "latency_percentiles",
    "merge_snapshots",
    "percentile_from_counts",
    "split_labeled",
]


def latency_buckets(lo=1e-4, hi=100.0, n=64):
    """Fixed log-spaced bucket upper bounds: ``n`` bounds from ``lo`` to
    ``hi`` seconds with constant ratio, so relative quantile error is
    bounded by one bucket ratio (~24% at the defaults) at every scale from
    100 us to 100 s."""
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * ratio ** i for i in range(n))


LATENCY_BUCKETS = latency_buckets()


def percentile_from_counts(bounds, counts, count, mn, mx, p):
    """The one quantile walk: cumulative counts with linear interpolation
    inside the target bucket, clamped to the observed min/max.  Shared by
    live :class:`Histogram` objects and merged fleet snapshots (which only
    have bucket counts, not raw values)."""
    if count == 0:
        return None
    rank = (p / 100.0) * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        nxt = cum + c
        if nxt >= rank:
            lo = bounds[i - 1] if i > 0 else min(mn, 0.0)
            hi = bounds[i] if i < len(bounds) else mx
            frac = (rank - cum) / c
            est = lo + (hi - lo) * frac
            return min(max(est, mn), mx)
        cum = nxt
    return mx


class Counter:
    """Monotonic count."""

    __slots__ = ("name", "_value")

    def __init__(self, name):
        self.name = name
        self._value = 0

    def inc(self, n=1):
        self._value += n

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-set value (e.g. queue depth, tokens/sec)."""

    __slots__ = ("name", "_value")

    def __init__(self, name):
        self.name = name
        self._value = 0.0

    def set(self, v):
        self._value = v

    @property
    def value(self):
        return self._value

    def snapshot(self):
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram with quantile estimation.

    ``observe`` is a bisect into the (log-spaced) bounds; ``percentile``
    walks the cumulative counts and linearly interpolates inside the
    target bucket, clamped to the observed min/max so exact extremes are
    never overshot."""

    __slots__ = ("name", "bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, name, buckets=LATENCY_BUCKETS):
        self.name = name
        self.bounds = tuple(buckets)
        self.reset()

    def reset(self):
        # one overflow bucket past the last bound
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v):
        # callers pass host floats by contract (the zone enforces it)
        v = float(v)  # graftcheck: disable=host-sync
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def percentile(self, p):
        """Estimate the p-th percentile (p in [0, 100])."""
        return percentile_from_counts(self.bounds, self.counts, self.count,
                                      self.min, self.max, p)

    def snapshot(self):
        snap = {"type": "histogram", "count": self.count,
                "sum": round(self.sum, 6)}
        if self.count:
            snap["min"] = self.min
            snap["max"] = self.max
            snap["p50"] = self.percentile(50)
            snap["p95"] = self.percentile(95)
            snap["p99"] = self.percentile(99)
            # sparse bucket counts ([index, count] pairs, JSON-safe) so
            # fleet merges and Prometheus exposition can reconstruct the
            # full distribution from a heartbeat snapshot
            snap["buckets"] = [[i, c] for i, c in enumerate(self.counts)
                               if c]
        if self.bounds != LATENCY_BUCKETS:
            snap["bounds"] = list(self.bounds)
        return snap


class MetricsRegistry:
    """Get-or-create registry keyed by metric name.

    Re-requesting a name returns the same object; re-requesting it as a
    different type is a bug and raises."""

    def __init__(self):
        self._metrics = {}

    def _get(self, cls, name, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name):
        return self._get(Counter, name)

    def gauge(self, name):
        return self._get(Gauge, name)

    def histogram(self, name, buckets=LATENCY_BUCKETS):
        return self._get(Histogram, name, buckets)

    def snapshot(self):
        return {name: m.snapshot() for name, m in
                sorted(self._metrics.items())}

    def clear(self):
        self._metrics.clear()


_REGISTRY = MetricsRegistry()


def get_registry():
    """The process-wide metrics registry."""
    return _REGISTRY


def labeled(name, **labels):
    """Embed Prometheus-style labels in a metric name:
    ``labeled("cluster.up", role="prefill", idx=0)`` ->
    ``cluster.up{idx="0",role="prefill"}``.  Labels are sorted so the same
    label set always produces the same registry key; values are escaped at
    construction so :func:`split_labeled` and the exposition renderer can
    pass them through verbatim."""
    inner = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\")
                         .replace('"', r'\"').replace("\n", r"\n"))
        for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}" if inner else name


def split_labeled(name):
    """``name{a="b"}`` -> ``("name", 'a="b"')``; unlabeled -> ``(name, "")``."""
    i = name.find("{")
    if i < 0:
        return name, ""
    return name[:i], name[i + 1:].rstrip("}")


def snapshot_bounds(snap):
    """Bucket upper bounds a histogram snapshot was taken against (custom
    bounds ride the snapshot; the default set is implied)."""
    return tuple(snap.get("bounds", LATENCY_BUCKETS))


def _merge_histogram(out, snap):
    bounds = snapshot_bounds(snap)
    if snapshot_bounds(out) != bounds:
        raise ValueError(
            f"cannot merge histogram snapshots with different bounds "
            f"({len(snapshot_bounds(out))} vs {len(bounds)} buckets)")
    counts = [0] * (len(bounds) + 1)
    for i, c in out.get("buckets", ()):
        counts[i] += c
    for i, c in snap.get("buckets", ()):
        counts[i] += c
    out["count"] = out.get("count", 0) + snap.get("count", 0)
    out["sum"] = round(out.get("sum", 0.0) + snap.get("sum", 0.0), 6)
    if out["count"]:
        out["min"] = min(out.get("min", math.inf),
                         snap.get("min", math.inf))
        out["max"] = max(out.get("max", -math.inf),
                         snap.get("max", -math.inf))
        out["buckets"] = [[i, c] for i, c in enumerate(counts) if c]
        for p, key in ((50, "p50"), (95, "p95"), (99, "p99")):
            out[key] = percentile_from_counts(
                bounds, counts, out["count"], out["min"], out["max"], p)
    return out


def merge_snapshots(snaps):
    """Merge registry snapshots from several processes into one fleet
    view: counters and gauges sum (fleet totals — per-process values that
    must stay distinct use :func:`labeled` names, which never collide),
    histograms merge bucket-for-bucket with percentiles recomputed from
    the merged counts.  Type conflicts across processes raise."""
    out = {}
    for snap in snaps:
        for name, m in snap.items():
            cur = out.get(name)
            if cur is None:
                out[name] = dict(m)
                continue
            if cur.get("type") != m.get("type"):
                raise ValueError(
                    f"metric {name!r} is {cur.get('type')} in one process "
                    f"and {m.get('type')} in another")
            if m.get("type") == "histogram":
                _merge_histogram(cur, m)
            else:
                cur["value"] = cur.get("value", 0) + m.get("value", 0)
    return {name: out[name] for name in sorted(out)}


def latency_percentiles(values, ps=(50.0, 95.0), name="bench.latency_s"):
    """Percentiles of ``values`` via the shared registry histogram — the
    single latency-quantile code path for benches and the cluster.  Resets
    the named histogram first so each call rates exactly its inputs."""
    h = get_registry().histogram(name)
    h.reset()
    for v in values:
        h.observe(v)
    return tuple(h.percentile(p) for p in ps)
