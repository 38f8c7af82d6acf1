"""Cross-process request tracing: monotonic-clock spans with per-request
trace ids, a bounded ring buffer per process, and a zero-cost no-op path
when disabled.

A request's life spans three OS processes (router -> prefill worker ->
decode replica).  Each process records spans into its own bounded ring
(`Tracer`), stamped with ``time.perf_counter()`` instants.  Workers echo
their own clock in hello/heartbeat frames so the router can estimate a
per-process clock offset (router_now - worker_clock, minimised over
samples); ``merge_dumps`` applies those offsets to place every process's
spans on the router's timeline, and ``chrome_trace`` emits a single
Perfetto / chrome://tracing ``trace_event`` JSON.

Trace ids are the request uids: a span either carries ``trace=<uid>``
(per-request work) or ``uids=[...]`` in its args (batch-level work such as
a prefill round).  ``spans_for`` finds both.

Disabled (the default) costs one attribute check per call: ``span()``
returns a shared no-op context manager and ``add()``/``event()`` return
before allocating the record.  This file is deliberately pure stdlib:
``resilience/watchdog.py`` dumps the ring on a trip and must not pull in
torch to do it.

Copied from progen_tpu/observe/trace.py (standard library only); the port
keeps its own copy because it imports nothing of the JAX package.  Dumps of
either package merge into one trace.
"""

import json
import os
import time
from collections import deque

__all__ = [
    "Tracer",
    "get_tracer",
    "configure_tracing",
    "trace_dump_path",
    "load_dump",
    "merge_dumps",
    "chrome_trace",
    "write_chrome_trace",
    "merge_trace_dir",
    "spans_for",
]

DEFAULT_CAPACITY = 4096


class _NoopSpan:
    """Shared do-nothing context manager returned by ``Tracer.span`` when
    tracing is disabled, so the hot path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """Live timing context: stamps perf_counter on enter, records on exit."""

    __slots__ = ("_tracer", "_name", "_trace", "_args", "_t0")

    def __init__(self, tracer, name, trace, args):
        self._tracer = tracer
        self._name = name
        self._trace = trace
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self._tracer.add(self._name, self._t0, dur, trace=self._trace,
                         **self._args)
        return False


class Tracer:
    """Per-process span recorder: a bounded ring of completed spans.

    Spans are plain dicts ``{"name", "ts", "dur", "trace"?, "args"?}`` with
    ``ts``/``dur`` in perf_counter seconds.  The ring is a
    ``deque(maxlen=capacity)`` so a long-lived server can trace forever and
    keep only the recent window — exactly what a watchdog trip wants."""

    def __init__(self, *, enabled=False, capacity=DEFAULT_CAPACITY,
                 process="main"):
        self.enabled = enabled
        self.capacity = capacity
        self.process = process
        self._ring = deque(maxlen=capacity)
        self._meta = {}

    # -- recording ---------------------------------------------------------

    def span(self, name, trace=None, **args):
        """Context manager timing a block; no-op singleton when disabled."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, trace, args)

    def add(self, name, t0, dur, trace=None, **args):
        """Record an already-timed span (t0 from ``time.perf_counter()``).

        This is the form used at the engine's existing stage-timing sites:
        the ``t0 = time.perf_counter()`` deltas that feed ``stage_seconds``
        become spans for free."""
        if not self.enabled:
            return
        rec = {"name": name, "ts": t0, "dur": dur}
        if trace is not None:
            rec["trace"] = trace
        if args:
            rec["args"] = args
        self._ring.append(rec)

    def event(self, name, trace=None, **args):
        """Instant (zero-duration) marker."""
        if not self.enabled:
            return
        self.add(name, time.perf_counter(), 0.0, trace=trace, **args)

    def set_meta(self, **kw):
        """Attach metadata (e.g. the router's per-worker clock offsets) to
        this process's dump."""
        self._meta.update(kw)

    # -- inspection / export ----------------------------------------------

    def ring(self):
        return list(self._ring)

    def clear(self):
        self._ring.clear()
        self._meta.clear()

    def dump_obj(self):
        return {
            "process": self.process,
            "pid": os.getpid(),
            "clock": time.perf_counter(),
            "wall": time.time(),
            "meta": dict(self._meta),
            "spans": list(self._ring),
        }

    def dump(self, path):
        """Write this process's raw span dump (NOT yet a Chrome trace —
        ``merge_dumps``/``chrome_trace`` turn a set of these into one)."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.dump_obj(), fh)
        os.replace(tmp, path)
        return path


_TRACER = Tracer()


def get_tracer():
    """The process-wide tracer.  Mutated in place by ``configure_tracing``
    so objects that stashed the reference at construction see the flip."""
    return _TRACER


def configure_tracing(*, enabled=True, capacity=None, process=None):
    """Enable/disable the process-wide tracer in place."""
    if capacity is not None and capacity != _TRACER.capacity:
        _TRACER.capacity = capacity
        _TRACER._ring = deque(_TRACER._ring, maxlen=capacity)
    if process is not None:
        _TRACER.process = process
    _TRACER.enabled = enabled
    return _TRACER


def trace_dump_path(trace_dir, process):
    """Canonical per-process dump filename inside a trace directory."""
    return os.path.join(trace_dir, f"trace_{process.replace(':', '_')}.json")


# -- merge / export --------------------------------------------------------


def load_dump(path):
    with open(path) as fh:
        return json.load(fh)


def merge_dumps(dumps):
    """Offset-correct and time-sort spans from several process dumps.

    Any dump may carry ``meta.offsets`` mapping process name -> seconds to
    ADD to that process's timestamps (the router records these from worker
    hello/heartbeat clock echoes).  Returns a flat span list on one clock,
    each span annotated with its source ``process``/``pid``."""
    offsets = {}
    for d in dumps:
        offsets.update(d.get("meta", {}).get("offsets", {}))
    merged = []
    for d in dumps:
        proc = d.get("process", "main")
        off = float(offsets.get(proc, 0.0))
        pid = d.get("pid", 0)
        for s in d.get("spans", ()):
            s = dict(s)
            s["ts"] = float(s["ts"]) + off
            s["process"] = proc
            s["pid"] = pid
            merged.append(s)
    merged.sort(key=lambda s: s["ts"])
    return merged


def chrome_trace(dumps):
    """Build a Chrome/Perfetto ``trace_event`` JSON object from raw dumps:
    complete ("X") events in microseconds plus process_name metadata."""
    spans = merge_dumps(dumps)
    pids = {}
    events = []
    for d in dumps:
        proc = d.get("process", "main")
        if proc not in pids:
            pids[proc] = d.get("pid") or (len(pids) + 1)
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[proc], "tid": 0,
                           "args": {"name": proc}})
    for s in spans:
        ev = {"name": s["name"], "ph": "X", "cat": "serve",
              "ts": round(s["ts"] * 1e6, 3),
              "dur": round(s["dur"] * 1e6, 3),
              "pid": pids.get(s["process"], 0), "tid": 0}
        args = dict(s.get("args", ()))
        if "trace" in s:
            args["trace"] = s["trace"]
        if args:
            ev["args"] = args
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(out_path, dumps):
    tmp = f"{out_path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(chrome_trace(dumps), fh)
    os.replace(tmp, out_path)
    return out_path


def merge_trace_dir(trace_dir, out_path=None):
    """Merge every ``trace_*.json`` raw dump in ``trace_dir`` into one
    Perfetto-loadable ``trace.json`` (returns its path, or None if the
    directory holds no dumps)."""
    names = sorted(f for f in os.listdir(trace_dir)
                   if f.startswith("trace_") and f.endswith(".json"))
    if not names:
        return None
    dumps = [load_dump(os.path.join(trace_dir, f)) for f in names]
    out_path = out_path or os.path.join(trace_dir, "trace.json")
    return write_chrome_trace(out_path, dumps)


def spans_for(spans, uid):
    """Spans belonging to one request: tagged ``trace=uid`` directly, or a
    batch span whose args list the uid."""
    out = []
    for s in spans:
        if s.get("trace") == uid:
            out.append(s)
            continue
        uids = s.get("args", {}).get("uids")
        if uids and uid in uids:
            out.append(s)
    return out
