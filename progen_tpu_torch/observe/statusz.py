"""Live per-process introspection plane: /healthz /statusz /metricsz
/tracez /flightz on a loopback port.

Every serving/training process (router, prefill worker, decode replica,
trainer) can run one :class:`StatuszServer` — a stdlib ``http.server``
on ``127.0.0.1``, served from a daemon thread, constructed ONLY when the
operator asks for it (``--statusz``), so the disabled path costs
nothing: no socket, no thread, no import-time work beyond this module.

The hard invariant is zero perturbation: an enabled run is
token-identical to a disabled one.  That holds because every handler
reads host-side bookkeeping only — engine ``status()`` (host dicts),
registry snapshots (host floats), the tracer ring, flight-recorder
events.  Nothing here may ever fetch from the device or touch a device
tensor (``ServingEngine.spec_counters`` is deliberately NOT surfaced: it
costs a device fetch).  Handlers run on the HTTP thread concurrently
with the serving loop; they read via provider callables and a racy read
of a mutating dict is answered with a 503 the client retries, never a
crash and never a lock the hot path could contend on.

Endpoints:

- ``/healthz``  — JSON liveness: role/index plus whatever the host
  process's ``health`` provider reports (heartbeat ages, credit window,
  restart budget, build phase).
- ``/statusz``  — JSON deep state from the ``status`` provider (engine
  slots/queues/in-flight uids/robustness counters/stage seconds; on the
  router: the fleet-wide view with merged histograms).
- ``/metricsz`` — Prometheus text exposition (counters, gauges,
  cumulative histogram buckets ending in ``+Inf``) rendered from the
  ``metrics`` provider's registry snapshot.
- ``/tracez``   — recent span ring (JSON), ``/flightz`` — flight
  recorder events (JSON).

Copied from progen_tpu/observe/statusz.py (standard library only, on the
port's copy of the metrics registry); the port keeps its own copy because
it imports nothing of the JAX package.  The JAX package's ``/controlz``
(its elastic control plane's journal) is left out with that control plane.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from progen_tpu_torch.observe import metrics as _metrics

__all__ = ["StatuszServer", "render_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Metric name -> valid Prometheus name (dots and dashes become
    underscores; a leading digit gets a prefix)."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _sample(base: str, labels: str, extra: str, value) -> str:
    inner = ",".join(p for p in (labels, extra) if p)
    lab = "{" + inner + "}" if inner else ""
    return f"{base}{lab} {_fmt(value)}"


def render_prometheus(snapshot: dict) -> str:
    """Registry snapshot (possibly fleet-merged) -> Prometheus text
    exposition.  Labeled registry names (``metrics.labeled``) become real
    label sets; histograms emit cumulative ``_bucket`` series ending in
    the ``+Inf`` terminal bucket plus ``_sum``/``_count``."""
    lines = []
    typed: dict[str, str] = {}
    for name in sorted(snapshot):
        m = snapshot[name]
        raw_base, labels = _metrics.split_labeled(name)
        base = _prom_name(raw_base)
        mtype = m.get("type", "gauge")
        prev = typed.get(base)
        if prev is None:
            typed[base] = mtype
            lines.append(f"# TYPE {base} "
                         f"{'histogram' if mtype == 'histogram' else mtype}")
        elif prev != mtype:
            raise ValueError(
                f"metric family {base!r} mixes types {prev} and {mtype}")
        if mtype in ("counter", "gauge"):
            lines.append(_sample(base, labels, "", m.get("value", 0)))
            continue
        bounds = _metrics.snapshot_bounds(m)
        counts = [0] * (len(bounds) + 1)
        for i, c in m.get("buckets", ()):
            counts[i] += c
        cum = 0
        for i, bound in enumerate(bounds):
            cum += counts[i]
            lines.append(_sample(f"{base}_bucket", labels,
                                 f'le="{bound:.6g}"', cum))
        lines.append(_sample(f"{base}_bucket", labels, 'le="+Inf"',
                             m.get("count", 0)))
        lines.append(_sample(f"{base}_sum", labels, "", m.get("sum", 0.0)))
        lines.append(_sample(f"{base}_count", labels, "", m.get("count", 0)))
    return "\n".join(lines) + "\n"


class StatuszServer:
    """One loopback debug server per process.

    ``providers`` maps endpoint roles to zero-argument callables returning
    JSON-safe host data:

    - ``health``  -> dict merged into the /healthz body
    - ``status``  -> dict for /statusz
    - ``metrics`` -> registry snapshot for /metricsz (default: this
      process's ``get_registry().snapshot()``)
    - ``tracer``  -> the Tracer whose ring /tracez serves (default: the
      process tracer)
    - ``flight``  -> list of flight-recorder events for /flightz

    Call :meth:`start` to bind (port 0 = ephemeral; the bound port is in
    ``self.port``) and :meth:`stop` to shut down.  The serve thread and
    the per-request handler threads are daemons: a hung scrape can never
    block process exit."""

    def __init__(self, *, role: str, index: int | None = None,
                 port: int = 0, providers: dict | None = None):
        self.role = role
        self.index = index
        # held by REFERENCE: the owner may register providers after
        # start()
        self.providers = providers if providers is not None else {}
        self._want_port = port
        self.port: int | None = None
        self._httpd = None
        self._thread = None

    # ------------------------------------------------------------- lifecycle

    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent: stderr is the worker log
                pass

            def do_GET(self):
                try:
                    body, ctype = server._render(self.path)
                except KeyError:
                    self._reply(404, b"not found\n", "text/plain")
                    return
                except Exception as e:  # racy host-dict read: retryable
                    self._reply(503, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode() + b"\n", "application/json")
                    return
                self._reply(200, body, ctype)

            def _reply(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._want_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"statusz-{self.role}")
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # ------------------------------------------------------------- endpoints

    def _call(self, key, default):
        fn = self.providers.get(key)
        return fn() if fn is not None else default

    def _render(self, path: str) -> tuple[bytes, str]:
        path = path.split("?", 1)[0].rstrip("/") or "/healthz"
        if path == "/healthz":
            body = {"status": "ok", "role": self.role}
            if self.index is not None:
                body["index"] = self.index
            body.update(self._call("health", {}))
            return self._json(body)
        if path == "/statusz":
            return self._json(self._call("status", {}))
        if path == "/metricsz":
            fn = self.providers.get("metrics")
            snap = fn() if fn is not None else (
                _metrics.get_registry().snapshot())
            return (render_prometheus(snap).encode(),
                    "text/plain; version=0.0.4; charset=utf-8")
        if path == "/tracez":
            tracer = self.providers.get("tracer")
            if tracer is None:
                from progen_tpu_torch.observe.trace import get_tracer
                tracer = get_tracer()
            return self._json({"process": tracer.process,
                               "enabled": tracer.enabled,
                               "spans": tracer.ring()[-512:]})
        if path == "/flightz":
            return self._json({"events": self._call("flight", [])})
        raise KeyError(path)

    @staticmethod
    def _json(obj) -> tuple[bytes, str]:
        return (json.dumps(obj, indent=1, sort_keys=True).encode() + b"\n",
                "application/json")
