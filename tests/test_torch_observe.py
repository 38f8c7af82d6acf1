"""The port's observability on the CPU: its copies of the process tracer,
the metrics registry and the statusz server (``observe/trace.py``,
``observe/metrics.py``, ``observe/statusz.py``) pass the JAX package's own
tests of them (``tests/test_trace.py``, ``tests/test_statusz.py``) and give
the JAX functions' outputs on the same inputs; the watchdog dumps the span
ring on a trip; the serving engine writes the JAX engine's spans, in its
order, feeds the ``engine.*_s`` histograms and the queue and cache gauges,
and serves the same tokens with tracing on and off; the ``Trainer`` writes
its phases as spans, publishes the ``train.*`` gauges and serves statusz.
Tokens exactly, f32."""

import json
import re
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.observe import metrics as jax_metrics
from progen_tpu.observe import statusz as jax_statusz
from progen_tpu.observe import trace as jax_trace
from progen_tpu.parallel import unbox
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe import metrics, statusz, trace
from progen_tpu_torch.observe.metrics import (
    LATENCY_BUCKETS,
    Histogram,
    MetricsRegistry,
    get_registry,
    labeled,
    latency_percentiles,
    merge_snapshots,
    split_labeled,
)
from progen_tpu_torch.observe.statusz import StatuszServer, render_prometheus
from progen_tpu_torch.observe.trace import (
    Tracer,
    chrome_trace,
    configure_tracing,
    merge_dumps,
    merge_trace_dir,
    spans_for,
    trace_dump_path,
)
from progen_tpu_torch.resilience.watchdog import Watchdog
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

KW = dict(num_tokens=32, dim=16, seq_len=24, depth=3, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE = dict(num_slots=2, chunk_size=4, max_len=20)


@pytest.fixture
def tracing():
    """The port's process tracer on for one test, then off and empty."""
    tracer = configure_tracing(enabled=True, process="test")
    tracer.clear()
    yield tracer
    tracer.clear()
    configure_tracing(enabled=False, capacity=4096, process="main")


@pytest.fixture
def both_tracing():
    """Both packages' process tracers on for one test, then off and empty."""
    tracers = [mod.configure_tracing(enabled=True, process="test")
               for mod in (trace, jax_trace)]
    for t in tracers:
        t.clear()
    yield tracers
    for mod, t in zip((trace, jax_trace), tracers):
        t.clear()
        mod.configure_tracing(enabled=False, capacity=4096, process="main")


# ----------------------------------- tests/test_trace.py on the port's copies


def test_disabled_tracer_is_noop():
    t = Tracer()  # disabled by default
    assert t.span("a") is t.span("b")        # shared no-op singleton
    with t.span("a", trace=1, big=list(range(100))):
        pass
    t.add("b", 0.0, 1.0, trace=2)
    t.event("c", trace=3)
    assert t.ring() == []


def test_span_ring_records_and_bounds(tracing):
    t = tracing
    with t.span("outer", trace=7, kind="x"):
        t.event("inner", trace=7)
    ring = t.ring()
    assert [s["name"] for s in ring] == ["inner", "outer"]
    outer = ring[1]
    assert outer["trace"] == 7 and outer["args"] == {"kind": "x"}
    assert outer["dur"] >= 0.0
    configure_tracing(enabled=True, capacity=4)
    for i in range(10):
        t.event(f"e{i}")
    assert [s["name"] for s in t.ring()] == ["e6", "e7", "e8", "e9"]
    configure_tracing(enabled=True, capacity=4096)


def test_spans_for_matches_trace_and_batch_uids():
    spans = [
        {"name": "a", "ts": 0.0, "dur": 1.0, "trace": 5},
        {"name": "b", "ts": 1.0, "dur": 1.0, "args": {"uids": [4, 5]}},
        {"name": "c", "ts": 2.0, "dur": 1.0, "trace": "other"},
    ]
    assert [s["name"] for s in spans_for(spans, 5)] == ["a", "b"]
    assert [s["name"] for s in spans_for(spans, "other")] == ["c"]


ROUTER = {"process": "router", "pid": 1, "meta": {"offsets": {"prefill:0": 10.0}},
          "spans": [{"name": "cluster.submit", "ts": 11.0, "dur": 0.1, "trace": 0}]}
WORKER = {"process": "prefill:0", "pid": 2, "meta": {},
          "spans": [{"name": "serve.prefill", "ts": 1.5, "dur": 0.2,
                     "args": {"uids": [0]}}]}


def test_merge_dumps_applies_offsets_and_chrome_export(tmp_path):
    merged = merge_dumps([ROUTER, WORKER])
    assert [(s["name"], s["ts"]) for s in merged] == [
        ("cluster.submit", 11.0), ("serve.prefill", 11.5)]
    obj = chrome_trace([ROUTER, WORKER])
    names = {e["args"]["name"] for e in obj["traceEvents"] if e["ph"] == "M"}
    assert names == {"router", "prefill:0"}
    xs = [e for e in obj["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"cluster.submit", "serve.prefill"}
    assert all(e["ts"] >= 1e6 for e in xs)   # microseconds
    for d in (ROUTER, WORKER):
        with open(trace_dump_path(str(tmp_path), d["process"]), "w") as fh:
            json.dump(d, fh)
    out = merge_trace_dir(str(tmp_path))
    assert out is not None
    loaded = json.load(open(out))
    assert len([e for e in loaded["traceEvents"] if e["ph"] == "X"]) == 2


def test_histogram_percentiles_against_numpy_oracle():
    rng = np.random.default_rng(0)
    values = np.exp(rng.uniform(np.log(1e-3), np.log(10.0), size=2000))
    h = Histogram("t")
    for v in values:
        h.observe(float(v))
    for p in (50.0, 95.0, 99.0):
        est = h.percentile(p)
        exact = float(np.percentile(values, p))
        assert abs(est - exact) / exact < 0.25, (p, est, exact)
    assert h.percentile(0.0) == pytest.approx(h.min)
    assert h.percentile(100.0) == pytest.approx(h.max)
    assert h.mean == pytest.approx(float(values.mean()), rel=1e-6)


def test_latency_percentiles_shared_path_resets():
    p50, p95 = latency_percentiles([0.1] * 99 + [10.0])
    assert p50 == pytest.approx(0.1, rel=0.3)
    assert p95 == pytest.approx(0.1, rel=0.3)
    p50b, _ = latency_percentiles([5.0, 5.0, 5.0])
    assert p50b == pytest.approx(5.0, rel=0.3)
    assert get_registry().histogram("bench.latency_s").count == 3


def test_registry_get_or_create_and_type_conflict():
    reg = MetricsRegistry()
    c = reg.counter("reqs")
    c.inc()
    assert reg.counter("reqs") is c and c.value == 1
    reg.gauge("depth").set(3)
    reg.histogram("lat").observe(0.5)
    with pytest.raises(ValueError):
        reg.counter("lat")
    snap = reg.snapshot()
    assert snap["reqs"] == {"type": "counter", "value": 1}
    assert snap["depth"]["value"] == 3
    assert snap["lat"]["count"] == 1
    assert json.dumps(snap)


# --------------------------------- tests/test_statusz.py on the port's copies

_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})?'
    r' (-?\d+(\.\d+)?([eE][+-]?\d+)?|[+-]Inf|NaN)$')


def _assert_strict_exposition(text):
    samples = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _PROM_LINE.match(line), f"bad exposition line: {line!r}"
        samples += 1
    assert samples > 0
    return samples


def _fetch(port, path, timeout=10.0):
    """GET with a few retries: a racy host-dict read answers 503."""
    last = None
    for _ in range(5):
        try:
            resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                          timeout=timeout)
            return resp.status, resp.read().decode(), resp.headers
        except urllib.error.HTTPError as e:
            last = e
            if e.code != 503:
                return e.code, e.read().decode(), e.headers
    raise AssertionError(f"{path} kept failing: {last}")


def test_labeled_names_sort_and_escape():
    assert labeled("cluster.up", role="prefill", idx=0) == \
        'cluster.up{idx="0",role="prefill"}'
    assert labeled("m", b=1, a=2) == labeled("m", a=2, b=1)
    nasty = labeled("m", k='a"b\\c\nd')
    assert nasty == 'm{k="a\\"b\\\\c\\nd"}'
    base, labelstr = split_labeled(nasty)
    assert base == "m" and labelstr == 'k="a\\"b\\\\c\\nd"'
    assert split_labeled("plain") == ("plain", "")


def test_render_prometheus_counters_gauges_and_escaping():
    reg = MetricsRegistry()
    reg.counter("serve.requests").inc(3)
    reg.gauge(labeled("cluster.up", role="prefill", idx=0)).set(1)
    reg.gauge(labeled("cluster.up", role="decode", idx=0)).set(0)
    reg.gauge(labeled("weird-name.g", path='a"b\\c')).set(2.5)
    text = render_prometheus(reg.snapshot())
    lines = text.splitlines()
    assert "# TYPE serve_requests counter" in lines
    assert "serve_requests 3" in lines
    assert lines.count("# TYPE cluster_up gauge") == 1
    assert 'cluster_up{idx="0",role="prefill"} 1' in lines
    assert 'cluster_up{idx="0",role="decode"} 0' in lines
    assert 'weird_name_g{path="a\\"b\\\\c"} 2.5' in lines
    _assert_strict_exposition(text)


def test_render_prometheus_histogram_cumulative_and_inf_terminal():
    reg = MetricsRegistry()
    h = reg.histogram("lat_s")
    for v in (0.001, 0.01, 0.01, 0.1, 50.0, 1000.0):  # 1000 > top bound
        h.observe(v)
    text = render_prometheus(reg.snapshot())
    _assert_strict_exposition(text)
    buckets = []
    for line in text.splitlines():
        m = re.match(r'lat_s_bucket\{le="([^"]+)"\} (\d+)$', line)
        if m:
            buckets.append((m.group(1), int(m.group(2))))
    assert len(buckets) == len(LATENCY_BUCKETS) + 1
    assert buckets[-1][0] == "+Inf" and buckets[-1][1] == 6
    counts = [c for _, c in buckets]
    assert counts == sorted(counts)
    assert counts[0] >= 0 and counts[-2] == 5
    assert "lat_s_count 6" in text.splitlines()
    sum_line = [line for line in text.splitlines() if line.startswith("lat_s_sum ")][0]
    assert float(sum_line.split()[1]) == pytest.approx(1050.121)


def test_render_prometheus_rejects_mixed_type_family():
    snap = {"m": {"type": "counter", "value": 1},
            'm{a="b"}': {"type": "gauge", "value": 2}}
    with pytest.raises(ValueError, match="mixes types"):
        render_prometheus(snap)


def test_merge_snapshots_fleet_semantics():
    regs = [MetricsRegistry() for _ in range(3)]
    for i, reg in enumerate(regs):
        reg.counter("serve.requests").inc(i + 1)
        reg.gauge(labeled("cluster.up", role="decode", idx=i)).set(1)
        h = reg.histogram("serve.latency_s")
        h.observe(0.01 * (i + 1))
        h.observe(10.0)
    merged = merge_snapshots([r.snapshot() for r in regs])
    assert merged["serve.requests"]["value"] == 6
    for i in range(3):
        assert merged[labeled("cluster.up", role="decode", idx=i)]["value"] == 1
    h = merged["serve.latency_s"]
    assert h["count"] == 6
    assert h["sum"] == pytest.approx(30.06)
    assert h["min"] == pytest.approx(0.01)
    assert h["max"] == pytest.approx(10.0)
    assert h["p95"] == pytest.approx(10.0, rel=0.3)
    _assert_strict_exposition(render_prometheus(merged))
    other = MetricsRegistry()
    other.histogram("serve.latency_s", buckets=(1.0, 2.0)).observe(0.5)
    with pytest.raises(ValueError, match="different bounds"):
        merge_snapshots([regs[0].snapshot(), other.snapshot()])


def test_statusz_server_endpoints():
    reg = MetricsRegistry()
    reg.counter("serve.requests").inc(7)
    boom = {"on": False}

    def status():
        if boom["on"]:
            raise RuntimeError("racy dict")
        return {"slots": {"total": 4}}

    srv = StatuszServer(role="decode", index=1, providers={
        "health": lambda: {"phase": "serving"},
        "status": status,
        "metrics": reg.snapshot,
    })
    try:
        port = srv.start()
        code, body, headers = _fetch(port, "/healthz")
        assert code == 200
        health = json.loads(body)
        assert health["status"] == "ok" and health["role"] == "decode"
        assert health["index"] == 1 and health["phase"] == "serving"
        code, body, _ = _fetch(port, "/statusz")
        assert code == 200 and json.loads(body)["slots"]["total"] == 4
        code, body, headers = _fetch(port, "/metricsz")
        assert code == 200
        assert headers["Content-Type"].startswith("text/plain")
        assert "serve_requests 7" in body.splitlines()
        _assert_strict_exposition(body)
        code, body, _ = _fetch(port, "/tracez")
        assert code == 200 and "spans" in json.loads(body)
        code, body, _ = _fetch(port, "/flightz")
        assert code == 200 and json.loads(body)["events"] == []
        code, _, _ = _fetch(port, "/nope")
        assert code == 404
        code, _, _ = _fetch(port, "/controlz")  # the fleet's control plane: not here
        assert code == 404
        boom["on"] = True
        try:
            resp = urllib.request.urlopen(f"http://127.0.0.1:{port}/statusz", timeout=10)
            assert False, f"expected 503, got {resp.status}"
        except urllib.error.HTTPError as e:
            assert e.code == 503
            assert "racy dict" in json.loads(e.read().decode())["error"]
        boom["on"] = False
        code, _, _ = _fetch(port, "/statusz")
        assert code == 200
    finally:
        srv.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)


# ------------------------------------------- the port's copies against JAX's


def _registries(pkg):
    regs = [pkg.MetricsRegistry() for _ in range(2)]
    rng = np.random.default_rng(4)
    for i, reg in enumerate(regs):
        reg.counter("serve.requests").inc(i + 2)
        reg.gauge(pkg.labeled("engine.inflight", tenant=i)).set(i)
        reg.gauge("train.loss").set(2.5 + i)
        h = reg.histogram("engine.decode_chunk_s")
        for v in np.exp(rng.uniform(np.log(1e-4), np.log(50.0), 40)):
            h.observe(float(v))
    return [r.snapshot() for r in regs]


@pytest.mark.parametrize("what", ["buckets", "snapshot", "merge", "prometheus",
                                  "percentiles", "chrome_trace"])
def test_port_observe_gives_jax_outputs(what):
    """Each copied function on the same inputs returns what the JAX
    package's does (the 64 log-spaced bounds included)."""
    if what == "buckets":
        assert metrics.LATENCY_BUCKETS == jax_metrics.LATENCY_BUCKETS
        assert len(metrics.LATENCY_BUCKETS) == 64
        assert metrics.latency_buckets(1e-3, 1.0, 8) == jax_metrics.latency_buckets(1e-3, 1.0, 8)
    elif what == "snapshot":
        assert _registries(metrics) == _registries(jax_metrics)
    elif what == "merge":
        assert (metrics.merge_snapshots(_registries(metrics))
                == jax_metrics.merge_snapshots(_registries(jax_metrics)))
        # snapshots of one package merge with the other's
        assert (metrics.merge_snapshots(_registries(jax_metrics))
                == jax_metrics.merge_snapshots(_registries(metrics)))
    elif what == "prometheus":
        snap = metrics.merge_snapshots(_registries(metrics))
        assert statusz.render_prometheus(snap) == jax_statusz.render_prometheus(snap)
    elif what == "percentiles":
        values = [0.1] * 50 + [3.0] * 10 + [0.002] * 5
        assert metrics.latency_percentiles(values, (50, 90, 99)) == \
            jax_metrics.latency_percentiles(values, (50, 90, 99))
    else:
        assert trace.chrome_trace([ROUTER, WORKER]) == jax_trace.chrome_trace([ROUTER, WORKER])
        assert trace.merge_dumps([ROUTER, WORKER]) == jax_trace.merge_dumps([ROUTER, WORKER])


def test_watchdog_trip_dumps_the_span_ring(tracing, tmp_path):
    """A trip writes the stacks and, when the process is tracing, the span
    ring (the last spans before the stall)."""
    tracing.event("serve.step", trace=3)
    exits = []
    wd = Watchdog(timeout=0.2, out_dir=str(tmp_path), exit_fn=exits.append,
                  poll_interval=0.05)
    wd.start()
    try:
        deadline = time.monotonic() + 10
        while not exits and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        wd.stop()
    assert wd.tripped and exits == [42]
    dumps = [a for a in wd.artifacts if "watchdog_trace_" in a]
    assert len(dumps) == 1
    spans = json.load(open(dumps[0]))["spans"]
    assert [s["name"] for s in spans] == ["serve.step"]


# ------------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((2, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(7), tokens))


@pytest.fixture(scope="module")
def model(flax_params):
    m = ProGen(CFG, make_policy(False), device="cpu")
    m.load_state_dict(params_from_flax(flax_params))
    return m.eval()


def _requests(n=5):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        p = int(rng.integers(1, 9))
        out.append(dict(uid=i, tokens=rng.integers(1, CFG.num_tokens, p).tolist(),
                        max_new_tokens=8, top_k=None if i % 2 == 0 else 5,
                        temperature=0.0 if i % 2 == 0 else 0.8, seed=100 + i))
    return out


def _serve(engine, request_cls, reqs):
    for r in reqs:
        engine.submit(request_cls(**r))
    return {c.uid: (c.tokens.tolist(), c.status)
            for c in engine.run_until_idle(max_chunks=300)}


MODES = {"dense": {}, "paged": dict(paged=True, page_size=4),
         "disagg": dict(paged=True, page_size=4, disagg=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_spans_are_the_jax_engines(model, flax_params, both_tracing, mode):
    """With tracing on, the port's engine writes the JAX engine's spans and
    events, by name in the same order, with the same request uids; and the
    tokens are JAX's."""
    ours_tracer, jax_tracer = both_tracing
    ours = _serve(ServingEngine(model, **ENGINE, **MODES[mode]), Request, _requests())
    theirs = _serve(JaxServingEngine(JAX_CFG, flax_params, policy=jax_policy(False),
                                     **ENGINE, **MODES[mode]), JaxRequest, _requests())
    assert ours == theirs

    def names(tracer):
        return [(s["name"], s.get("trace"), s.get("args", {}).get("uids"))
                for s in tracer.ring()]

    got, want = names(ours_tracer), names(jax_tracer)
    assert got == want
    assert {"serve.submit", "serve.decode_chunk", "serve.harvest"} <= {n for n, _, _ in got}


def test_engine_histograms_gauges_and_tracing_off(model, tmp_path):
    """Every decode chunk is one observation of ``engine.decode_chunk_s``
    (and one span when tracing); each step refreshes the queue, in-flight
    and cache gauges; tracing changes no token."""
    registry = get_registry()
    off_engine = ServingEngine(model, **ENGINE, paged=True, page_size=4)
    before = registry.histogram("engine.decode_chunk_s").count
    off = _serve(off_engine, Request, _requests())
    assert registry.histogram("engine.decode_chunk_s").count - before == \
        off_engine.chunks_run > 0
    assert trace.get_tracer().ring() == []

    tracer = configure_tracing(enabled=True, process="test")
    tracer.clear()
    try:
        on_engine = ServingEngine(model, **ENGINE, paged=True, page_size=4)
        before = registry.histogram("engine.decode_chunk_s").count
        on = _serve(on_engine, Request, _requests())
        spans = tracer.ring()
        tracer.dump(trace_dump_path(str(tmp_path), "test"))
    finally:
        tracer.clear()
        configure_tracing(enabled=False, process="main")
    assert on == off
    chunks = [s for s in spans if s["name"] == "serve.decode_chunk"]
    assert len(chunks) == on_engine.chunks_run == \
        registry.histogram("engine.decode_chunk_s").count - before
    assert registry.histogram("engine.prefill_s").count > 0
    loaded = json.load(open(merge_trace_dir(str(tmp_path))))
    assert {"serve.submit", "serve.admit_prefill", "serve.decode_chunk",
            "serve.harvest"} <= {e["name"] for e in loaded["traceEvents"]}
    snap = registry.snapshot()
    assert snap["engine.pool_free_pages"]["value"] == on_engine.cache_status()["free_pages"]
    assert snap["engine.prefix_lookups"]["value"] == on_engine.prefix_lookups
    # drained: the labeled depths read 0, not their last value
    assert snap[labeled("engine.inflight", tenant=0)]["value"] == 0
    assert snap[labeled("engine.queue_depth", priority=0)]["value"] == 0
    assert "engine_decode_chunk_s_count" in render_prometheus(snap)


# ----------------------------------------------------------------- the trainer


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(6, 40), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 20, "train"), [mk() for _ in range(20)])
    write_tfrecord(d / shard_filename(0, 5, "valid"), [mk() for _ in range(5)])
    return d


def test_trainer_spans_gauges_and_statusz(data_dir, tmp_path, tracing):
    """Two CPU steps: each loop phase is a span and a flight-recorder event,
    the ``train.*`` gauges hold the last logged step's host floats, and the
    statusz endpoints answer from them while the Trainer lives."""
    tcfg = ProGenConfig(num_tokens=256, dim=32, seq_len=32, depth=2, window_size=16,
                        global_mlp_depth=1, heads=2, dim_head=16, ff_mult=2)
    cfg = TrainerConfig(batch_size=2, grad_accum_every=1, learning_rate=1e-3,
                        validate_every=2, sample_every=1000, checkpoint_every=1000,
                        prime_length=4, mixed_precision=False, log_every=1,
                        max_steps=2, statusz_port=0)
    t = Trainer(tcfg, cfg, str(data_dir), str(tmp_path / "ck"), device="cpu")
    try:
        out = t.run()
        spans = tracing.ring()
        names = [s["name"] for s in spans]
        assert names.count("train.step_dispatch") == 2
        assert names.count("train.log") == 2 and names.count("train.validate") == 1
        assert [s["args"]["step"] for s in spans if s["name"] == "train.log"] == [1, 2]
        kinds = [e["kind"] for e in t._recorder.snapshot()]
        assert kinds.count("train.step_dispatch") == 2
        snap = get_registry().snapshot()
        assert snap["train.step"]["value"] == 2
        assert snap["train.loss"]["value"] == out["loss"]
        assert snap["train.lr"]["value"] == pytest.approx(1e-3)
        assert snap["train.grad_norm"]["value"] > 0

        port = t.statusz_port
        code, body, _ = _fetch(port, "/healthz")
        health = json.loads(body)
        assert code == 200 and health["role"] == "trainer"
        assert health["last_step"]["step"] == 2
        assert health["last_step"]["loss"] == out["loss"]
        code, body, _ = _fetch(port, "/metricsz")
        assert code == 200 and f"train_loss {out['loss']!r}" in body.splitlines()
        _assert_strict_exposition(body)
        code, body, _ = _fetch(port, "/statusz")
        assert json.loads(body)["max_steps"] == 2
        code, body, _ = _fetch(port, "/flightz")
        assert any(e["kind"] == "step" for e in json.loads(body)["events"])
        code, body, _ = _fetch(port, "/tracez")
        assert any(s["name"] == "train.log" for s in json.loads(body)["spans"])
    finally:
        t.close()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2)


def test_train_cli_statusz_flag(data_dir, tmp_path, capsys):
    """``--statusz`` (bare: an ephemeral port) starts the Trainer's server,
    announced as a JSON line; the run ends with it stopped.  Without
    ``--data_path`` (no Trainer) the flag is refused."""
    from progen_tpu_torch.train import cli as train_cli

    out = train_cli.main(["--data_path", str(data_dir), "--checkpoint_path",
                          str(tmp_path / "ck"), "--runs_dir", str(tmp_path / "runs"),
                          "--model_name", "default", "--batch_size", "1",
                          "--grad_accum_every", "1", "--max_steps", "1", "--log_every", "1",
                          "--no_warm_sampler", "--statusz", "--device", "cpu"])
    assert out["step"] == 1
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    url = [line["statusz"] for line in lines if "statusz" in line]
    assert len(url) == 1 and re.fullmatch(r"http://127\.0\.0\.1:\d+", url[0])
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{url[0]}/healthz", timeout=2)
    with pytest.raises(SystemExit):
        train_cli.parse_args(["--statusz", "--device", "cpu"])
