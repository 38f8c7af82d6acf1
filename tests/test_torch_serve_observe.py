"""The multi-process cases of ``tests/test_trace.py`` (``:196``, ``:231``),
``tests/test_statusz.py`` (``:477``) and ``tests/test_qos.py`` (``:417``),
run on the port's fleet of ``progen_tpu_torch.serve.worker`` processes on
the CPU: handle frames carry each request's trace context, the merged
trace of the driver and both workers is causally ordered, every process
serves live /healthz and /metricsz (the driver the fleet view and the SLO
burn rates) without changing a token, and a priority mix gives
the single-process engine's tokens."""

import json
import os
import re
import time
import urllib.error
import urllib.request

import pytest
import torch

from progen_tpu_torch.decode.engine import Request
from progen_tpu_torch.decode.handoff import (
    deserialize_handle,
    request_to_wire,
    serialize_handle,
    unpack_frame,
)
from progen_tpu_torch.models import ProGenConfig
from progen_tpu_torch.observe.trace import (
    configure_tracing,
    load_dump,
    merge_dumps,
    merge_trace_dir,
    spans_for,
)
from progen_tpu_torch.serve.cluster import ServeCluster
from progen_tpu_torch.serve.worker import build_engine_from_spec, make_spec

pytestmark = pytest.mark.multiproc

torch.set_num_threads(1)

CFG = ProGenConfig(num_tokens=32, dim=16, seq_len=24, depth=2, window_size=4,
                   global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
ENGINE_KW = dict(num_slots=4, chunk_size=4, max_len=24, prefill_batch=2,
                 handoff_depth=2)


def _tiny_spec(variant="dense", trace_dir=None, statusz=False, **engine):
    kw = {**ENGINE_KW, **engine, **{
        "dense": {},
        "paged": dict(paged=True, page_size=4, num_pages=32),
        "spec": dict(spec=True, spec_k=2),
    }[variant]}
    return make_spec(CFG, mixed_precision=False, init_seed=7, engine=kw,
                     trace={"dir": trace_dir} if trace_dir else None,
                     statusz=statusz, device="cpu")


@pytest.fixture
def driver_tracing():
    """Enable the process tracer for one test, restore disabled and empty."""
    tracer = configure_tracing(enabled=True, process="driver")
    tracer.clear()
    yield tracer
    tracer.clear()
    configure_tracing(enabled=False, capacity=4096, process="main")


# ------------------------------------------------------------- tracing


@pytest.mark.trace
def test_request_wire_carries_trace_context():
    wire = request_to_wire(Request(uid="r1", tokens=[1, 2], max_new_tokens=3), now=42.0)
    assert wire["trace"] == {"id": "r1", "clock": 42.0}


@pytest.mark.trace
@pytest.mark.parametrize("variant", [
    "dense", "paged",
    pytest.param("spec", marks=pytest.mark.slow),
])
def test_handle_frame_carries_trace_context(variant):
    """Every request row on a handle frame names its trace id (the uid) and
    the sender's clock, and the producer's trace_ctx extra header survives
    the frame round trip."""
    eng = build_engine_from_spec(_tiny_spec(variant))
    for i in range(2):
        eng.submit(Request(uid=10 + i, tokens=[1 + i, 2, 3], max_new_tokens=4, seed=i))
    frame = serialize_handle(
        eng.run_prefill_round(),
        extra_header={"trace_ctx": {"clock": 1.5, "src_proc": "prefill:0"}})
    header, _ = unpack_frame(frame)
    assert [d["uid"] for d in header["reqs"]] == [10, 11]
    for d in header["reqs"]:
        assert d["trace"]["id"] == d["uid"]
        assert d["trace"]["clock"] > 0.0
    assert header["trace_ctx"] == {"clock": 1.5, "src_proc": "prefill:0"}
    h2 = deserialize_handle(frame)
    assert [r.uid for r in h2.requests] == [10, 11]


@pytest.mark.trace
def test_cluster_merged_trace_is_causally_ordered(tmp_path, driver_tracing):
    """One uid's spans appear in all three processes (driver router, prefill
    worker, decode replica) and, after the driver's clock-offset
    correction, driver-side causes precede worker-side effects: submit
    before the prefill round, relay before the decode merge."""
    cluster = ServeCluster(_tiny_spec(trace_dir=str(tmp_path)))
    try:
        for i in range(2):
            cluster.submit(Request(uid=i, tokens=[1 + i, 2, 3], max_new_tokens=4,
                                   top_k=None, temperature=0.0, seed=i))
        done = cluster.drain(timeout=300.0)
    finally:
        stats = cluster.shutdown()
    assert len(done) == 2 and all(c.ok for c in done)
    assert set(stats["clock_offsets"]) == {"prefill:0", "decode:0"}

    merged_path = merge_trace_dir(str(tmp_path))
    assert merged_path is not None
    obj = json.load(open(merged_path))
    proc_names = {e["args"]["name"] for e in obj["traceEvents"] if e["ph"] == "M"}
    assert {"driver", "prefill:0", "decode:0"} <= proc_names

    dumps = [load_dump(os.path.join(str(tmp_path), f))
             for f in sorted(os.listdir(str(tmp_path)))
             if f.startswith("trace_") and f.endswith(".json")]
    spans = merge_dumps(dumps)
    by_proc: dict = {}
    for s in spans_for(spans, 0):
        by_proc.setdefault(s["process"], []).append(s)
    assert {"driver", "prefill:0", "decode:0"} <= set(by_proc)

    def first(proc, *names):
        ts = [s["ts"] for s in by_proc[proc] if s["name"] in names]
        assert ts, (proc, names)
        return min(ts)

    # offset estimates only ever overestimate, which can only push worker
    # spans LATER on the driver clock: driver-cause <= worker-effect is the
    # direction the correction preserves
    submit = first("driver", "cluster.submit")
    assert submit <= first("prefill:0", "serve.prefill", "serve.admit_prefill")
    assert first("driver", "cluster.relay") <= first("decode:0", "serve.merge")
    assert first("driver", "cluster.done") >= submit


# ------------------------------------------------------------- statusz


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


# strict Prometheus line-format checker (tests/test_statusz.py)
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


def _drive(statusz):
    cluster = ServeCluster(_tiny_spec(statusz=statusz))
    probes = {}
    try:
        for i in range(3):
            cluster.submit(Request(uid=i, tokens=[1 + i, 2, 3], max_new_tokens=4,
                                   top_k=None, temperature=0.0, seed=i))
        done = cluster.drain(timeout=300.0)
        if statusz:
            # the port's tiny fleet can drain inside its first heartbeat
            # period (1 s): the per-worker age gauges need one beat each
            deadline = time.perf_counter() + 10.0
            while len(cluster.stats()["heartbeats"]) < 2 and time.perf_counter() < deadline:
                cluster.poll(0.1)
            ports = cluster.stats()["statusz_ports"]
            assert set(ports) == {"driver", "prefill:0", "decode:0"}
            for who, port in ports.items():
                code, body, _ = _fetch(port, "/healthz")
                assert code == 200
                health = json.loads(body)
                assert health["status"] == "ok"
                code, text, _ = _fetch(port, "/metricsz")
                assert code == 200
                probes[who] = (health, text)
            code, body, _ = _fetch(ports["driver"], "/statusz")
            assert code == 200
            probes["driver_statusz"] = json.loads(body)
    finally:
        cluster.shutdown()
    toks = {c.uid: [int(t) for t in c.tokens] for c in done if c.ok}
    assert len(toks) == 3
    return toks, probes


@pytest.mark.trace
def test_cluster_statusz_live_and_zero_perturbation():
    """Every process of a real 2-worker fleet (driver + prefill:0 +
    decode:0) serves live /healthz and /metricsz while the fleet runs, the
    driver's /statusz aggregates worker registries and SLO burn rates, and
    the served tokens are IDENTICAL to an introspection-disabled run."""
    with_toks, probes = _drive(statusz=True)
    assert probes["prefill:0"][0]["phase"] == "serving"
    assert probes["decode:0"][0]["phase"] == "serving"
    assert set(probes["driver"][0]["peers"]) == {"prefill:0", "decode:0"}
    for who in ("driver", "prefill:0", "decode:0"):
        _assert_strict_exposition(probes[who][1])
    driver_text = probes["driver"][1]
    assert re.search(r'^cluster_up\{idx="0",role="decode"\} 1$', driver_text, re.M)
    assert re.search(r'^cluster_up\{idx="0",role="prefill"\} 1$', driver_text, re.M)
    assert re.search(r'^cluster_worker_age_s\{idx="0",role="decode"\} ',
                     driver_text, re.M)
    status = probes["driver_statusz"]
    assert "cluster.latency_s" in status["metrics"]
    slo_block = {s["name"]: s for s in status["slo"]}
    assert set(slo_block) == {"latency_p95_2s", "goodput"}
    assert slo_block["goodput"]["count"] >= 3
    for res in slo_block.values():
        assert set(res["windows"]) == {"60s", "300s", "900s"}

    without_toks, _ = _drive(statusz=False)
    assert with_toks == without_toks, "introspection plane perturbed served tokens"


# ------------------------------------------------------------- qos


@pytest.mark.serving
@pytest.mark.qos
def test_cluster_priority_mix_token_identity():
    """A real fleet: a mixed priority workload completes token-identical to
    the single-process engine (priorities steer scheduling, never tokens)
    and the router's class-load bookkeeping drains to zero."""
    spec = _tiny_spec(qos_weights={0: 1.0, 1: 2.0})
    reqs = [Request(uid=i, tokens=[1 + i, 2, 3], max_new_tokens=6,
                    top_k=(None if i % 2 else 8),
                    temperature=(0.0 if i % 2 else 1.0), seed=100 + i,
                    priority=(2 if i % 3 == 0 else 0))
            for i in range(4)]
    cluster = ServeCluster(spec)
    try:
        for r in reqs:
            cluster.submit(r)
        done = cluster.drain(timeout=300.0)
    finally:
        cluster.shutdown()
    assert len(done) == 4 and all(c.ok for c in done)

    # the oracle: the same spec WITHOUT priorities or weights, one process
    ref = build_engine_from_spec(_tiny_spec())
    for r in reqs:
        ref.submit(Request(uid=r.uid, tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                           top_k=r.top_k, temperature=r.temperature, seed=r.seed))
    want = {c.uid: [int(t) for t in c.tokens] for c in ref.run_until_idle(max_chunks=200)}
    assert {c.uid: [int(t) for t in c.tokens] for c in done} == want
    assert cluster.router.queued_by_class() == {}
