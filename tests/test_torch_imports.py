"""The port stands alone: no module of ``progen_tpu_torch`` (the serving
fleet's ``serve/*`` and its worker module among them), not
``chip_smoke.py`` and not the ranks' worker of the multi-rank tests
(``tests/_torch_parallel_worker.py``) imports JAX, flax, optax, orbax,
TensorFlow, ``google_crc32c``, safetensors, click or the JAX package, and
the port's sampling, serving and training CLIs run on the CPU when asked
to.  The fleet's framework-neutral copies (``observe/transport.py``,
``observe/slo.py``, ``resilience/supervise.py``, ``serve/transport.py``,
``serve/router.py``, ``serve/policy.py``) are pinned to their originals
on scripted runs; the fleet's elastic verbs keep the JAX cluster's
bookkeeping, a replica group checks the model's tensor dims, and the
sampling CLI's elastic flags parse to the JAX CLI's policy bounds and
drive a fleet on the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from progen_tpu_torch import sample
from progen_tpu_torch.train import cli as train_cli

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "progen_tpu", "tensorflow",
             "google_crc32c", "safetensors", "click", "etils"}


def _port_files():
    return (sorted((ROOT / "progen_tpu_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_parallel_worker.py"])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_scan_sees_the_whole_port():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "progen_tpu_torch/models/progen.py" in names
    assert "progen_tpu_torch/ops/cuda_attention.py" in names
    assert "progen_tpu_torch/train/step.py" in names
    assert "progen_tpu_torch/train/cli.py" in names
    for new in ("decode/engine.py", "decode/rng.py", "decode/paging.py", "decode/qos.py",
                "ops/quant.py", "ops/paged_gate_mix.py", "ops/cuda_paged_gate_mix.py",
                "resilience/faults.py", "resilience/retry.py", "observe/robustness.py",
                "data/tfrecord.py", "data/prefetch.py", "data/fasta.py", "generate_data.py",
                "checkpoint/store.py", "observe/meter.py", "observe/tracker.py",
                "resilience/watchdog.py", "train/trainer.py", "train/lora.py",
                "workloads/__init__.py", "workloads/lora.py", "workloads/infill.py",
                "core/mesh.py", "parallel/__init__.py", "parallel/sharding.py",
                "parallel/context.py", "observe/metrics.py", "observe/trace.py",
                "observe/statusz.py", "observe/__init__.py", "compat/reference.py",
                "convert_checkpoint.py", "train/memory.py", "parallel/tensor.py",
                "parallel/decode.py", "serve/__init__.py", "serve/transport.py",
                "serve/router.py", "serve/worker.py", "serve/cluster.py",
                "observe/transport.py", "observe/slo.py", "resilience/supervise.py",
                "serve/policy.py", "serve/control.py", "analysis/engine.py",
                "analysis/capturegraph.py", "analysis/rules_kernel.py",
                "observe/gitinfo.py", "observe/platform.py"):
        assert f"progen_tpu_torch/{new}" in names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_ANALYSIS = sorted((ROOT / "progen_tpu_torch" / "analysis").glob("*.py"))


@pytest.mark.parametrize("path", _ANALYSIS, ids=lambda p: p.name)
def test_the_analyzer_imports_only_the_stdlib(path):
    """``progen_tpu_torch.analysis`` is pure stdlib: no torch, no numpy,
    no JAX, nothing of either package but its own modules."""
    assert len(_ANALYSIS) >= 14
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            # ``from progen_tpu_torch import analysis`` names the submodule
            names = [f"{node.module}.{a.name}" if node.module == "progen_tpu_torch"
                     else node.module for a in node.names]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root == "progen_tpu_torch":
                assert name.startswith("progen_tpu_torch.analysis"), name
            else:
                assert root in sys.stdlib_module_names, name


def test_the_analyzer_loads_no_framework():
    """Run in a fresh interpreter, the CLI's imports and a whole run load
    no torch, numpy or JAX module (the package's ``__init__`` imports the
    model lazily)."""
    code = ("import sys; "
            "from progen_tpu_torch.analysis import __main__ as cli; "
            "rc = cli.main(['--rules', 'host-sync,kernel-status', "
            "'progen_tpu_torch/ops/cuda_sgu.py']); "
            "print(rc, sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'numpy', 'jax', 'jaxlib', 'progen_tpu', 'flax'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "0 []"


def test_scan_catches_a_jax_package_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("from progen_tpu.ops import sgu\nimport progen_tpu_torch\n")
    assert set(_imported_roots(f)) & FORBIDDEN == {"progen_tpu"}


def test_sample_cli_prints_samples_on_cpu(capsys):
    texts = sample.main(["--config", "default", "--seed", "0", "--prime", "MKV",
                         "--num_samples", "2", "--top_k", "25",
                         "--seq_len", "40", "--chunk", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(texts) == 2
    assert out.count("MKV") == 2 and out.count("*" * 40) == 2
    assert all(len(t) <= 40 - 4 for t in texts)
    again = sample.main(["--config", "default", "--seed", "0", "--prime", "MKV",
                         "--num_samples", "2", "--seq_len", "40", "--chunk", "8",
                         "--device", "cpu"])
    assert again == texts  # seeded weights and noise


def test_sample_cli_records_a_profile_of_the_decode(tmp_path, capsys):
    """``--xprof_dir``: a ``torch.profiler`` trace of the decode, the
    samples unchanged."""
    argv = ["--config", "default", "--seed", "0", "--prime", "MKV", "--seq_len", "24",
            "--chunk", "8", "--device", "cpu"]
    texts = sample.main(argv + ["--xprof_dir", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert sample.main(argv) == texts


def test_sample_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample.main(["--config", "default", "--prime", "MKV"])


SERVE = ["--serve", "--config", "default", "--seed", "0", "--prime", "MKV|MALWTR|M",
         "--top_k", "25", "--seq_len", "24", "--slots", "2", "--chunk", "4"]


@pytest.mark.parametrize("mode", [[], ["--paged", "--page_size", "4"],
                                  ["--paged", "--page_size", "4", "--quantize",
                                   "weights+pages"]],
                         ids=["dense", "paged", "paged_q8"])
def test_serve_cli_answers_every_prime_on_cpu(capsys, mode):
    records = sample.main(SERVE + mode + ["--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == records and [r["uid"] for r in records] == [0, 1, 2]
    assert [r["prime"] for r in records] == ["MKV", "MALWTR", "M"]
    for r in records:
        assert r["status"] == "ok" and r["finish_reason"] in ("eos", "length")
        assert 1 <= len(r["tokens"]) <= 24 - len(r["prime"]) - 1
    if not mode:  # seeded weights and per-request keys: the same again, paged too
        capsys.readouterr()
        again = sample.main(SERVE + ["--paged", "--page_size", "4", "--device", "cpu"])
        assert [r["tokens"] for r in again] == [r["tokens"] for r in records]


def test_serve_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sample.main(SERVE)


def test_train_cli_takes_steps_on_cpu():
    """``python -m progen_tpu_torch.train`` on the CPU: two steps of the
    default config, one JSON line each."""
    run = subprocess.run(
        [sys.executable, "-m", "progen_tpu_torch.train", "--model_name", "default",
         "--batch_size", "1", "--grad_accum_every", "1", "--max_steps", "2",
         "--log_every", "1", "--device", "cpu"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300, check=True)
    records = [json.loads(line) for line in run.stdout.splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    for r in records:
        assert set(r) == {"step", "loss", "grad_norm", "lr", "step_ms",
                          "tokens_per_s", "mfu"}
        assert 0 < r["loss"] < 10 and r["grad_norm"] > 0
        assert r["lr"] == 2e-4 and r["mfu"] is None  # no device number on the CPU


def test_train_cli_takes_supersteps_with_remat_on_cpu():
    """``--superstep 2 --remat`` on the CPU: four micro-batches in two
    spans of two optimizer steps, one JSON line per span; the losses are
    the per-step run's."""
    def run(*extra):
        out = subprocess.run(
            [sys.executable, "-m", "progen_tpu_torch.train", "--model_name", "default",
             "--batch_size", "1", "--grad_accum_every", "1", "--max_steps", "4",
             "--log_every", "1", "--device", "cpu", *extra],
            cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1"},
            capture_output=True, text=True, timeout=300, check=True)
        return [json.loads(line) for line in out.stdout.splitlines()]

    fused = run("--superstep", "2", "--remat", "--remat_policy", "attn")
    assert [r["step"] for r in fused] == [2, 4]
    per_step = {r["step"]: r["loss"] for r in run()}
    assert [r["loss"] for r in fused] == [per_step[2], per_step[4]]


@pytest.mark.parametrize("flags,project,use_wandb,profile_dir", [
    ([], "progen-training", True, None),
    (["--wandb_off", "--wandb_project_name", "mine", "--profile_dir", "prof"],
     "mine", False, "prof")])
def test_train_cli_takes_the_wandb_and_profile_flags(tmp_path, monkeypatch, flags,
                                                      project, use_wandb, profile_dir):
    """``--wandb_off``, ``--wandb_project_name`` (JAX's default
    ``progen-training``) reach the Tracker and ``--profile_dir`` the
    TrainerConfig, as ``train.py:224-228`` hands them on."""
    seen = {}

    class FakeTracker:
        def __init__(self, **kwargs):
            seen["tracker"] = kwargs

        def finish(self):
            pass

    class FakeTrainer:
        def __init__(self, model_config, cfg, *args, **kwargs):
            seen["cfg"] = cfg

        def run(self):
            return {}

        def close(self):
            pass

    monkeypatch.setattr(train_cli, "Tracker", FakeTracker)
    monkeypatch.setattr(train_cli, "Trainer", FakeTrainer)
    train_cli.main(["--data_path", str(tmp_path), "--checkpoint_path", str(tmp_path / "ck"),
                    "--config_path", str(ROOT / "configs" / "model"), "--device", "cpu",
                    *flags])
    assert seen["tracker"]["project"] == project
    assert seen["tracker"]["use_wandb"] is use_wandb
    assert seen["cfg"].profile_dir == profile_dir


def test_train_cli_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--model_name", "default", "--max_steps", "1"])


@pytest.mark.parametrize("phases", [["train"], ["serve", "engine"]])
def test_trace_needs_a_card(monkeypatch, phases):
    from progen_tpu_torch import trace_main_path
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_main_path.main(["--phases", *phases])


def test_trace_refuses_an_unknown_phase():
    from progen_tpu_torch import trace_main_path
    with pytest.raises(SystemExit):
        trace_main_path.main(["--phases", "decode_only"])


# ------------------------------------------------- the serving fleet's copies


def _counters_script(mod):
    a, b = mod.TransportCounters(), mod.TransportCounters()
    a.sent(100), a.sent(7), b.received(40)
    b.crc_failures += 2
    b.desyncs += 1
    b.ser_s, b.de_s = 0.25, 0.5
    a.merge(b)
    a.merge({"frames_in": 3, "bytes_in": 9, "de_s": 1.0})
    return [a.as_dict(), b.as_dict()]


def _supervisor_script(mod, monkeypatch):
    clock = iter(float(t) for t in range(0, 1000, 5))
    monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
    seen = []
    sup = mod.StageSupervisor(max_restarts=2, min_interval_s=7.0)
    for role, idx in [("prefill", 0), ("prefill", 0), ("decode", 1), ("prefill", 0),
                      ("prefill", 0), ("decode", 1), ("decode", 1)]:
        seen.append(sup.request_restart(role, idx, "eof"))
    sup.forget("decode", 1)
    seen.append(sup.restarts_used("decode", 1))
    seen.append(sup.request_restart("decode", 1))
    seen.append(sup.stats())
    seen.append([(e.role, e.index, e.granted, e.reason) for e in sup.events])
    try:
        mod.StageSupervisor(max_restarts=-1)
    except ValueError as e:
        seen.append(str(e))
    return seen


def _router_script(mod, paging):
    """One scripted life of the router: placement with priorities, cache
    scoring on advertised and optimistic digests, credits, failures,
    membership and generations."""
    from progen_tpu_torch.decode.engine import Request

    seen = []
    rt = mod.Router(2, 3, digest_ttl=5.0, cache_imbalance_tokens=16)
    reqs = {i: Request(uid=i, tokens=[1 + (i % 3)] * 8 + [i], max_new_tokens=4 + i,
                       priority=i % 3) for i in range(10)}
    for i in range(6):
        w = rt.pick_prefill(priority=reqs[i].priority)
        rt.assign_prefill(i, reqs[i], w, now=float(i))
        seen.append(("place", i, w))
    digest = {"page_size": 4, "free": 3, "cached": 2, "capacity": 9,
              "keys": [[8, 4, paging.token_span_digest(reqs[0].tokens, 4), 2],
                       [8, 8, paging.token_span_digest(reqs[0].tokens, 8), 1]]}
    rt.note_digest(1, digest, now=10.0)
    rt.note_handle("0.0:0", [0, 3], src=0)
    seen.append(("pick", rt.pick_replica(0, tokens_batch=[reqs[0].tokens], now=11.0)))
    rt.forward("0.0:0", 1, now=11.0)
    rt.note_handle("1.0:0", [1, 4], src=1)
    seen.append(("pick", rt.pick_replica(0, tokens_batch=[reqs[1].tokens], now=12.0)))
    rt.forward("1.0:0", 2, now=12.0)
    seen.append(("stale", rt.pick_replica(0, tokens_batch=[reqs[0].tokens], now=40.0)))
    seen.append(("ack", rt.ack("0.0:0"), rt.ack("0.0:0"), rt.unacked_batches(2)))
    seen.append(("complete", rt.complete(0), rt.complete(0), rt.complete("nope")))
    seen.append(("fail", rt.fail_worker("decode", 2), rt.fail_worker("prefill", 1)))
    seen.append(("requeue", rt.requeue([3, 5, 99])))
    rt.revive_worker("prefill", 1)
    rt.add_worker("decode", 7, generation=1)
    rt.fence_worker("decode", 0)
    seen.append(("gen", rt.pick_replica(1), rt.pick_replica(0), rt.generation_of(4)))
    rt.assign_prefill(6, reqs[6], rt.pick_prefill(priority=2), now=20.0)
    seen.append(("uids", rt.uids_on("prefill", 0), rt.uids_on("prefill", 1),
                 rt.generation_in_flight(0), rt.queued_by_class()))
    seen.append(("summary", rt.cache_summary(now=13.0)))
    rt.retire_worker("decode", 1)
    seen.append(("stats", rt.stats()))
    return seen


def _serve_transport_script(mod, handoff):
    """Frames over a socket pair: sent, received, peeked; a reader thread's
    events; a short read and a bad header."""
    import queue
    import socket

    seen = []
    a, b = socket.socketpair()
    try:
        frame = handoff.pack_frame({"type": "hello", "index": 3}, [b"xyz"])
        mod.send_frame(a, frame)
        got = mod.recv_frame(b)
        seen.append((got == frame, mod.peek_header(got)))
        try:
            mod.peek_header(frame[:30] + b"!" + frame[31:])
        except handoff.FrameDesync as e:
            seen.append(("desync", str(e)))
        peer = mod.Peer(b)
        events = queue.Queue()
        peer.start_reader(events)
        mod.send_frame(a, handoff.pack_frame({"type": "hb"}))
        a.sendall(frame[:10])
        a.shutdown(socket.SHUT_WR)
        ev1, ev2 = events.get(timeout=10), events.get(timeout=10)
        seen.append((ev1[0], ev1[2], ev2[0], ev2[2], peer.name, peer.alive))
    finally:
        a.close()
        b.close()
    return seen


def _slo_script(mod, metrics):
    reg = metrics.MetricsRegistry()
    lat = reg.histogram("cluster.latency_s")
    ok, shed = reg.counter("cluster.completions_ok"), reg.counter("cluster.completions_shed")
    tr = mod.BurnRateTracker((mod.SLOSpec(name="p95", target=0.95, threshold_s=0.5),
                              mod.SLOSpec(name="goodput", target=0.99, kind="ratio")),
                             windows=(10.0, 60.0), registry=reg)
    out = [tr.evaluate(0.0)]
    for t in range(0, 40, 4):
        for v in (0.1, 0.2, 0.7 + t / 100):
            lat.observe(v)
        ok.inc(3)
        shed.inc(t % 8 == 0)
        tr.sample(float(t), reg.snapshot())
    out.append(tr.evaluate(40.0))
    out.append(mod.burn_rate(0.9, 0.95))
    out.append(mod.frac_within(lat.snapshot(), 0.3))
    return out


def test_copied_transport_counters_behave_as_the_original():
    from progen_tpu.observe import transport as jax_mod
    from progen_tpu_torch.observe import transport as mod
    assert _counters_script(mod) == _counters_script(jax_mod)


def test_copied_supervisor_behaves_as_the_original(monkeypatch):
    from progen_tpu.resilience import supervise as jax_mod
    from progen_tpu_torch.resilience import supervise as mod
    assert _supervisor_script(mod, monkeypatch) == _supervisor_script(jax_mod, monkeypatch)


def test_copied_router_behaves_as_the_original():
    from progen_tpu.decode import paging as jax_paging
    from progen_tpu.serve import router as jax_mod
    from progen_tpu_torch.decode import paging
    from progen_tpu_torch.serve import router as mod
    assert _router_script(mod, paging) == _router_script(jax_mod, jax_paging)


def test_copied_socket_transport_behaves_as_the_original():
    from progen_tpu.decode import handoff as jax_handoff
    from progen_tpu.serve import transport as jax_mod
    from progen_tpu_torch.decode import handoff
    from progen_tpu_torch.serve import transport as mod
    assert _serve_transport_script(mod, handoff) == \
        _serve_transport_script(jax_mod, jax_handoff)
    assert mod.MAX_FRAME_BYTES == jax_mod.MAX_FRAME_BYTES


def test_copied_slo_behaves_as_the_original():
    from progen_tpu.observe import metrics as jax_metrics
    from progen_tpu.observe import slo as jax_mod
    from progen_tpu_torch.observe import metrics
    from progen_tpu_torch.observe import slo as mod
    assert _slo_script(mod, metrics) == _slo_script(jax_mod, jax_metrics)


def _policy_script(mod):
    pol = mod.BurnRatePolicy(min_prefill=1, max_prefill=3, min_replicas=1,
                             max_replicas=2, cooldown_s=2.0)
    out = [pol.config()]
    for t in range(12):
        inputs = mod.PolicyInputs(
            now=float(t), prefill_workers=1 + t % 3, decode_replicas=1 + t % 2,
            burn_rates={"p95": [0.1, 3.0, 1.0, float("inf")][t % 4]},
            prefill_queue={0: t % 5}, replica_outstanding={0: 9 - t}, queued_uids=t % 2)
        out.append([(d.action, d.role, d.cause, d.observed, d.threshold)
                    for d in pol.decide(inputs)])
    return out


def test_copied_policy_behaves_as_the_original():
    from progen_tpu.serve import policy as jax_mod
    from progen_tpu_torch.serve import policy as mod
    assert _policy_script(mod) == _policy_script(jax_mod)


# ------------------------------------------- the fleet's elastic verbs, tp groups


def _bare():
    """A fleet of fake peers (prefill 0 and 1, decode 0) whose spawns are
    recorded, with a spec file of its own."""
    import tempfile

    from tests.test_torch_serve_multiproc import _bare_cluster

    c = _bare_cluster(prefill=2, replicas=1)
    c.spawned = []
    c._spawn = lambda role, idx, group=None: c.spawned.append((role, idx))
    c._tmp = tempfile.TemporaryDirectory()
    c.log_dir = Path(c._tmp.name)
    c._spec_path = Path(c._tmp.name) / "spec.json"
    c.spec = {"engine": {"paged": True}}
    c._spec_path.write_text(json.dumps(c.spec))
    c._spec_paths = {0: c._spec_path}
    return c


def _request(uid):
    from progen_tpu_torch.decode.engine import Request
    return Request(uid=uid, tokens=[1, 2, 3], max_new_tokens=4)


def _verb_begin_generation(c):
    gen = c.begin_generation({"engine": {"paged": True}, "init_seed": 1})
    assert gen == 1 and c.generation == 1
    assert json.loads(c._spec_paths[1].read_text())["init_seed"] == 1
    assert c._worker_gen[("prefill", 0)] == 0  # running workers keep theirs


def _verb_add_worker(c):
    idx = c.add_worker("prefill")
    assert idx == 2 and c.spawned == [("prefill", 2)] and c.prefill_procs == 3
    assert ("prefill", 2) in c._pending_routable        # not routable yet
    assert 2 not in c.router.prefill_alive
    warm = json.loads(c._worker_spec[("prefill", 2)].read_text())
    assert warm["aot_warmup"] is True and warm["engine"] == {"paged": True}
    assert c.add_worker("decode") == 1 and c.replicas == 2


def _verb_wait_routable(c):
    from tests.test_torch_serve_multiproc import _FakePeer

    idx = c.add_worker("decode")
    peer = _FakePeer("decode", idx)
    c._events.put(("frame", peer, {"type": "ready", "build_s": 1.0}, b""))
    c.wait_routable("decode", idx, timeout=5.0)
    assert ("decode", idx) not in c._pending_routable
    assert idx in c.router.replica_alive and c.router.replica_gen[idx] == 0
    c.add_worker("prefill")
    with pytest.raises(RuntimeError, match="not routable"):
        c.wait_routable("prefill", 2, timeout=0.05)


def _verb_fence_worker(c):
    c.fence_worker("prefill", 0)
    c.submit(_request(0))
    c.submit(_request(1))
    assert c._peers[("prefill", 0)].reqs() == []          # fenced: no new work
    assert len(c._peers[("prefill", 1)].reqs()) == 2


def _verb_retire_worker(c):
    c.submit(_request(0))                                 # prefill 0 holds uid 0
    peer = c._peers[("prefill", 0)]
    c._events.put(("dead", peer, "eof"))                  # its planned exit
    c.retire_worker("prefill", 0, timeout=5.0)
    assert {"type": "shutdown"} in peer.sent
    assert c.prefill_procs == 1 and 0 not in c.router.prefill_alive
    assert c._retiring == set() and ("prefill", 0) not in c._worker_gen
    assert [m["req"]["uid"] for m in c._peers[("prefill", 1)].reqs()] == [0]  # replayed
    assert c.completions == {}                            # zero sheds


def _verb_finalize_retire(c):
    c.submit(_request(0))
    c.supervisor.request_restart("prefill", 0, "eof")
    c._retiring.add(("prefill", 0))
    c._finalize_retire("prefill", 0)
    assert c.supervisor.stats()["restarts"].get("prefill:0") is None  # forgotten
    assert c.prefill_procs == 1 and c._retiring == set()
    assert [m["req"]["uid"] for m in c._peers[("prefill", 1)].reqs()] == [0]


def _verb_submit_embed(c):
    r = _request(5)
    c.submit_embed(r)
    sent = [m for p in c._peers.values() for m in p.sent if m.get("type") == "embed_req"]
    assert r.workload == "embed" and [m["req"]["uid"] for m in sent] == [5]


@pytest.mark.parametrize("verb", ["begin_generation", "add_worker", "wait_routable",
                                  "fence_worker", "retire_worker", "_finalize_retire",
                                  "submit_embed"])
def test_the_fleets_elastic_verbs_keep_jax_bookkeeping(verb):
    """Each elastic verb of ``ServeCluster`` does the JAX cluster's
    bookkeeping on a fleet of fake peers (no process starts)."""
    c = _bare()
    try:
        globals()[f"_verb{verb if verb.startswith('_') else '_' + verb}"](c)
    finally:
        c._tmp.cleanup()


def test_tp_group_checks_the_models_tensor_dims(tmp_path):
    """``ServeCluster(tp_group=G)`` refuses a ``G`` that does not divide the
    model's tensor-split dims before any process starts; a member's engine
    is built only inside its group's process group."""
    from progen_tpu_torch.models import ProGenConfig
    from progen_tpu_torch.serve import worker
    from progen_tpu_torch.serve.cluster import ServeCluster

    spec = worker.make_spec(ProGenConfig(num_tokens=32, dim=24, seq_len=24, depth=1,
                                         window_size=4, global_mlp_depth=1, heads=3,
                                         dim_head=8, ff_mult=2), device="cpu")
    with pytest.raises(ValueError, match="tensor axis size 2 does not divide"):
        ServeCluster(spec, tp_group=2, log_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())  # nothing spawned
    with pytest.raises(RuntimeError, match="join it first"):
        worker.build_engine_from_spec(worker.make_spec(ProGenConfig(), device="cpu"),
                                      group_size=2)


@pytest.mark.parametrize("flag,want", [
    ([], {}),
    (["--autoscale"], {}),
    (["--min_prefill", "2", "--max_prefill", "4"], {"min_prefill": 2, "max_prefill": 4}),
    (["--max_prefill", "5"], {"max_prefill": 5}),
    (["--min_replicas", "2", "--max_replicas", "4"], {"min_replicas": 2, "max_replicas": 4}),
    (["--max_replicas", "6"], {"max_replicas": 6}),
    (["--swap_at", "3"], {})])
def test_sample_parses_the_elastic_flags_to_jax_bounds(flag, want):
    """Each elastic flag parses to the ``BurnRatePolicy`` bounds the JAX CLI
    builds (``sample.py:320-324``: floors default to the starting fleet,
    ceilings to two above it), or to ``swap_at``."""
    from progen_tpu.serve.policy import BurnRatePolicy as JaxPolicy

    args = sample.parse_args(["--serve", "--serve_procs", "--prefill_procs", "2",
                              "--replicas", "1", *flag, "--device", "cpu"])
    jax_kw = dict(min_prefill=2, max_prefill=4, min_replicas=1, max_replicas=3)
    jax_kw.update(want)
    assert sample.fleet_policy(args).config() == JaxPolicy(**jax_kw).config()
    assert args.autoscale == ("--autoscale" in flag)
    assert args.swap_at == (3 if "--swap_at" in flag else None)


def test_the_elastic_flags_need_the_fleet(capsys):
    for flag in (["--autoscale"], ["--swap_at", "2"], ["--max_replicas", "3"]):
        with pytest.raises(SystemExit):
            sample.main(["--serve", *flag, "--device", "cpu"])
        assert "add --serve --serve_procs" in capsys.readouterr().err


def test_sample_fleet_swaps_weights_and_autoscales(capsys):
    """``--serve --serve_procs --autoscale --swap_at 1``: the fleet rolls to
    generation 1 after the first completion, prints each control decision
    as a JSON line, and answers with the in-process engine's tokens (the
    new generation is the same weights); the later requests carry
    generation 1."""
    argv = SERVE + ["--paged", "--page_size", "4", "--device", "cpu"]
    strip = lambda rows: [{k: v for k, v in r.items()
                           if k not in ("latency_s", "generation")} for r in rows]
    local = sample.main(argv + ["--disagg"])
    capsys.readouterr()
    fleet = sample.main(argv + ["--serve_procs", "--autoscale", "--swap_at", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    events = [line["control"]["event"] for line in lines if "control" in line]
    assert events.index("swap_begin") < events.index("swap_done")
    assert set(events) <= {"swap_begin", "swap_roll", "swap_done", "scale_up", "scale_down"}
    assert strip(fleet) == strip(local) and all(r["status"] == "ok" for r in fleet)
    assert {r["generation"] for r in fleet} <= {0, 1} and fleet[0]["generation"] == 0


def test_sample_embeds_through_the_fleet(capsys):
    """``--serve --serve_procs --embed``: the prefill workers answer each
    prime's embedding (``ServeCluster.submit_embed``), equal to the
    in-process engine's."""
    argv = SERVE + ["--embed", "--device", "cpu"]
    local = sample.main(argv)
    fleet = sample.main(argv + ["--serve_procs"])
    capsys.readouterr()
    assert [r["uid"] for r in fleet] == [0, 1, 2] and all(r["status"] == "ok" for r in fleet)
    for a, b in zip(fleet, local):
        assert torch.allclose(torch.tensor(a["embedding"]), torch.tensor(b["embedding"]),
                              rtol=1e-5, atol=1e-6)


def test_a_cuda_worker_without_a_card_exits_nonzero(tmp_path):
    """A worker told ``cuda`` on a machine without a card exits nonzero: it
    never falls back to the CPU on its own."""
    from progen_tpu_torch.models import ProGenConfig
    from progen_tpu_torch.serve.cluster import ServeCluster
    from progen_tpu_torch.serve.worker import make_spec

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    spec = make_spec(ProGenConfig(num_tokens=32, dim=16, seq_len=24, depth=1,
                                  window_size=4, global_mlp_depth=1, heads=2,
                                  dim_head=8, ff_mult=2), device="cuda")
    with pytest.raises(RuntimeError, match="exited rc=1 before hello"):
        ServeCluster(spec, log_dir=str(tmp_path), spawn_timeout=120.0)
    assert "no CUDA device" in "".join(p.read_text() for p in tmp_path.glob("*.log"))


def test_sample_serve_procs_prints_the_disagg_engines_lines(capsys):
    """``--serve --serve_procs --device cpu``: a one-prefill, one-replica
    fleet prints the JSON lines of ``--serve --disagg``, latencies aside."""
    argv = SERVE + ["--paged", "--page_size", "4", "--device", "cpu"]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "latency_s"} for r in rows]
    local = sample.main(argv + ["--disagg"])
    local_lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    fleet = sample.main(argv + ["--serve_procs", "--prefill_procs", "1", "--replicas", "1"])
    fleet_lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert fleet_lines == fleet and local_lines == local
    assert strip(fleet) == strip(local) and [r["uid"] for r in fleet] == [0, 1, 2]
    assert all(r["status"] == "ok" for r in fleet)
