"""Where the serving and training paths' time goes on the card.

    python -m progen_tpu_torch.trace_main_path [--phases serve engine train]

Runs ProGen-small (weights from seed 0, bf16 compute) through one prefill of
a batch of 2 primes of 300 residues + BOS and 64 cached decode steps, after
two warm-ups of both; then one decode chunk (32 steps) of the
``ServingEngine`` with 8 slots, all live, after 8 primes of 300 residues +
BOS were admitted and two warm-up chunks, dense, paged and paged with 8-bit
pages; then training steps at batch 8 on synthetic rows (f32 parameters),
after two warm-up steps.  Each phase runs five times bare,
timed on the host clock (ended by a synchronize), then five times under
``torch.profiler`` with CPU and CUDA activity, whose device-side kernel
events give the device busy time (their summed durations; one stream, so
they do not overlap) and the launch count.  Prints one JSON line per phase:
the medians and ranges of the wall time, the device busy time and the
launches, the idle share ``1 - busy / wall``, the device time by kind (the
port's kernels, matrix products, everything else), the kernels that took
the most device time and each of the port's kernels.  ``--phases`` picks the parts to run (``serve``: the
prefill and the decode steps; ``engine``: the three engine chunks;
``spec``: one speculative chunk, six rounds of ``spec_k`` 4, dense with
the identity draft and paged with a ``draft_config_for`` draft, per round
and per emitted token beside the per-step numbers; ``train``: the train
step; ``mesh``: the train step without a mesh and on a mesh of one rank
under each set of ``--strategies`` (``dp`` and ``fsdp`` by default; ``tp``,
``fsdp,tp``, ``dp,tp,sp`` ...), in f32 and in bf16 compute), all but
``spec`` and ``mesh`` by default.
With ``--aot_warmup`` each engine chunk is traced twice, eager and then
warmed (``ServingEngine.aot_warmup``: the chunk one captured CUDA graph,
replayed), each line with ``host_launches``: the CUDA runtime calls the
host made that put work on the device (kernel and graph launches, copies,
memsets), a step's and a round's beside the device's kernels.  Every line
also has ``event_span_ms``, the stream's span between CUDA events around a
bare run (the device's busy and idle time together).
With ``--superstep K`` the train step is traced twice, eager and then
captured (``train_multi_step``: one captured optimizer step replayed K
times a traced run), each line per optimizer step; under ``mesh`` the
meshed step too (its collectives inside the graph).
Every line carries the ``git_sha`` and ``wall_time`` stamps
(``observe.platform.stamp_record``).  Needs a GPU.

    python -m progen_tpu_torch.trace_main_path --phases engine spec --aot_warmup
    python -m progen_tpu_torch.trace_main_path --phases train --superstep 4
    python -m progen_tpu_torch.trace_main_path --phases mesh --strategies fsdp tp \
        fsdp,tp --superstep 4
"""

from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed, make_mesh
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.prefill import pad_prime_length
from progen_tpu_torch.decode.sampler import make_chunked_sampler
from progen_tpu_torch.models.configs import SMALL, draft_config_for
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.observe.platform import stamp_record
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import make_train_functions

PRIME_LEN = 300
STEPS = 64
TRAIN_BATCH = 8
ENGINE_SLOTS = 8
ENGINE_CHUNK = 32
SPEC_K = 4
REPEATS = 5  # rounds per phase: host-clock walls vary from run to run
# kernel-name fragments of the port's own kernels and of cuBLAS's products
PORT_KERNELS = ("local_attention_", "sgu_", "paged_gate_mix")
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")
# the CUDA runtime and driver calls that put work on the device
HOST_LAUNCHES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                 "cudaMemcpy", "cudaMemset")


def _kind(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port_kernels"
    if any(k in name.lower() for k in MATMUL_KERNELS):
        return "matmul"
    return "other"


def _wall_ms(fn, device) -> tuple[float, float]:
    """Host-clock ms of ``fn`` ended by a synchronize, and the device's span
    of its stream between two CUDA events (busy and idle)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3, start.elapsed_time(end)


def _profiled(fn, device) -> tuple[dict[str, list], int]:
    """One run under the profiler: its device kernels' ``{name: [calls,
    us]}`` and the host's launching runtime calls (``HOST_LAUNCHES``)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    per_name: dict[str, list] = {}
    host = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = per_name.setdefault(e.name, [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
        elif e.name.startswith(HOST_LAUNCHES):
            host += 1
    return per_name, host


def _median_and_range(values) -> tuple[float, list]:
    return float(np.median(values)), [min(values), max(values)]


def _traced(fn, device, repeats: int = REPEATS) -> dict:
    """``repeats`` bare runs on the host clock, then ``repeats`` runs under
    the profiler (kept apart, so that no bare run pays for the profiler's
    teardown): medians with their ``[min, max]`` range.  The idle share is
    ``1 - median busy / median wall``; its range takes the walls' range.
    The by-kind split and the top kernels come from the profiled run of
    median device time."""
    walls, spans = zip(*(_wall_ms(fn, device) for _ in range(repeats)))
    rounds, hosts = zip(*(_profiled(fn, device) for _ in range(repeats)))
    busy = [sum(us for _, us in r.values()) / 1e3 for r in rounds]
    out = {}
    out["wall_ms"], out["wall_ms_range"] = _median_and_range(walls)
    out["event_span_ms"], out["event_span_ms_range"] = _median_and_range(spans)
    out["device_busy_ms"], out["device_busy_ms_range"] = _median_and_range(busy)
    out["idle_share"] = 1.0 - out["device_busy_ms"] / out["wall_ms"]
    out["idle_share_range"] = [1.0 - out["device_busy_ms"] / w for w in out["wall_ms_range"]]
    out["device_launches"], out["device_launches_range"] = _median_and_range(
        [sum(n for n, _ in r.values()) for r in rounds])
    out["host_launches"], out["host_launches_range"] = _median_and_range(hosts)
    out["repeats"] = repeats
    per_name = rounds[int(np.argsort(busy)[repeats // 2])]
    by_kind: dict[str, float] = {}
    for name, (_, us) in per_name.items():
        by_kind[_kind(name)] = by_kind.get(_kind(name), 0.0) + us / 1e3
    top = sorted(per_name.items(), key=lambda kv: kv[1][1], reverse=True)
    out["device_ms_by_kind"] = by_kind
    out["top"] = [{"name": name[:80], "calls": n, "device_ms": us / 1e3}
                  for name, (n, us) in top[:10]]
    out["port_kernels"] = [{"name": name[:80], "calls": n, "device_ms": us / 1e3}
                           for name, (n, us) in top if _kind(name) == "port_kernels"]
    return out


PHASES = ("serve", "engine", "spec", "train", "mesh")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", nargs="+", choices=PHASES,
                        default=["serve", "engine", "train"])
    parser.add_argument("--aot_warmup", action="store_true",
                        help="trace each engine chunk eager and then warmed "
                             "(one captured CUDA graph)")
    parser.add_argument("--superstep", type=int, default=1,
                        help="trace the train step eager and as K replays of the "
                             "captured optimizer step (train_multi_step)")
    parser.add_argument("--strategies", nargs="+", default=["dp", "fsdp"],
                        help="the mesh phase's strategy sets, each comma separated "
                             "(e.g. dp fsdp tp fsdp,tp dp,tp,sp)")
    args = parser.parse_args(argv)
    phases = args.phases
    device = resolve_device("cuda")
    config = SMALL
    if {"serve", "engine", "spec"} & set(phases):
        _trace_serving(device, config, phases, args.aot_warmup)
    if "train" in phases:
        _trace_train(device, config, superstep=args.superstep)
    if "mesh" in phases:
        _trace_mesh(device, config, tuple(tuple(s.split(",")) for s in args.strategies),
                    args.superstep)


def _trace_serving(device, config, phases, aot_warmup: bool = False) -> None:
    model = ProGen(config, make_policy(), device=device, seed=0).eval()
    sampler = make_chunked_sampler(model)
    rng = np.random.default_rng(0)
    p_len = PRIME_LEN + 1
    p_pad = pad_prime_length(p_len, config.window_size, config.seq_len)
    tokens = torch.tensor(rng.integers(1, config.num_tokens, size=(2, p_pad)),
                          device=device)
    lengths = torch.full((2,), p_len, device=device)
    decode_len = p_len + STEPS

    def prefill():
        return sampler.prefill(tokens, lengths, decode_len)

    def decode(caches):
        tok = tokens[:, 0]
        for pos in range(p_len, decode_len):
            sampler.step(tok, pos, caches)

    for _ in range(2):  # warm-up: cuBLAS handles, allocator, kernel builds
        _, caches = prefill()
        decode(caches)
    _, caches = prefill()
    meta = {"config": "small", "batch": 2, "prime_len": p_len,
            "p_pad": p_pad, "device": torch.cuda.get_device_name(device)}
    if "serve" in phases:
        print(json.dumps(stamp_record({"phase": "prefill", **meta,
                                       **_traced(prefill, device)})), flush=True)
        steps = decode_len - p_len
        result = _traced(lambda: decode(caches), device)
        result["per_step_wall_ms"] = result["wall_ms"] / steps
        result["per_step_device_ms"] = result["device_busy_ms"] / steps
        print(json.dumps(stamp_record({"phase": "decode", **meta, "steps": steps, **result})),
              flush=True)
    del sampler, caches
    modes = []
    if "engine" in phases:
        modes += [("dense", {}), ("paged", {"paged": True}),
                  ("paged_q8", {"paged": True, "quantize": "weights+pages"})]
    if "spec" in phases:
        draft = ProGen(draft_config_for(config), make_policy(), device=device,
                       seed=0).eval()
        modes += [("spec_identity", {"spec": True, "spec_k": SPEC_K}),
                  ("spec_draft_paged", {"paged": True, "spec": True, "spec_k": SPEC_K,
                                        "draft_params": draft})]
    for mode, kwargs in modes:
        primes = [[0] + rng.integers(1, config.num_tokens, PRIME_LEN).tolist()
                  for _ in range(ENGINE_SLOTS)]
        for dispatch in ("eager", "warmed") if aot_warmup else ("eager",):
            # a fresh engine each: both traces start from the same positions
            engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                                   max_len=config.seq_len, page_size=16, **kwargs)
            extra = {}
            if dispatch == "warmed":
                t0 = time.perf_counter()
                extra["aot_warmup"] = engine.aot_warmup()
                extra["aot_warmup_wall_s"] = time.perf_counter() - t0
            for i, tokens in enumerate(primes):
                # budgets no row can exhaust within the traced chunks; half the
                # rows greedy, half top-k 25 at temperature 1
                engine.submit(Request(
                    uid=i, tokens=tokens, max_new_tokens=700, top_k=25 if i % 2 else None,
                    temperature=1.0 if i % 2 else 0.0, seed=i))
            engine._admit_pending()
            for _ in range(2):  # warm-up
                engine._dispatch_chunk()
            result = _trace_chunk(engine, device)
            live = int((engine.state["active"] & ~engine.state["done"]).sum())
            print(json.dumps(stamp_record({
                "phase": "engine_chunk", "mode": mode, "dispatch": dispatch,
                "config": "small", "slots": ENGINE_SLOTS, "live_rows_at_end": live,
                "prime_len": p_len, "device": meta["device"], **extra, **result})),
                flush=True)
            engine.close()
            del engine
            gc.collect()


def _trace_chunk(engine, device) -> dict:
    """One engine chunk, traced (``_traced``), per target step and, under
    speculation, per round and per emitted token."""
    before = engine.spec_counters()
    result = _traced(engine._dispatch_chunk, device)
    # target steps a chunk: a speculative chunk's rounds verify k + 1 each
    steps = (engine._spec_rounds * (SPEC_K + 1)) if engine.spec else ENGINE_CHUNK
    result["steps"] = steps
    result["per_step_wall_ms"] = result["wall_ms"] / steps
    result["per_step_device_ms"] = result["device_busy_ms"] / steps
    result["launches_per_step"] = result["device_launches"] / steps
    result["host_launches_per_step"] = result["host_launches"] / steps
    if engine.spec:
        after = engine.spec_counters()
        chunks = 2 * REPEATS
        emitted = (after["spec_emitted_tokens"] - before["spec_emitted_tokens"]) / chunks
        slot_rounds = (after["spec_slot_rounds"] - before["spec_slot_rounds"]) / chunks
        rounds = engine._spec_rounds
        result.update(
            rounds_per_chunk=rounds, emitted_tokens_per_chunk=emitted,
            accepted_tokens_per_slot_round=emitted / slot_rounds,
            per_round_wall_ms=result["wall_ms"] / rounds,
            per_round_device_ms=result["device_busy_ms"] / rounds,
            launches_per_round=result["device_launches"] / rounds,
            host_launches_per_round=result["host_launches"] / rounds,
            wall_ms_per_emitted_token=result["wall_ms"] / emitted,
            draft={k: getattr(engine.draft_config, k) for k in ("dim", "depth", "heads")})
    return result


def _trace_train(device, config, mixed_precision: bool = True, mesh=None,
                 strategies=("dp",), label: str = "train_step", superstep: int = 1,
                 repeats: int = REPEATS) -> list[dict]:
    """The train step at batch 8 after two warm-up steps; with ``superstep``
    > 1 also one ``train_multi_step`` of K optimizer steps (its capture
    first, on a mesh with the mesh's collectives), each line per optimizer
    step.  Returns the printed lines."""
    model = ProGen(config, make_policy(mixed_precision), device=device, seed=0)
    fns = make_train_functions(model, make_optimizer(), mesh=mesh, strategies=strategies)
    state = fns.init_state()
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(
        synthetic_uniref_batch(rng, TRAIN_BATCH, config.seq_len)).to(device)
    for _ in range(2):  # warm-up
        state, _ = fns.train_step(state, batch)

    def step():
        nonlocal state
        state, _ = fns.train_step(state, batch)

    def replays():
        nonlocal state
        state, _ = fns.train_multi_step(state, superbatch)

    meta = {"config": "small", "batch": TRAIN_BATCH, "seq_len": config.seq_len,
            "dtype": "bf16 compute, f32 params" if mixed_precision else "f32",
            "device": torch.cuda.get_device_name(device)}
    runs = [("eager", step, 1, {})]
    if superstep > 1:
        superbatch = batch.expand(superstep, 1, *batch.shape).contiguous()
        t0 = time.perf_counter()
        state, _ = fns.train_multi_step(state, superbatch[:1])  # the capture
        torch.cuda.synchronize(device)
        runs.append(("captured", replays, superstep,
                     {"capture_s": time.perf_counter() - t0,
                      "program_host_launches": fns.captured_program().host_launches}))
    lines = []
    for dispatch, fn, steps, extra in runs:
        result = _traced(fn, device, repeats)
        per_step = {f"per_step_{k}": result[k] / steps
                    for k in ("wall_ms", "device_busy_ms", "device_launches", "host_launches",
                              "event_span_ms")}
        dispatch_field = {"dispatch": dispatch, "steps": steps} if superstep > 1 else {}
        lines.append({"phase": label, **dispatch_field, **meta, **extra, **result,
                      **per_step})
        print(json.dumps(stamp_record(lines[-1])), flush=True)
    del model, fns, state
    return lines


def _trace_mesh(device, config, strategy_sets=(("dp",), ("fsdp",)),
                superstep: int = 1) -> None:
    """The train step without a mesh, then on a mesh of one rank (NCCL)
    under each of ``strategy_sets``, in f32 and in bf16 compute: what the
    meshed step adds; with ``superstep`` > 1 each also as replays of its
    captured optimizer step."""
    initialize_distributed(device)  # a world of one
    try:
        for mixed in (False, True):
            dtype = "bf16" if mixed else "f32"
            _trace_train(device, config, mixed, label=f"train_step_{dtype}_unmeshed",
                         superstep=superstep)
            for strategies in strategy_sets:
                mesh = make_mesh(MeshConfig(-1, 1, 1, 1), "cuda")
                _trace_train(device, config, mixed, mesh, strategies,
                             label=f"train_step_{dtype}_{'_'.join(strategies)}_world1",
                             superstep=superstep)
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
