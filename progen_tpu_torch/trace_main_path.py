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
``train``: the train step), all three by default.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.prefill import pad_prime_length
from progen_tpu_torch.decode.sampler import make_chunked_sampler
from progen_tpu_torch.models.configs import SMALL
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import make_train_functions

PRIME_LEN = 300
STEPS = 64
TRAIN_BATCH = 8
ENGINE_SLOTS = 8
ENGINE_CHUNK = 32
REPEATS = 5  # rounds per phase: host-clock walls vary from run to run
# kernel-name fragments of the port's own kernels and of cuBLAS's products
PORT_KERNELS = ("local_attention_", "sgu_", "paged_gate_mix")
MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass")


def _kind(name: str) -> str:
    if any(k in name for k in PORT_KERNELS):
        return "port_kernels"
    if any(k in name.lower() for k in MATMUL_KERNELS):
        return "matmul"
    return "other"


def _wall_ms(fn, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def _profiled(fn, device) -> dict[str, list]:
    """One run under the profiler: its device kernels' ``{name: [calls, us]}``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = per_name.setdefault(e.name, [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
    return per_name


def _median_and_range(values) -> tuple[float, list]:
    return float(np.median(values)), [min(values), max(values)]


def _traced(fn, device) -> dict:
    """``REPEATS`` bare runs on the host clock, then ``REPEATS`` runs under
    the profiler (kept apart, so that no bare run pays for the profiler's
    teardown): medians with their ``[min, max]`` range.  The idle share is
    ``1 - median busy / median wall``; its range takes the walls' range.
    The by-kind split and the top kernels come from the profiled run of
    median device time."""
    walls = [_wall_ms(fn, device) for _ in range(REPEATS)]
    rounds = [_profiled(fn, device) for _ in range(REPEATS)]
    busy = [sum(us for _, us in r.values()) / 1e3 for r in rounds]
    out = {}
    out["wall_ms"], out["wall_ms_range"] = _median_and_range(walls)
    out["device_busy_ms"], out["device_busy_ms_range"] = _median_and_range(busy)
    out["idle_share"] = 1.0 - out["device_busy_ms"] / out["wall_ms"]
    out["idle_share_range"] = [1.0 - out["device_busy_ms"] / w for w in out["wall_ms_range"]]
    out["device_launches"], out["device_launches_range"] = _median_and_range(
        [sum(n for n, _ in r.values()) for r in rounds])
    out["repeats"] = REPEATS
    per_name = rounds[int(np.argsort(busy)[REPEATS // 2])]
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


PHASES = ("serve", "engine", "train")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", nargs="+", choices=PHASES, default=list(PHASES))
    phases = parser.parse_args(argv).phases
    device = resolve_device("cuda")
    config = SMALL
    if "serve" in phases or "engine" in phases:
        _trace_serving(device, config, phases)
    if "train" in phases:
        _trace_train(device, config)


def _trace_serving(device, config, phases) -> None:
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
        print(json.dumps({"phase": "prefill", **meta, **_traced(prefill, device)}))
        steps = decode_len - p_len
        result = _traced(lambda: decode(caches), device)
        result["per_step_wall_ms"] = result["wall_ms"] / steps
        result["per_step_device_ms"] = result["device_busy_ms"] / steps
        print(json.dumps({"phase": "decode", **meta, "steps": steps, **result}))
    del sampler, caches
    if "engine" not in phases:
        return

    for mode, kwargs in (("dense", {}), ("paged", {"paged": True}),
                         ("paged_q8", {"paged": True, "quantize": "weights+pages"})):
        engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                               max_len=config.seq_len, page_size=16, **kwargs)
        for i in range(ENGINE_SLOTS):
            # budgets no row can exhaust within the traced chunks; half the
            # rows greedy, half top-k 25 at temperature 1
            engine.submit(Request(
                uid=i, tokens=[0] + rng.integers(1, config.num_tokens, PRIME_LEN).tolist(),
                max_new_tokens=700, top_k=25 if i % 2 else None,
                temperature=1.0 if i % 2 else 0.0, seed=i))
        engine._admit_pending()
        for _ in range(2):  # warm-up
            engine._dispatch_chunk()
        result = _traced(engine._dispatch_chunk, device)
        result["per_step_wall_ms"] = result["wall_ms"] / ENGINE_CHUNK
        result["per_step_device_ms"] = result["device_busy_ms"] / ENGINE_CHUNK
        result["launches_per_step"] = result["device_launches"] / ENGINE_CHUNK
        live = int((engine.state["active"] & ~engine.state["done"]).sum())
        print(json.dumps({"phase": "engine_chunk", "mode": mode, "config": "small",
                          "slots": ENGINE_SLOTS, "steps": ENGINE_CHUNK,
                          "live_rows_at_end": live, "prime_len": p_len,
                          "device": meta["device"], **result}))
        del engine


def _trace_train(device, config) -> None:
    model = ProGen(config, make_policy(), device=device, seed=0)
    fns = make_train_functions(model, make_optimizer())
    state = fns.init_state()
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(
        synthetic_uniref_batch(rng, TRAIN_BATCH, config.seq_len)).to(device)
    for _ in range(2):  # warm-up
        state, _ = fns.train_step(state, batch)

    def step():
        nonlocal state
        state, _ = fns.train_step(state, batch)

    print(json.dumps({"phase": "train_step", "config": "small", "batch": TRAIN_BATCH,
                      "seq_len": config.seq_len,
                      "device": torch.cuda.get_device_name(device),
                      **_traced(step, device)}))


if __name__ == "__main__":
    main()
