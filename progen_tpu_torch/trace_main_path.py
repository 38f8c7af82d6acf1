"""Where the serving path's time goes on the card.

    python -m progen_tpu_torch.trace_main_path

Runs ProGen-small (weights from seed 0, bf16 compute) through one prefill of
a batch of 2 primes of 300 residues + BOS and 64 cached decode steps, after
two warm-ups of both.  Each phase runs twice: once bare, timed on the host
clock (ended by a synchronize), and once under ``torch.profiler`` with CPU
and CUDA activity, whose device-side kernel events give the device busy
time (their summed durations; one stream, so they do not overlap) and the
launch count.  Prints one JSON line per phase: wall time, device busy time,
the idle share ``1 - busy / wall`` and the kernels that took the most
device time.  Needs a GPU.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.prefill import pad_prime_length
from progen_tpu_torch.decode.sampler import make_chunked_sampler
from progen_tpu_torch.models.configs import SMALL
from progen_tpu_torch.models.progen import ProGen

PRIME_LEN = 300
STEPS = 64


def _traced(fn, device) -> dict:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    per_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = per_name.setdefault(e.name, [0, 0.0])
            entry[0] += 1
            entry[1] += e.time_range.elapsed_us()
    busy_us = sum(us for _, us in per_name.values())
    top = sorted(per_name.items(), key=lambda kv: kv[1][1], reverse=True)
    return {
        "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        "device_launches": sum(n for n, _ in per_name.values()),
        "top": [{"name": name[:80], "calls": n, "device_ms": us / 1e3}
                for name, (n, us) in top[:10]],
    }


def main() -> None:
    device = resolve_device("cuda")
    config = SMALL
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
    print(json.dumps({"phase": "prefill", **meta, **_traced(prefill, device)}))
    steps = decode_len - p_len
    result = _traced(lambda: decode(caches), device)
    result["per_step_wall_ms"] = result["wall_ms"] / steps
    result["per_step_device_ms"] = result["device_busy_ms"] / steps
    print(json.dumps({"phase": "decode", **meta, "steps": steps, **result}))


if __name__ == "__main__":
    main()
