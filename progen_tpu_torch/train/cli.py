"""Training CLI of the port: train ProGen on synthetic Uniref50-shaped rows.

    python -m progen_tpu_torch.train --model_name small --batch_size 8 \\
        --grad_accum_every 1 --mixed_precision --max_steps 20 --log_every 1

Takes the model and optimizer flags of the JAX package's ``train.py``.  The
rows are made from ``--seed`` (``data/synthetic.py``), as the JAX package's
bench makes them.  Not accepted yet: the data path, checkpoint, validation,
sampling, hook, logging-service, remat, kernel-choice and mesh flags.
Prints one JSON line per logged step: step, loss, grad_norm, lr, step_ms,
tokens_per_s and mfu (against the H100's bf16 peak; null off the card).
The device is ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.observe.flops import mfu, model_flops_per_token
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.schedule import SCHEDULES, make_lr_schedule
from progen_tpu_torch.train.step import make_train_functions


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name", default="default", choices=sorted(CONFIGS))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--grad_accum_every", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=2e-4)
    p.add_argument("--lr_schedule", default="constant", choices=SCHEDULES,
                   help="cosine and linear need --schedule_steps or "
                        "--max_steps as the decay horizon")
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear lr warmup over this many optimizer steps")
    p.add_argument("--schedule_steps", type=int, default=None,
                   help="step at which cosine/linear decay bottoms out")
    p.add_argument("--lr_min_ratio", type=float, default=0.1,
                   help="decay floor as a fraction of --learning_rate")
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--max_grad_norm", type=float, default=0.5)
    p.add_argument("--mixed_precision", action="store_true",
                   help="bf16 compute, f32 parameters")
    p.add_argument("--max_steps", type=int, default=10,
                   help="micro-batches to train on (there is no data path "
                        "yet, so no epochs)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the CLI; returns the records it printed."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = CONFIGS[args.model_name]
    model = ProGen(config, make_policy(args.mixed_precision), device=device,
                   seed=args.seed)
    schedule = make_lr_schedule(
        args.lr_schedule, args.learning_rate, warmup_steps=args.warmup_steps,
        decay_steps=args.schedule_steps or args.max_steps,
        min_lr_ratio=args.lr_min_ratio)
    optimizer = make_optimizer(schedule, args.weight_decay, args.max_grad_norm,
                               args.grad_accum_every)
    fns = make_train_functions(model, optimizer)
    state = fns.init_state()
    num_params = sum(p.numel() for p in model.parameters())
    flops_per_token = model_flops_per_token(config, num_params)
    rng = np.random.default_rng(args.seed)
    tokens_per_step = args.batch_size * config.seq_len

    records = []
    for _ in range(args.max_steps):
        batch = torch.from_numpy(
            synthetic_uniref_batch(rng, args.batch_size, config.seq_len)).to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, metrics = fns.train_step(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        seconds = time.perf_counter() - t0
        if state.step % args.log_every and state.step != args.max_steps:
            continue
        rate = tokens_per_step / seconds
        record = {
            "step": state.step, "loss": loss,
            "grad_norm": float(metrics["grad_norm"]),
            "lr": metrics["lr"], "step_ms": seconds * 1e3,
            "tokens_per_s": rate,
            "mfu": mfu(rate, flops_per_token) if device.type == "cuda" else None,
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records
