"""Training CLI of the port, with the flags of the JAX package's ``train.py``
that the port's ``Trainer`` honours.

    python -m progen_tpu_torch.train --data_path ./train_data \\
        --checkpoint_path ./ckpts --model_name small --batch_size 8 \\
        --grad_accum_every 1 --mixed_precision --checkpoint_every 1000

trains on GZIP tfrecords (``python -m progen_tpu_torch.generate_data``
writes them) through :class:`~progen_tpu_torch.train.trainer.Trainer`: it
validates, samples and checkpoints at its cadences and, run again with the
same ``--checkpoint_path``, resumes from the newest checkpoint at the exact
record cursor (the stored model config wins over ``--model_name``).
``--new`` wipes the checkpoints after a y/n confirm.  The model config is
``{--config_path}/{--model_name}.toml``.  One JSON line is printed per
logged step (step, loss, grad_norm, lr, step_ms, data_wait_ms,
tokens_per_sec_per_chip and, on a card whose bf16 peak
``observe.flops.peak_flops_per_chip`` knows, mfu) and per hook.

Without ``--data_path`` it trains on synthetic Uniref50-shaped rows made
from ``--seed`` (``data/synthetic.py``) for ``--max_steps`` micro-batches
(10 by default), with no checkpoints, and prints one JSON line per logged
step: step, loss, grad_norm, lr, step_ms, tokens_per_s and mfu.

With ``--data_path`` the Trainer runs over a mesh, ``--mesh data,fsdp,
tensor,seq`` (``-1,1,1,1`` by default: every rank on the data axis) under
``--strategies`` (``dp`` by default; ``fsdp``, ``tp`` and ``sp`` too, comma
separated), one process per card:

    torchrun --nproc_per_node 8 -m progen_tpu_torch.train --data_path ... \
        --mesh 1,8,1,1 --strategies fsdp

or started by hand with ``RANK`` and ``WORLD_SIZE`` set and
``--init_method file:///shared/path`` (or ``MASTER_ADDR``/``MASTER_PORT``);
without them it is a world of one.  Rank 0 alone prompts for
``--new``, prints and writes the tracker and the checkpoints.  Tensor
parallelism splits the heads and mlp channels over the tensor axis
(``--mesh 1,1,2,1 --strategies tp``; composed with ``fsdp`` as 2-D
sharding).  The Trainer plans the step's memory first and refuses a
configuration that cannot fit the card (``PROGEN_SKIP_MEMORY_CHECK=1``
skips the check).

``--statusz [PORT]`` serves ``/healthz /statusz /metricsz /tracez
/flightz`` on a loopback port of rank 0 (a bare ``--statusz`` takes an
ephemeral port, printed as a JSON line).

``--remat`` recomputes each block in the backward pass under
``--remat_policy`` (``full``, ``dots`` or ``attn``, ``models/progen.py``).
``--superstep K`` advances up to K optimizer steps per
``train_multi_step``: on the card one captured CUDA graph of the optimizer
step, replayed K times (``train/step.py``); spans shrink to land on hook
boundaries.  With ``--data_path`` the superstep runs the meshed step under
any ``--mesh`` and ``--strategies``.  Without ``--data_path`` each dispatch
takes up to K optimizer steps of synthetic rows and prints one line.

``--wandb_off`` keeps the tracker to its JSONL file; otherwise it mirrors
to wandb, when the package is importable, under ``--wandb_project_name``
(JAX's default ``progen-training``).  ``--profile_dir DIR`` records a
``torch.profiler`` trace of the training loop into ``DIR/trace.json``
(``observe/meter.py:profile_trace``).

Not accepted: the kernel-choice flags.  The device is ``cuda`` unless
``--device cpu`` is given (then the ranks meet over gloo).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import tomllib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe.flops import mfu, model_flops_per_token, peak_flops_per_chip
from progen_tpu_torch.observe.tracker import Tracker
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.models.progen import REMAT_POLICIES
from progen_tpu_torch.train.schedule import SCHEDULES, lr_at, make_lr_schedule
from progen_tpu_torch.train.step import make_train_functions
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig

SYNTHETIC_STEPS = 10


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_name", default="default", choices=sorted(CONFIGS))
    p.add_argument("--config_path", default="./configs/model",
                   help="folder of {model_name}.toml model configs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--grad_accum_every", type=int, default=4)
    p.add_argument("--epochs", type=int, default=100)
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
    p.add_argument("--remat", action="store_true",
                   help="rematerialize blocks in backward (saves device memory)")
    p.add_argument("--remat_policy", default="full", choices=REMAT_POLICIES,
                   help="full: recompute everything; dots: save matmul outputs, "
                        "recompute the rest; attn: save the attention path "
                        "(q/k/v + out), replay the feed-forward")
    p.add_argument("--superstep", type=int, default=1,
                   help="up to K optimizer steps per train_multi_step (one "
                        "captured CUDA graph of the step, replayed; 1 = per-step "
                        "dispatch); spans shrink to land on hook boundaries")
    p.add_argument("--data_path", default=None,
                   help="folder of *.train/*.valid.tfrecord.gz shards; "
                        "without it, synthetic rows and no checkpoints")
    p.add_argument("--checkpoint_path", default="./ckpts")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--checkpoint_keep_n", type=int, default=500)
    p.add_argument("--new", action="store_true",
                   help="clear every checkpoint first (asks y/n)")
    p.add_argument("--validate_every", type=int, default=100)
    p.add_argument("--sample_every", type=int, default=500)
    p.add_argument("--prime_length", type=int, default=25)
    p.add_argument("--shuffle_buffer", type=int, default=0,
                   help="seeded sliding-buffer record shuffle (0 = off); "
                        "resume replays the interrupted order exactly")
    p.add_argument("--prefetch_depth", type=int, default=0,
                   help="batches a worker thread makes and copies to the "
                        "device ahead of the step (0 = synchronous feed)")
    p.add_argument("--background_checkpoint", action="store_true", default=True,
                   help="checkpoint from a device snapshot on a background "
                        "thread (one state-sized copy of device memory)")
    p.add_argument("--no_background_checkpoint", dest="background_checkpoint",
                   action="store_false")
    p.add_argument("--run_attempts", type=int, default=3,
                   help="tries of the train loop: a transient failure "
                        "re-restores from the newest checkpoint (1 = fail fast)")
    p.add_argument("--watchdog_timeout", type=float, default=None,
                   help="seconds without a step before the watchdog dumps "
                        "every thread's stack and exits 42 (unset = off)")
    p.add_argument("--statusz", dest="statusz_port", type=int, nargs="?", const=0,
                   default=None, metavar="PORT",
                   help="serve /healthz /statusz /metricsz /tracez /flightz on this "
                        "loopback port (a bare --statusz: an ephemeral port, printed "
                        "at startup); the handlers read host state only")
    p.add_argument("--warm_sampler", action="store_true", default=True,
                   help="one short sampler call before the loop (skipped "
                        "when no sample hook can fire)")
    p.add_argument("--no_warm_sampler", dest="warm_sampler", action="store_false")
    p.add_argument("--runs_dir", default="./runs",
                   help="where the tracker writes metrics.jsonl per run")
    p.add_argument("--wandb_off", action="store_true",
                   help="no wandb mirror: the tracker's JSONL file only")
    p.add_argument("--wandb_project_name", default="progen-training",
                   help="the wandb project the tracker mirrors to")
    p.add_argument("--profile_dir", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the training loop "
                        "into DIR/trace.json")
    p.add_argument("--inject-faults", dest="inject_faults", default=None,
                   help="arm the fault-injection harness, e.g. "
                        "'ckpt.save:io_error:times=2;train.step:preempt:at=5'")
    p.add_argument("--max_steps", type=int, default=None,
                   help="optimizer steps to stop at (synthetic rows: "
                        f"micro-batches, {SYNTHETIC_STEPS} by default)")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--mesh", default="-1,1,1,1",
                   help="the Trainer's mesh axis sizes data,fsdp,tensor,seq "
                        "(-1 = the remaining ranks)")
    p.add_argument("--strategies", default="dp",
                   help="comma list of sharding strategies: dp, fsdp, tp, sp")
    p.add_argument("--init_method", default=None,
                   help="where ranks started by hand meet (file:// or tcp://), "
                        "with RANK and WORLD_SIZE set; torchrun's env:// otherwise")
    p.add_argument("--device", default="cuda")
    # "--mesh -1,1,1,1" as train.py takes it: argparse reads a value that
    # starts with "-" as an option unless it is glued on
    argv = list(sys.argv[1:] if argv is None else argv)
    for i in range(len(argv) - 1):
        if argv[i] == "--mesh":
            argv[i:i + 2] = [f"--mesh={argv[i + 1]}"]
            break
    args = p.parse_args(argv)
    try:
        args.mesh = MeshConfig.parse(args.mesh)
    except ValueError as e:
        p.error(f"--mesh: {e}")
    args.strategies = tuple(args.strategies.split(","))
    if args.statusz_port is not None and args.data_path is None:
        p.error("--statusz serves the Trainer's state: it needs --data_path")
    return args


def _load_model_config(config_path: str, model_name: str) -> dict:
    path = Path(config_path) / f"{model_name}.toml"
    if not path.exists():
        raise SystemExit(f"path to your model config {path} does not exist")
    return tomllib.loads(path.read_text())


def train_tfrecords(args, device: torch.device) -> dict:
    """The ``Trainer`` over ``--data_path``; returns its result."""
    if args.inject_faults:
        faults.configure(args.inject_faults, seed=args.seed)
    if not dist.is_initialized():  # torchrun's environment, or a world of one
        initialize_distributed(device, init_method=args.init_method)
    rank = dist.get_rank()
    store = CheckpointStore(args.checkpoint_path, args.checkpoint_keep_n)
    if args.new:
        wipe = [False]
        if rank == 0:
            answer = input("are you sure you want to clear all your checkpoints "
                           "and restart training? [y/N]: ")
            wipe[0] = answer.strip().lower() in ("y", "yes")
            if wipe[0]:
                store.reset()
        dist.broadcast_object_list(wipe, src=0)
        if not wipe[0]:
            raise SystemExit(0)
    # the checkpoint's model config wins on resume
    meta = store.restore_meta()
    model_kwargs = (_load_model_config(args.config_path, args.model_name)
                    if meta is None else meta["model_config"])
    cfg = TrainerConfig(
        seed=args.seed, batch_size=args.batch_size,
        grad_accum_every=args.grad_accum_every, epochs=args.epochs,
        learning_rate=args.learning_rate, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, schedule_steps=args.schedule_steps,
        lr_min_ratio=args.lr_min_ratio, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm, validate_every=args.validate_every,
        sample_every=args.sample_every, checkpoint_every=args.checkpoint_every,
        checkpoint_keep_n=args.checkpoint_keep_n, prime_length=args.prime_length,
        mixed_precision=args.mixed_precision, shuffle_buffer=args.shuffle_buffer,
        prefetch_depth=args.prefetch_depth,
        background_checkpoint=args.background_checkpoint,
        log_every=args.log_every, max_steps=args.max_steps,
        run_attempts=args.run_attempts, watchdog_timeout=args.watchdog_timeout,
        warm_sampler=args.warm_sampler, mesh=args.mesh, strategies=args.strategies,
        statusz_port=args.statusz_port, remat=args.remat, remat_policy=args.remat_policy,
        superstep=args.superstep, profile_dir=args.profile_dir)
    config = {k: v for k, v in vars(args).items() if k != "new"}
    config["mesh"] = ",".join(str(v) for v in dataclasses.astuple(args.mesh))
    tracker = Tracker(project=args.wandb_project_name, out_dir=args.runs_dir,
                      run_id=(meta or {}).get("run_id"), use_wandb=not args.wandb_off,
                      config={**model_kwargs, **config}, disabled=rank != 0)
    trainer = Trainer(ProGenConfig.from_dict(model_kwargs), cfg, args.data_path,
                      args.checkpoint_path, tracker=tracker, device=device)
    try:
        return trainer.run()
    finally:
        trainer.close()
        tracker.finish()


def train_synthetic(args, device: torch.device) -> list[dict]:
    """``--max_steps`` micro-batches of synthetic rows, a span of up to
    ``--superstep`` optimizer steps per dispatch; returns the records it
    printed."""
    max_steps = args.max_steps or SYNTHETIC_STEPS
    accum = args.grad_accum_every
    config = CONFIGS[args.model_name]
    model = ProGen(config, make_policy(args.mixed_precision), device=device,
                   seed=args.seed, remat=args.remat, remat_policy=args.remat_policy)
    schedule = make_lr_schedule(
        args.lr_schedule, args.learning_rate, warmup_steps=args.warmup_steps,
        decay_steps=args.schedule_steps or max_steps,
        min_lr_ratio=args.lr_min_ratio)
    optimizer = make_optimizer(schedule, args.weight_decay, args.max_grad_norm, accum)
    fns = make_train_functions(model, optimizer)
    state = fns.init_state()
    num_params = sum(p.numel() for p in model.parameters())
    flops_per_token = model_flops_per_token(config, num_params)
    peak = peak_flops_per_chip(device)  # None off the H100: mfu reads None
    rng = np.random.default_rng(args.seed)
    tokens_per_step = args.batch_size * config.seq_len

    def rows(n: int) -> torch.Tensor:
        return torch.from_numpy(np.stack([
            synthetic_uniref_batch(rng, args.batch_size, config.seq_len)
            for _ in range(n)])).to(device)

    records = []
    while state.step < max_steps:
        # a superstep takes whole optimizer steps from a step boundary
        k = min(args.superstep, (max_steps - state.step) // accum)
        if k > 1 and state.opt_state.mini_step == 0:
            batch = rows(k * accum).reshape(k, accum, args.batch_size, -1)
        else:
            k, batch = 0, rows(1)[0]
        count = state.opt_state.count
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        if k:
            state, metrics = fns.train_multi_step(state, batch)
            metrics = {key: metrics[key][-1, -1] for key in ("loss", "grad_norm")}
            count += k - 1
        else:
            state, metrics = fns.train_step(state, batch)
        loss = float(metrics["loss"])  # waits for the steps
        seconds = time.perf_counter() - t0
        micro = max(1, k * accum)
        if state.step // args.log_every == (state.step - micro) // args.log_every \
                and state.step != max_steps:
            continue
        rate = tokens_per_step * micro / seconds
        record = {
            "step": state.step, "loss": loss,
            "grad_norm": float(metrics["grad_norm"]),
            "lr": lr_at(schedule, count), "step_ms": seconds / micro * 1e3,
            "tokens_per_s": rate,
            "mfu": mfu(rate, flops_per_token, peak),
        }
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


def main(argv=None):
    """Run the CLI: the ``Trainer``'s result with ``--data_path``, else the
    synthetic run's printed records."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.data_path is None:
        return train_synthetic(args, device)
    owned = not dist.is_initialized()
    try:
        return train_tfrecords(args, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
