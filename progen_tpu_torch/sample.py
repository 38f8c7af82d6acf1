"""Sampling CLI of the port: prefill a prime, decode in early-exit chunks,
print the samples.

    python -m progen_tpu_torch.sample --config small --seed 42 --prime MKV \\
        --num_samples 4 --top_k 25 --temperature 1.0 --seq_len 1024 \\
        --chunk 32 [--params weights.npz] [--device cuda]

The noise walks the JAX key chain from ``KeySeq(--seed)``, as the JAX
package's ``sample.py`` does, so the same weights, prime and seed give its
samples; ``--seed`` and ``--chunk`` default to its 42 and 32.

With ``--serve`` the primes (``--prime "MKV|MAL|..."``, or ``--num_samples``
copies of one prime) go through the continuous-batching ``ServingEngine``
instead, each BOS-prefixed with its own seed (``--seed + i``), and every
completion is printed as one JSON line:

    python -m progen_tpu_torch.sample --serve --prime "MKV|MALW" --slots 8 \
        --chunk 32 [--paged --page_size 16] [--quantize weights+pages] \
        [--spec --spec_k 4] [--disagg]

``--spec`` decodes speculatively with the identity draft (the model drafts
for itself, as the JAX CLI's does), ``--disagg`` prefills in a separate
worker stage behind a bounded handoff queue; both give the same tokens.

The served requests go through ``run_with_restarts``: a transient failure
that escapes the engine's in-place retries snapshots the unfinished requests
(to ``--snapshot_path`` too, as JSON), builds a fresh engine and replays
them, token-identical, up to ``--serve_attempts`` tries in all (3; 1 = fail
fast).  ``--watchdog_timeout S`` exits the process with a dump of every
thread's stack when no engine step completes for S seconds (each program's
first dispatch, with the kernels' build, is exempt).  ``--trace`` records
the engine's spans and writes them, merged, as a Perfetto ``trace.json``
under ``--trace_out``:

    python -m progen_tpu_torch.sample --serve --prime "MKV|MALW" \
        --serve_attempts 2 --snapshot_path snap.json --trace --trace_out traces

``--aot_warmup`` warms every engine ``run_with_restarts`` builds before it
serves (``ServingEngine.aot_warmup``, with ``--embed`` the embedding
programs too): on the card each program of the engine's grid becomes one
captured CUDA graph and every dispatch one replay, with the same tokens.
It prints ``aot warmup: N programs in S s`` to stderr for each engine:

    python -m progen_tpu_torch.sample --serve --aot_warmup --prime "MKV|MALW" --paged

Two serving workloads ride ``--serve`` (one at a time):

* ``--embed``: each prime is embedded (``engine.submit_embed``: one
  forward, the final hidden state mean-pooled) and printed as
  ``[embed, dim=..., norm=...]`` with its first 8 values;
* ``--infill TEMPLATE``: constrained infilling.  Plain characters are
  frozen scaffold positions, ``?`` a free position, ``[ILV]`` a position
  restricted to that set; ``--num_samples`` samples decode under the
  scaffold's logit mask (``workloads/infill.py``), so a constrained
  position emits only an allowed residue.

    python -m progen_tpu_torch.sample --serve --embed --prime "MKV|MALW"
    python -m progen_tpu_torch.sample --serve --infill "MKV??[ILV]G?" --num_samples 2

``--checkpoint_path`` samples from the newest checkpoint of a store the
port's ``Trainer`` wrote: the model config comes from its metadata and the
parameters from its params file (the optimizer's is not read):

    python -m progen_tpu_torch.sample --checkpoint_path ./ckpts --prime MKV

Otherwise ``--params`` takes an ``.npz`` of flat flax keys
(``compat/convert.py``), and without either the weights are drawn from
``--seed``.  Compute is bf16 over f32 parameters, as the JAX CLI's.  The
device is ``cuda`` unless ``--device cpu`` is given.

``--mesh data,fsdp,tensor,seq`` decodes across ranks under ``--strategies``
(``fsdp`` by default, as the JAX CLI's; comma separated): each rank builds
the weights whole (``--checkpoint_path``, ``--params`` or ``--seed``) and
places them with ``parallelize``, and the sampler, or with ``--serve`` one
engine per rank fed the same requests, decodes in those shardings
(``parallel/decode.py``); rank 0 prints.  The ranks start under
``torchrun``, or by hand with ``RANK`` and ``WORLD_SIZE`` set and
``--init_method file:///shared/path``; with ``--device cpu`` they meet over
gloo.  ``--serve`` composes with ``--disagg``, ``--spec`` and
``--aot_warmup`` as it does without a mesh:

    torchrun --nproc_per_node 2 -m progen_tpu_torch.sample --config default \
        --prime MKV --mesh 1,1,2,1 --strategies tp --device cpu

``--xprof_dir DIR`` records a ``torch.profiler`` trace of the decode (the
sampler's call, or the serve loop) into ``DIR/trace.json`` (under a mesh
each rank into ``DIR/rank{r}``).

``--serve --serve_procs`` serves through the multi-process fleet
(``serve/``): ``--prefill_procs`` prefill worker processes and
``--replicas`` decode replica processes behind a router in this process,
the handles crossing between them as CRC-framed PGHF frames over loopback
sockets.  Every worker builds the weights of ``--checkpoint_path`` (made
absolute) or of ``--seed``, as the in-process engine does, so the fleet
prints the JSON lines of ``--serve --disagg``, latencies aside.  On the
card every worker runs on ``cuda:0``.  ``--trace`` reaches every worker
(their dumps merge into one ``trace.json``) and ``--statusz`` starts a
loopback introspection server in every process, printing
``{"statusz": {"driver": PORT, "prefill:0": PORT, ...}}`` first:

    python -m progen_tpu_torch.sample --serve --serve_procs --prime "MKV|MALW" \
        --paged --prefill_procs 1 --replicas 1 [--statusz] [--trace]

With ``--serve_procs``, ``--embed`` goes through the fleet
(``ServeCluster.submit_embed``: the prefill workers answer it), and the
elastic control plane (``serve/control.py``) drives the fleet with the JAX
CLI's flags and defaults: ``--autoscale`` ticks a ``BurnRatePolicy``
between polls, within ``--min_prefill`` (default ``--prefill_procs``) and
``--max_prefill`` (``--prefill_procs + 2``), ``--min_replicas``
(``--replicas``) and ``--max_replicas`` (``--replicas + 2``); ``--swap_at
N`` rolls the fleet to a new weight generation of the same weights after
``N`` completions (no request dropped; every record carries its
``generation``).  Each decision is printed as a ``{"control": ...}`` JSON
line:

    python -m progen_tpu_torch.sample --serve --serve_procs --autoscale \
        --swap_at 2 --prime "MKV|MALWTR|M" --config default --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.compat.convert import load_npz
from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed, make_mesh
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tokenizer import decode_tokens, encode_tokens
from progen_tpu_torch.decode.engine import Request, ServingEngine, run_with_restarts
from progen_tpu_torch.decode.rng import KeySeq
from progen_tpu_torch.decode.sampler import make_sampler
from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.observe.meter import profile_trace
from progen_tpu_torch.observe.trace import (
    configure_tracing,
    get_tracer,
    merge_trace_dir,
    trace_dump_path,
)
from progen_tpu_torch.parallel.sharding import parallelize, validate_tp_divisibility
from progen_tpu_torch.resilience.watchdog import Watchdog
from progen_tpu_torch.workloads.infill import ScaffoldSpec


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="small", choices=sorted(CONFIGS))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--prime", default="")
    p.add_argument("--num_samples", type=int, default=1)
    p.add_argument("--top_k", type=int, default=25)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seq_len", type=int, default=None,
                   help="decode length, at most the config's seq_len "
                        "(the default)")
    p.add_argument("--chunk", type=int, default=32,
                   help="decode steps between early-exit checks")
    p.add_argument("--checkpoint_path", default=None,
                   help="sample from the newest checkpoint of this store")
    p.add_argument("--params", default=None,
                   help=".npz of flat flax parameter keys")
    p.add_argument("--device", default="cuda")
    p.add_argument("--serve", action="store_true",
                   help="serve the primes through the ServingEngine")
    p.add_argument("--slots", type=int, default=8, help="engine: slots")
    p.add_argument("--paged", action="store_true",
                   help="engine: keep the SGU gate cache in a page pool")
    p.add_argument("--page_size", type=int, default=16)
    p.add_argument("--quantize", default=None,
                   choices=["weights", "weights+pages"],
                   help="engine: int8 weights, and 8-bit gate pages")
    p.add_argument("--spec", action="store_true",
                   help="engine: speculative decoding with the identity draft")
    p.add_argument("--spec_k", type=int, default=4,
                   help="engine: draft tokens proposed per round (with --spec)")
    p.add_argument("--disagg", action="store_true",
                   help="engine: prefill in its own stage, handles merged "
                        "into slots through a bounded queue")
    p.add_argument("--embed", action="store_true",
                   help="with --serve: embed each prime (mean-pooled final "
                        "hidden state) instead of decoding")
    p.add_argument("--infill", default=None, metavar="TEMPLATE",
                   help="with --serve: constrained infilling; plain characters "
                        "are frozen, '?' is free, '[ILV]' allows that set")
    p.add_argument("--serve_attempts", type=int, default=3,
                   help="engine: tries of the serve loop; a transient failure "
                        "snapshots the unfinished requests, builds a fresh "
                        "engine and replays them (1 = fail fast)")
    p.add_argument("--snapshot_path", default=None, metavar="FILE",
                   help="engine: where a crash's snapshot is written (JSON)")
    p.add_argument("--watchdog_timeout", type=float, default=None,
                   help="engine: seconds without a completed step before the "
                        "watchdog dumps every thread's stack and exits (unset: "
                        "off); first dispatches and the kernels' build are exempt")
    p.add_argument("--trace", action="store_true",
                   help="record the engine's spans and merge them into a "
                        "Perfetto trace.json under --trace_out")
    p.add_argument("--trace_out", default="trace_out", metavar="DIR",
                   help="directory of the span dump and trace.json (with --trace)")
    p.add_argument("--aot_warmup", action="store_true",
                   help="engine: capture every program of the engine's grid "
                        "(admit or prefill and merge per bucket, the decode "
                        "chunk, with --embed the embed programs) as a CUDA "
                        "graph before serving")
    p.add_argument("--mesh", default=None,
                   help="decode across ranks on this mesh, data,fsdp,tensor,seq "
                        "(-1 = the remaining ranks)")
    p.add_argument("--strategies", default="fsdp",
                   help="with --mesh: comma list of dp, fsdp, tp, sp")
    p.add_argument("--init_method", default=None,
                   help="with --mesh: where ranks started by hand meet (file:// "
                        "or tcp://), with RANK and WORLD_SIZE set")
    p.add_argument("--xprof_dir", default=None, metavar="DIR",
                   help="record a torch.profiler trace of the decode into "
                        "DIR/trace.json")
    p.add_argument("--serve_procs", action="store_true",
                   help="with --serve: serve through prefill worker and decode "
                        "replica PROCESSES behind a router; handles cross as "
                        "CRC-framed frames over loopback sockets")
    p.add_argument("--prefill_procs", type=int, default=1,
                   help="prefill worker processes (with --serve_procs)")
    p.add_argument("--replicas", type=int, default=1,
                   help="decode replica processes (with --serve_procs)")
    p.add_argument("--statusz", action="store_true",
                   help="with --serve_procs: a loopback statusz server in every "
                        "process; the ports are printed first")
    p.add_argument("--autoscale", action="store_true",
                   help="with --serve_procs: run the elastic control plane; "
                        "scale the fleet between the min/max bounds on SLO "
                        "burn rate and queue depth; decisions are journaled "
                        "and printed")
    p.add_argument("--min_prefill", type=int, default=None,
                   help="autoscale floor for prefill workers "
                        "(default: --prefill_procs)")
    p.add_argument("--max_prefill", type=int, default=None,
                   help="autoscale ceiling for prefill workers "
                        "(default: --prefill_procs + 2)")
    p.add_argument("--min_replicas", type=int, default=None,
                   help="autoscale floor for decode replicas (default: --replicas)")
    p.add_argument("--max_replicas", type=int, default=None,
                   help="autoscale ceiling for decode replicas "
                        "(default: --replicas + 2)")
    p.add_argument("--swap_at", type=int, default=None,
                   help="with --serve_procs: after N completions, swap the "
                        "weights by a zero-downtime rolling worker upgrade (a "
                        "new generation of the same weights); no request is "
                        "dropped, completions report their generation")
    # "--mesh -1,1,1,1": argparse reads a value that starts with "-" as an
    # option unless it is glued on
    argv = list(sys.argv[1:] if argv is None else argv)
    for i in range(len(argv) - 1):
        if argv[i] == "--mesh":
            argv[i:i + 2] = [f"--mesh={argv[i + 1]}"]
            break
    args = p.parse_args(argv)
    args.strategies = tuple(args.strategies.split(","))
    if args.mesh is not None:
        try:
            args.mesh = MeshConfig.parse(args.mesh)
        except ValueError as e:
            p.error(f"--mesh: {e}")
    if args.aot_warmup and not args.serve:
        p.error("--aot_warmup warms the engine; add --serve")
    if (args.embed or args.infill is not None) and not args.serve:
        p.error("--embed/--infill are serving workloads; add --serve")
    if args.embed and args.infill is not None:
        p.error("pick ONE of --embed / --infill")
    elastic = [f for f in ("min_prefill", "max_prefill", "min_replicas",
                           "max_replicas", "swap_at") if getattr(args, f) is not None]
    if (args.autoscale or elastic) and not args.serve_procs:
        p.error(f"--{'autoscale' if args.autoscale else elastic[0]} drives the "
                "serving fleet; add --serve --serve_procs")
    if (args.serve_procs or args.statusz) and not args.serve:
        p.error("--serve_procs/--statusz run the serving fleet; add --serve")
    if args.statusz and not args.serve_procs:
        p.error("--statusz is the fleet's; add --serve_procs")
    if args.serve_procs:
        if args.mesh is not None:
            p.error("--mesh shards ONE process's decode over ranks; "
                    "--serve_procs spawns single-device workers: pick one")
        if args.params:
            p.error("--serve_procs workers load --checkpoint_path or draw the "
                    "weights from --seed, not --params")
    return args


def scaffold_from_template(template: str, vocab: int) -> ScaffoldSpec:
    """The ``--infill`` template as a scaffold: BOS (token 0) primes it,
    a plain character is frozen, ``?`` free, ``[...]`` an allowed set."""
    segs, i = [], 0
    while i < len(template):
        if template[i] == "[":
            j = template.index("]", i)
            segs.append(template[i + 1:j])
            i = j + 1
        else:
            segs.append(template[i])
            i += 1

    def entry(seg):
        if seg == "?":
            return None
        if len(seg) > 1:  # a bracket set
            return tuple(encode_tokens(c)[0] for c in seg)
        return encode_tokens(seg)[0]

    return ScaffoldSpec(template=[0] + [entry(s) for s in segs], vocab=vocab)


def serve_requests(args, config: ProGenConfig, seq_len: int) -> tuple[list, list]:
    """The served primes and their requests, uid ``i`` with seed
    ``--seed + i``: one per prime, or the ``--infill`` samples."""
    primes = (args.prime.split("|") if "|" in args.prime
              else [args.prime] * args.num_samples)
    knobs = dict(top_k=args.top_k or None, temperature=args.temperature)
    requests = []
    if args.infill is not None:
        scaffold = scaffold_from_template(args.infill, config.num_tokens)
        primes = [args.infill] * args.num_samples
        for i in range(args.num_samples):
            requests.append(Request(uid=i, seed=args.seed + i, workload="infill",
                                    **knobs, **scaffold.request_kwargs()))
    for i, prime in enumerate(primes if args.infill is None else ()):
        tokens = [0] + encode_tokens(prime)  # BOS-prefixed, like add_bos
        requests.append(Request(uid=i, tokens=tokens,
                                max_new_tokens=seq_len - len(tokens),
                                seed=args.seed + i, **knobs,
                                workload="embed" if args.embed else "generate"))
    return primes, requests


def serve(args, model, seq_len: int, placed: dict | None = None) -> list[dict]:
    """Answer the primes (or the ``--infill`` samples, or the ``--embed``
    requests) through the engine; prints (rank 0) and returns one record
    per completion, in uid order.  ``placed``: the engine's ``mesh``,
    ``strategies`` and ``params_shardings`` under ``--mesh``."""
    placed = placed or {}
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    primes, requests = serve_requests(args, model.config, seq_len)
    if args.trace:
        os.makedirs(args.trace_out, exist_ok=True)
        configure_tracing(enabled=True, process="serve")
    watchdog = None
    if args.watchdog_timeout:
        watchdog = Watchdog(args.watchdog_timeout, out_dir=".", label="serve").start()

    def engine_factory():
        engine = ServingEngine(model, num_slots=args.slots, chunk_size=args.chunk,
                               max_len=seq_len, paged=args.paged,
                               page_size=args.page_size, quantize=args.quantize,
                               spec=args.spec, spec_k=args.spec_k,
                               disagg=args.disagg, watchdog=watchdog, **placed)
        if args.aot_warmup:
            stats = engine.aot_warmup(embed=args.embed)
            if rank0:
                print(f"aot warmup: {stats['programs']} programs in "
                      f"{stats['seconds']:.1f} s", file=sys.stderr, flush=True)
        return engine

    try:
        if args.embed:
            engine = engine_factory()
            try:
                for r in requests:
                    engine.submit_embed(r)
                completions = engine.run_until_idle()
            finally:
                engine.close()
        else:
            completions = run_with_restarts(engine_factory, requests,
                                            attempts=args.serve_attempts,
                                            snapshot_path=args.snapshot_path)
    finally:
        if watchdog is not None:
            watchdog.stop()
    if args.trace and rank0:
        get_tracer().dump(trace_dump_path(args.trace_out, "serve"))
        print(json.dumps({"trace": merge_trace_dir(args.trace_out)}), flush=True)
    return serve_records(completions, primes, rank0)


def fleet_policy(args):
    """The control plane's ``BurnRatePolicy`` of the elastic flags, with the
    JAX CLI's defaults (``sample.py:320-324``): the floors at the fleet's
    starting size, the ceilings two above it."""
    from progen_tpu_torch.serve import BurnRatePolicy

    return BurnRatePolicy(
        min_prefill=args.min_prefill or args.prefill_procs,
        max_prefill=args.max_prefill or args.prefill_procs + 2,
        min_replicas=args.min_replicas or args.replicas,
        max_replicas=args.max_replicas or args.replicas + 2)


def drive_fleet(cluster, control, requests, args) -> list:
    """Submit ``requests`` (``--embed``: as embedding requests) and collect
    every completion.  Without a control plane the cluster drains; with one
    the loop is the JAX CLI's: ``tick()`` between polls under
    ``--autoscale``, and one rolling ``swap_weights()`` after ``--swap_at``
    completions.  Each journaled decision is printed as a JSON line."""
    for r in requests:
        if args.embed:
            cluster.submit_embed(r)
        else:
            cluster.submit(r)
    if control is None:
        return cluster.drain()
    completions, swapped, shown = [], False, 0
    while cluster.pending:
        completions.extend(cluster.poll(timeout=0.2))
        if (args.swap_at is not None and not swapped
                and len(completions) >= args.swap_at):
            swapped = True
            control.swap_weights()
        if args.autoscale:
            control.tick()
        for entry in control.journal[shown:]:
            print(json.dumps({"control": entry}), flush=True)
        shown = len(control.journal)
    # a swap pumps the fleet while it rolls: what completed inside the last
    # one is still to collect (the JAX CLI's loop drops it)
    return completions + cluster.poll()


def serve_fleet(args, config: ProGenConfig, seq_len: int) -> list[dict]:
    """``--serve --serve_procs``: answer the primes through a
    ``ServeCluster`` of ``--prefill_procs`` prefill workers and
    ``--replicas`` decode replicas (each a process on ``--device``, every
    one building the weights of ``--checkpoint_path`` or ``--seed``),
    driven by the elastic control plane under ``--autoscale`` or
    ``--swap_at`` (:func:`drive_fleet`); prints and returns the records as
    :func:`serve` does, each with its weight ``generation``."""
    from progen_tpu_torch.serve import ControlPlane, ServeCluster, make_spec

    primes, requests = serve_requests(args, config, seq_len)
    trace_dir = os.path.abspath(args.trace_out) if args.trace else None
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        configure_tracing(enabled=True, process="driver")
    spec = make_spec(
        config, mixed_precision=True, init_seed=args.seed,
        checkpoint_path=(os.path.abspath(args.checkpoint_path)
                         if args.checkpoint_path else None),
        engine=dict(num_slots=args.slots, chunk_size=args.chunk, max_len=seq_len,
                    paged=args.paged, page_size=args.page_size,
                    quantize=args.quantize, spec=args.spec, spec_k=args.spec_k),
        trace={"dir": trace_dir} if trace_dir else None, statusz=args.statusz,
        aot_warmup=args.aot_warmup, device=args.device)
    cluster = ServeCluster(spec, prefill_procs=args.prefill_procs,
                           replicas=args.replicas)
    try:
        control = (ControlPlane(cluster, fleet_policy(args))
                   if args.autoscale or args.swap_at is not None else None)
        if args.statusz:
            print(json.dumps({"statusz": cluster.stats()["statusz_ports"]}),
                  flush=True)
        profile = (profile_trace(args.xprof_dir) if args.xprof_dir is not None
                   else contextlib.nullcontext())
        with profile:
            completions = drive_fleet(cluster, control, requests, args)
    finally:
        cluster.shutdown()
    if trace_dir:
        print(json.dumps({"trace": merge_trace_dir(trace_dir)}), flush=True)
    return serve_records(completions, primes, True)


def serve_records(completions, primes: list, rank0: bool) -> list[dict]:
    """One record per completion in uid order, printed (on rank 0) as a
    JSON line, or for an embedding as its summary."""
    records = []
    say = print if rank0 else (lambda *a, **k: None)
    for comp in sorted(completions, key=lambda c: c.uid):
        if comp.embedding is not None:
            v = comp.embedding
            records.append({"uid": comp.uid, "prime": primes[comp.uid],
                            "embedding": [float(x) for x in v],
                            "status": comp.status, "latency_s": comp.latency,
                            "generation": comp.generation})
            say(f"\n {primes[comp.uid]} \n", "*" * 40,
                  f"[embed, dim={v.shape[0]}, norm={float(np.linalg.norm(v)):.4f}, "
                  f"{comp.latency:.2f}s]\n", np.round(v[:8], 4).tolist(), flush=True)
            continue
        records.append({
            "uid": comp.uid, "prime": primes[comp.uid],
            "text": decode_tokens(comp.tokens),
            "tokens": [int(t) for t in comp.tokens],
            "finish_reason": comp.finish_reason, "status": comp.status,
            "latency_s": comp.latency, "generation": comp.generation})
        say(json.dumps(records[-1]), flush=True)
    return records


def main(argv=None) -> list:
    """Run the CLI; returns the decoded samples (with ``--serve``: the
    completion records); rank 0 prints them."""
    args = parse_args(argv)
    if args.checkpoint_path and args.params:
        raise SystemExit("give --checkpoint_path or --params, not both")
    device = resolve_device(args.device)
    owned = args.mesh is not None and not dist.is_initialized()
    if owned:  # torchrun's environment, ranks started by hand, or one rank
        initialize_distributed(device, init_method=args.init_method)
    try:
        return _run(args, device)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device) -> list:
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    config = CONFIGS[args.config]
    if args.checkpoint_path:
        store = CheckpointStore(args.checkpoint_path)
        meta = store.restore_meta()
        if meta is None:
            raise SystemExit(f"no checkpoints found at {args.checkpoint_path}")
        config = ProGenConfig.from_dict(meta["model_config"])
        if rank0:
            print(f"trained for {max(meta['next_seq_index'], 0)} sequences")
    seq_len = min(args.seq_len or config.seq_len, config.seq_len)
    if args.serve_procs:  # the workers build the model, not this process
        return serve_fleet(args, config, seq_len)
    model = ProGen(config, make_policy(True), device=device, seed=args.seed)
    if args.checkpoint_path:
        model.load_state_dict(store.restore_params(map_location=device))
    elif args.params:
        load_npz(args.params, model)
    model.eval()
    placed = {}
    if args.mesh is not None:
        mesh = make_mesh(args.mesh, device.type)
        validate_tp_divisibility(config, mesh.size(2), args.strategies)
        plan = parallelize(model, mesh, args.strategies)
        placed = dict(mesh=mesh, strategies=args.strategies, params_shardings=plan)
    profile = contextlib.nullcontext()
    if args.xprof_dir is not None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        profile = profile_trace(args.xprof_dir if args.mesh is None
                                else os.path.join(args.xprof_dir, f"rank{rank}"))
    if args.serve:
        with profile:
            return serve(args, model, seq_len, placed)

    prime_tokens = encode_tokens(args.prime)
    # add_bos prepends the BOS/pad column; an empty prime is that column alone
    prime = torch.tensor([prime_tokens or [0]], dtype=torch.long,
                         device=device).repeat(args.num_samples, 1)
    add_bos = bool(prime_tokens)
    prime_length = len(prime_tokens) + 1
    sampler = make_sampler(model, chunk_size=args.chunk, **placed)
    with profile:
        sampled = sampler(prime, seq_len, key=next(KeySeq(args.seed)), top_k=args.top_k,
                          add_bos=add_bos, temperature=args.temperature)

    texts = []
    for row in sampled.cpu().numpy():
        text = decode_tokens(row[prime_length:])
        texts.append(text)
        if rank0:
            print("\n", args.prime, "\n", "*" * 40, "\n", text)
    return texts


if __name__ == "__main__":
    main()
