#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of progen-tpu (``progen_tpu_torch``) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits
non-zero without its last line:

1. device: the card's name and power limit, CUDA and nvcc versions;
2. build: the hand-written CUDA kernels, built from ``kernels/csrc`` by nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   ProGen-small shapes (serving and training shapes for the forward
   kernels, training shapes for the backward ones), with CUDA-event times
   of the kernel, the plain version and one PyTorch library call computing
   the same function; K1-fwd also at the phantom window alone, the main
   path's largest prefill, ProGen-tiny's head, ProGen-base's window, a
   window of 128 (all on the Hopper "wgmma" route in bf16) and on the WMMA
   route (f32, dim_head 32, a window of 64); K2-fwd in bf16 (the "wgmma"
   route) at both weight scales, batch 1 and 8, n = 1000, 512 and 100, and
   in f32; each forward case held to its route and run twice for the same
   bits; K1-dq and K1-dkv also at the phantom window alone, ProGen-tiny's head,
   ProGen-base's window, a window of 128 (all on the Hopper "wgmma" route
   in bf16) and on the WMMA route (f32, dim_head 32, a window of 64), each
   run twice for the same bits and held to the route it must take; K2-dgate
   and K2-dW also at batch 1, n = 1000, n = 100 and d = 520, each run twice
   for the same bits;
4. serving path: ProGen-small (weights drawn from a seed, bf16 compute)
   serves four primes through the chunked sampler (one parallel prefill
   through the kernels, then cached decode steps); the kernels' launch
   counts over that run (every K1-fwd and K2-fwd launch on the Hopper
   route), prefill logits through the kernels against the
   plain versions, the cached decode step against the parallel forward in
   f32, and the bf16 decode against the f32 answer beside the bf16 forward;
5. training path: ProGen-small (bf16 compute, f32 parameters) takes
   optimizer steps on synthetic rows through ``train/step.py``, with every
   kernel's launches per step (every K1 and K2-fwd launch on the Hopper
   kernels), a finite and falling loss, step time,
   tokens/s, MFU and peak memory; then one f32 step through the kernels
   against the same step through the plain versions (loss and every
   gradient), and the parameters after three steps;
6. paged gate mix: K3 and K3-q8 against their plain versions at the
   engine's shapes (8 rows at ragged positions, partly-NULL tables, garbage
   in the dump page and past each row's position; f32, bf16 and int8 pools,
   int8 weights; a page size that overhangs the weight square; one row at
   position 1023, eight at 0, eight at 1023, table entries outside the
   pool), every case held to its route (the bulk kernel at the engine's
   shapes) and run twice for the same bits; timed warm and with L2 cold,
   beside the first kernel (the simt route) at the same shape;
7. engine path: ProGen-small (bf16) answers 12 requests through the
   continuous-batching ``ServingEngine`` with 8 slots, dense, paged and
   paged with 8-bit pages, then paged again with a pool small enough to
   force pauses and evictions; each run's launch counts (K3 or K3-q8 twice
   per decode step, all on the bulk route, K1-fwd/K2-fwd 12/2 per admit
   program, on the Hopper route in bf16 and the first kernels in f32), pages returned,
   prefix-cache hits, tokens/s and peak memory; 32 teacher-forced paged
   steps through K3 and K3-q8 against the same steps through the plain
   version; and, in f32 and greedy, the paged engine's tokens against the
   dense engine's.  Then the engine's other modes on the same 12 requests,
   each held to the plain engine's tokens in its mode (at least 0.98 of
   them equal): speculative decoding (spec_k 4) paged with a
   ``draft_config_for`` draft (random weights from the seed) and dense with
   the identity draft (more than one token a round), prefill disaggregated
   (paged), and both with int8 weights and 8-bit pages (the speculative
   runs on the requests cut to 64 new tokens, against the plain runs'
   first 64); each run's acceptance counters, prefill and merge seconds,
   handoff stats and
   launches (the draft's K1-fwd/K2-fwd in every prefill program, on the
   Hopper route; K3 or K3-q8 twice per verify step);
8. trainer path: ProGen-small (bf16, batch 8, accumulation 1) trains
   through ``train/trainer.py`` on ``train_data_synth/`` (four GZIP tfrecord
   shards, 1900 records; 100 valid records): (a) 8 uninterrupted steps with
   background checkpoints and validation every 4 and a sample at 8, the
   batches fed by the prefetcher; (b) 4 steps into a fresh store, then a
   new ``Trainer`` resumes to 8 (no sample hook), and its losses and final parameters must
   equal (a)'s bit for bit; (c) (a)'s stored parameters, restored into a
   fresh model, give its prefill logits bit for bit.  Every train step's
   launches (the bare step's), all on the Hopper kernels; step time,
   tokens/s, MFU, the host's time per batch against the loop's wait for
   it, the snapshot's, host copy's, write's and restore's times,
   checkpoint bytes and peak memory; (d) the same Trainer with no hooks at
   prefetch depths 0 and 2 (step time, the loop's wait, whether
   the batch was queued when the loop took it); and the reader's time to
   its first batch after resume skips up to 200,000 records.  It runs in a
   temporary directory it deletes;
9. served workloads: ProGen-small (bf16) with a LoRA bank of 4 tenants at
   rank 8 (random from the seed) serves one mixed queue through the paged
   engine (8 slots, chunk 32, page 16): 4 generate requests on tenant 0, 3
   LoRA requests on tenants 1-3, 2 infill requests under a scaffold (a
   64-residue prime, free positions, allowed sets, frozen residues), a
   best-of-4 fork off a 256-token prime and 4 embeds of 37-511 residues.
   The tenant-0 tokens must equal a bankless engine's on the same queue
   (where the forks go in one by one, uid + k and seed + k), every infill
   token must be allowed and every frozen position forced, the followers
   must be admitted as prefix hits on the leader's prime pages, the
   embeddings must equal ``make_embedder``'s bit for bit and the plain
   versions' within 0.05 of each row's largest value, and each row's pooled
   final hidden states no farther from the f32 model's than the plain
   versions' are, within half again (RMS and max); launches per program
   (K1-fwd/K2-fwd 12/2 per admit and per embed program, K3 twice per
   decode step, all on the Hopper routes); tokens/s and median latency per
   workload, ``embed_s``, embed ms per bucket, the decode step's launches
   and device time (``torch.profiler``) and wall with and without the bank,
   peak memory.
   Then 32 teacher-forced paged steps with the bank through K3 and K3-q8
   against the plain mix, and in f32 and greedy the paged LoRA engine's
   tokens against the dense one's;
10. LoRA training: ``LoRAProGen`` at ProGen-small, rank 8, bf16, batch
   8 x 1024, lr 1e-3, 6 steps through ``train/lora.py``: launches per step
   12/12/12/4/2/2 on the Hopper kernels, a finite loss, the base
   bit-unchanged and every adapter moved, step time and tokens/s beside
   the full train step's, peak memory; then in f32 the trained adapters,
   through ``bank_from_trained``, as the engine's tenant 1: its prefill
   logits against the training forward's at 1e-5 (this pins the bank's
   layout: both sides run the same kernels); then one f32 LoRA step
   through the kernels against the same step through the plain versions
   (every gradient), the loss at each of three steps, and the largest
   difference in any update;
11. across ranks (``parallel``): (a) K1-fwd, K1-dq and K1-dkv with a random
   nonzero halo (``pallas_local_attention_ext``'s entry) against the plain
   version with the same halo, ``dk_halo``/``dv_halo`` included: bf16 on the
   Hopper route at the training shape (B 8, H 8, L 1024, D 128, window 256)
   and at ProGen-base's window, bf16 on the WMMA route (dim_head 32; a
   window of 64) and f32 (WMMA) at the training shape, each run twice for
   the same bits, held to its route and at K1's bars; at the training shape
   in bf16 and in f32, timed with and without the halo, with their bounds,
   the plain version and SDPA on the ``[halo ‖ own]`` layout; (b) the
   split-sequence identity at full width: L = 1024 as two halves of 512
   through the kernels, the left half's last window the right half's halo,
   against the whole sequence (out concatenated; dq concatenated, dk/dv
   with the right half's halo gradients added to the left half's last
   window); (c) the Trainer over ``train_data_synth/`` at ProGen-small
   (the f32 runs at 6 of its 12 layers since phase 16),
   batch 8, 4 steps: without a mesh in f32 and in bf16 compute, then on a
   mesh of one rank (NCCL, ``-1,1,1,1``) in f32 under ``dp`` and under
   ``fsdp`` (K1 on the WMMA route) and in bf16 compute under ``fsdp`` (K1
   on the Hopper route): each meshed run's losses against the unmeshed
   run's of its precision (1e-4 relative in f32, 1e-2 in bf16), every
   step's launches (12/12/12 of K1 through the halo entry, 4/2/2 of K2)
   and their routes, step time, tokens/s and peak memory beside the card's
   name and power limit.  The card is one H100 and NCCL refuses two ranks
   on one GPU, so (b) is the on-card witness of what ``sp`` does across
   ranks; the CPU tests run the ranks;
12. the engine's resume and operations (``engine_lifecycle``, run after
   phase 13): ProGen-small at a quarter depth (3 layers since phase 17; bf16, 8 slots, chunk
   32) on the 12 requests of phase 7 cut to 64 new tokens, dense, paged, 8-bit pages, speculative (identity
   draft), disaggregated (paged) and a workloads mode (paged, a LoRA bank
   of 4 tenants, an infill, an embed, a fork, a request shed at submit, a
   600-residue prime in a cold admit bucket, 8 priority requests that
   preempt); every engine beats one watchdog of 30 s, which must not trip.
   (a) in every mode a snapshot after 2 steps, restored on a fresh engine,
   replays to the uninterrupted run's answers token for token (the
   phase's own uninterrupted runs); (b) dense and paged,
   ``run_with_restarts`` through a decode fault with no in-place retry
   builds 2 engines and gives the same answers; (c) dense and 8-bit, a
   reload at idle from weights P0 to P1 gives a fresh P1 engine's answers
   (its serving weights bit-equal under 8-bit pages), every completion of
   generation 1; (e) tracing on changes no token, the merged trace holds
   every ``serve.*`` span and event name and ``engine.decode_chunk_s``
   counts every chunk; (f) a ``Trainer`` with ``statusz_port=0`` takes 3
   steps and answers /healthz and /metricsz (``train_loss``) on loopback;
   (g) after each engine and Trainer is closed and deleted the live memory
   is back within 256 MB of the phase's start.  Snapshot and restore ms
   and bytes, the replay's extra launches by kernel, tokens/s with tracing
   off and on and the live bytes after each delete, beside the card's name
   and power limit;
13. captured programs (``engine_graphs``, run after phase 9 on its model):
   ``ServingEngine.aot_warmup`` makes every program of the engine's grid
   one captured CUDA graph.  K1-fwd, K2-fwd, K3 and K3-q8 are each captured
   alone at the engine's shapes and replayed three times with new data in
   their inputs (K3 and K3-q8: new positions, tables and pool rows), each
   replay bit-equal to an eager launch; then the 12 requests of phase 7
   through a warmed engine, dense, paged, 8-bit pages, speculative paged
   (the ``draft_config_for`` draft, the requests cut to 64 new tokens) and
   disaggregated paged, and the workloads queue of phase 9 (the embedding programs warmed too): tokens,
   statuses and embeddings identical to the eager runs', the launches the
   smoke's formula (a replay counts what its capture launched); the
   programs, warm-up seconds and bytes the grid holds, the host's launches
   per warmed chunk, tokens/s and the time from the first submit to the
   first chunk, eager and warmed.  On the paged engine (the requests cut
   to 64 new tokens) a reload P0 -> P1
   captures the grid again and answers as a fresh warmed engine on P1, an
   injected decode fault changes nothing, and after the engines are closed
   and deleted the live memory is back within 256 MB of the phase's start;
14. the Trainer's superstep and remat (``trainer_superstep``, after phase
   8): K1-fwd, K1-dq, K1-dkv, K2-fwd, K2-dgate and K2-dW each captured
   alone at the train step's shapes (bf16, batch 8) and replayed three
   times with new data, bit-equal to eager launches; ``train_multi_step``
   (one captured optimizer step, replayed) against the eager steps from one
   init, K 4 at accumulation 1 and K 2 at accumulation 2, two dispatches
   each, and ``LoRAProGen`` rank 8 (K 2, accumulation 2, the base
   bit-unchanged): every loss, grad norm, lr, parameter, moment and the
   accumulator bit-equal (the embedding's weight gradient is a one-hot
   product, so the f32 step is deterministic);
   remat ``full``, ``dots``, ``attn`` in f32 bit-equal to no remat
   and in bf16 their peak memory, step ms and launches a
   step against the formula (K1-fwd 24/24/12, K2-fwd 6); the ``Trainer``
   (6 layers since phase 17) with ``superstep=4`` over ``train_data_synth/`` (validate 3, checkpoint
   4, log 2) to 4, then resumed to 6, its params bit-equal to
   ``superstep=1`` straight to 6, spans 2, 1, 1, 2 and every dispatch's
   launches the formula; 8 steps (16 before phase 17) at superstep 4 and at 1 (step ms,
   tokens/s, peak memory), a superstep of two steps traced against two
   eager steps (wall, device ms, idle share, device and host launches), the
   capture's seconds and the bytes its pool holds; live memory within
   256 MB of the phase's start after the Trainers are deleted;
16. the memory planner, tensor parallelism and the superstep on a mesh
   (``trainer_mesh``, after phase 11): (a) ``train/memory.plan`` against
   ``max_memory_allocated`` above the start, within 5%: the four remat
   policies at batch 8 (phase 14's peaks), no remat at batch 40 (> 40 GB),
   the points the activation model was fitted to (batch 16 under each
   policy, 48 under ``full``, 32 under ``attn``), the Trainer with its
   background checkpoint's snapshot and ``superstep=4`` (its replays
   allocate nothing: the bytes at the snapshot plus the graph pool's free
   bytes); a batch-96 Trainer refused before a byte is allocated; the
   serving plan against a paged engine's state bytes; (b) the Trainer on a
   world-1 NCCL mesh under ``("fsdp", "tp")`` and ``("dp", "tp", "sp")``,
   f32 (6 layers) and bf16 compute, 4 steps, its losses against phase 11's
   unmeshed runs at phase 11's meshed readings (f32 1.3e-6, bf16 4e-4), its peak
   against the plan within 5%; (c) the Trainer at ``superstep=4`` (6
   layers, bf16 compute) on the mesh under ``dp`` and ``fsdp``, bit-equal to the
   per-step meshed run (logged losses and grad norms, every parameter),
   the captured ``fsdp`` step traced against its eager step, and K1 with a
   halo captured alone and replayed with new data, bit-equal;
17. decode under a mesh (``decode_mesh``, after phase 16): ProGen-small at
   full width and depth on world-1 NCCL meshes under ``(fsdp, tp)`` and
   ``(dp, tp, sp)``.  In bf16 compute: the prefill's logits against the
   unmeshed model's (0.1; f32 1e-3), a decode step on the unmeshed
   prefill's caches bit-equal to the unmeshed step; the sampler on phase
   4's first prime and noise (2 samples to 256) under both meshes, under
   ``(fsdp, tp)`` twice bit-equal, prefill ms and decode tokens/s beside
   the unmeshed sampler's on the same prime and length, the rank's
   parameter bytes and a decode step's peak; the engine under ``(fsdp,
   tp)`` on phase 7's 12 requests cut to 32 new tokens, dense, paged and
   8-bit, eager and warmed by ``aot_warmup``, warmed bit-equal to eager,
   tokens/s beside the unmeshed engine's.  The bf16 tokens are
   held, at least 0.98, to unmeshed runs whose K1 takes its halo entry
   with the zero window, as every meshed prefill does; against the plain
   unmeshed runs they are printed, not held: the halo entry is one bf16
   ulp from the plain launch and random weights' near-tied logits turn
   that into other tokens.  In f32 (the halo entry gives the plain
   launch's logits) the prefill's logits are held at 1e-3.  Two ranks on
   the one card meeting over gloo (``(1, 1, 2, 1)`` under ``tp``, f32, 6
   layers: the sampler on the first prime to 64, a paged and an 8-bit
   engine on two requests, at a rank's real widths, both ranks' tokens equal, at least
   0.98 of the unmeshed tokens); K1 with the zero halo (B 4, H 4), K2-fwd
   on 1024 channels, K3 and K3-q8 at d 1024 against their plain versions
   and timed in bf16, rows of the ``kernels`` line with the two f32 ranks'
   launches (``launches_of`` says so);
18. the multi-process fleet (``serve_fleet``, after phase 12): ProGen-small
   at full width and depth (the seeded init), one prefill worker and one
   decode replica of ``serve/``, each its own process on ``cuda:0``,
   answer phase 7's first requests cut to 64 new tokens (paged, 8 slots,
   chunk 32, page 16, the ``engine_disagg_paged`` prefill batch and
   handoff depth), the handles crossing as PGHF frames over loopback
   sockets: in f32, on 3 requests, the tokens identical to the in-process disaggregated
   engine's that ``build_engine_from_spec`` makes of the same spec; in
   bf16 compute with int8 weights and 8-bit pages, both workers warmed by
   ``aot_warmup``, on 6, at least 0.98 of them
   (the identical share printed).  Each worker's kernels come from its
   exit line: K1-fwd 12 and K2-fwd 2 a handle in the prefill worker only
   (f32 on ``wmma``/``fma``, bf16 on ``wgmma``), K3 or K3-q8 twice a
   decode step on ``bulk`` in the replica only; no CRC failure or desync,
   no prefill in the replica; worker start-up, tokens/s, median time to
   first token, frames, bytes, ``ser_s`` and ``de_s`` a frame, handle
   bytes a request, peak memory per process.  The bf16 fleet lives on
   into phase 19, which reads its workers' exit lines;
19. the elastic control plane (``serve_elastic``): phase 18's bf16 fleet,
   handed on alive, answers phase 7's 12 requests again (uids + 100): 6
   submitted, and after the 4th completion ``ControlPlane.swap_weights``
   rolls it to weight generation 1 (the same spec with ``init_seed`` + 1:
   a new decode replica warmed and routable, the prefill worker replaced,
   the old replica retired once its requests finished), the other 6 after
   it, then one ``tick`` with a forced scale-down (which must retire
   nothing: the sole instance of a stage stays).  Held: no request shed
   or dropped, every completion tagged with the generation that primed
   it, each generation's tokens at least 0.98 of an in-process engine on
   its weights (generation 0: phase 18's; generation 1: one run while the
   new workers warm), the identical shares printed, and every worker's
   launches, phase 18's bf16 runs included, by phase 18's formula;
   printed: the swap's seconds (new replica routable, prefill rolled, old
   retired), sheds, replays, ``controlz`` entries, peak memory per process;
20. a tensor-parallel replica group (``serve_tp_group``): ProGen-small at
   full width and 6 of its 12 layers (the seeded init), f32, eager, paged,
   8 slots, chunk 32, page 16, one prefill worker and one decode replica
   made of two processes on ``cuda:0`` meeting over gloo, each with its
   half of the heads and gate channels; phase 7's first 8 requests cut to
   32 new tokens.  Held: at least 0.98 of the in-process disaggregated
   engine's tokens (identical share printed), every slab frame the
   replicated leaves plus half the split ones, no CRC failure, desync or
   ``bad_frame``, both members at the same decode steps, the prefill
   worker's K1-fwd and K2-fwd per handle and each member's K3 twice a
   decode step on ``bulk`` at d 1024; printed: start-up, tokens/s, median
   time to first token, ``de_s`` a slab, peak memory per process;
15. the ``kernels`` line (the six halo rows included: bf16 and f32), a short
   ``trainer_summary`` line; then the card's ``nvidia-smi`` name and power
   limit and, last, ``{"ok": true, "device": {...}}``.

Every earlier phase runs at the depth and the step count it always had,
but for three cuts made with phase 14 to keep the whole near 900 s: phase
12 at half depth, the resumed runs of phase 8 without a sample hook and
its feed comparison at prefetch depths 0 and 2 once each (0, 2, 0, 2
before); one made with phase 16: phase 11's f32 Trainer runs at 6
layers (the K1 WMMA route's f32 step is the phase's time); and five made
with phase 17: phase 12 at 3 layers and its requests cut to 64 new tokens
(64-192 before), phase 14's Trainers at 6 layers and its timed runs at 8
steps, one traced repeat in phases 14 and 16 (three before), and phase
14's superstep and remat checks one eager run fewer each (the f32 step is
deterministic: no spread to measure); and four made with phase 18: phase
7's speculative runs and phase 13's speculative, reload and fault runs on
the requests cut to 64 new tokens (64-192 before), phase 17's samplers to
256 (512 before), its engines' requests to 32 new tokens (64 before), its
two ranks at 6 layers (12 before) and their sampler to 64 (128 before);
phase 18's in-process references run while its workers start; and nine
made with phases 19 and 20: phase 8's Trainer runs at 3 layers (12
before), phase 14's superstep Trainers and phase 16's meshed superstep
Trainers at 3 layers (6 before), phase 18's fleets on phase 7's first 3
(f32) and 6 (bf16) requests (12 before) and its bf16 fleet handed to
phase 19 instead of shut down and started again, the speculative runs of
phases 7 and 13 cut to 32 new tokens (64 before), phase 17's samplers to
64 (256 before), phase 9's LoRA decode step timed in two runs in turns (four
before), phase 20 at 6 layers; phases 19 and 20 run their in-process
references while their workers start.
The whole takes fifteen to twenty minutes on an H100 (by the host's
pace), the build included.
``engine_workloads_alone()`` runs phases 9 and 10 on their own,
``engine_lifecycle_alone()`` phase 12, ``engine_graphs_alone()`` phase 13
with the eager runs it compares against, ``trainer_superstep_alone()``
phase 14, ``trainer_mesh_alone()`` phase 16 with its own unmeshed runs,
``decode_mesh_alone()`` phase 17 with its own unmeshed runs,
``serve_fleet_alone()`` phase 18, ``serve_elastic_alone()`` phases 18
and 19, ``serve_tp_group_alone()`` phase 20.

There is no CPU fallback: without CUDA the script fails.  It imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import dataclasses
import datetime
import gc
import json
import queue as queue_module
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from progen_tpu_torch import kernels
from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed, make_mesh
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.prefetch import DevicePrefetcher
from progen_tpu_torch.data.synthetic import synthetic_uniref_batch
from progen_tpu_torch.data.tfrecord import iterator_from_tfrecords_folder
from progen_tpu_torch.data.tokenizer import encode_tokens
from progen_tpu_torch.decode import graphs, incremental
from progen_tpu_torch.decode.engine import Request, ServingEngine, run_with_restarts
from progen_tpu_torch.decode.handoff import FRAME_PREFIX_LEN, parse_prefix
from progen_tpu_torch.decode.prefill import make_embedder, make_prefiller, pad_prime_length
from progen_tpu_torch.decode.sampler import (
    make_chunked_sampler,
    make_sampler,
    teacher_forced_logits,
)
from progen_tpu_torch.models.configs import SMALL, draft_config_for
from progen_tpu_torch.models.progen import ProGen
from progen_tpu_torch.ops import cuda_attention, cuda_paged_gate_mix, cuda_sgu
from progen_tpu_torch.ops import paged_gate_mix as plain_paged
from progen_tpu_torch.observe.flops import H100_PEAK_BF16_FLOPS, mfu, model_flops_per_token
from progen_tpu_torch.ops.local_attention import (
    concat_previous_window,
    local_attention,
    local_attention_bwd,
    window_mask,
)
from progen_tpu_torch.ops.quant import quantize_rows, quantize_w
from progen_tpu_torch.observe.metrics import get_registry
from progen_tpu_torch.observe.trace import configure_tracing, merge_trace_dir, trace_dump_path
from progen_tpu_torch.observe.tracker import Tracker
from progen_tpu_torch.ops.sgu import gated_mix, spatial_gate_dgate, spatial_gate_dw
from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.watchdog import Watchdog
from progen_tpu_torch.serve import ServeCluster, build_engine_from_spec, make_spec
from progen_tpu_torch.serve import cluster as cluster_module
from progen_tpu_torch.serve.control import ControlPlane
from progen_tpu_torch.serve.policy import BurnRatePolicy, ScaleDecision
from progen_tpu_torch.train import trainer as trainer_module
from progen_tpu_torch import trace_main_path
from progen_tpu_torch.parallel.decode import decode_mesh as decode_view
from progen_tpu_torch.parallel.sharding import full_tensor, local, parallelize
from progen_tpu_torch.train import memory as memory_module
from progen_tpu_torch.train.loss import batch_loss
from progen_tpu_torch.train.memory import device_hbm_bytes, serving_plan
from progen_tpu_torch.train.memory import plan as memory_plan
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.schedule import make_lr_schedule
from progen_tpu_torch.train.step import make_train_functions
from progen_tpu_torch.train.lora import LoRAProGen, extract_adapters, lora_train_functions
from progen_tpu_torch.train.trainer import Trainer, TrainerConfig
from progen_tpu_torch.workloads import (
    ScaffoldSpec,
    bank_from_trained,
    bank_num_tenants,
    random_lora_bank,
)

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Tolerances, as atol = rtol.  One kernel: f32 differs from the plain
# version only in summation order (up to 1024 products per sum).  In bf16
# the outputs round to bf16 in different places (K1 rounds unnormalised
# probabilities, the plain version normalised ones).  K2's outputs are O(1)
# and are held at the JAX package's bf16 bar (tests/test_pallas_attention.py);
# K1's are an average of ~384 values, typically ~0.08, so its bf16 ``out``
# is held at 1e-2, a few bf16 ulps of its largest outputs.  Whole-model
# logits after 12 layers: f32 at 1e-3; bf16 at twice the one-kernel bar,
# since every layer adds its own bf16 rounding differences to the residual
# stream.
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
TOL_ATTN_OUT = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_MODEL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
# The backward kernels' gradients are sums of up to B*d = 16384 terms
# (K2-dW) whose size grows with the shape, so they are held at
# tol * max|plain| + tol * |plain|: an f32 sum of many O(1) terms carries
# an absolute rounding error of its largest partial sums, not of each
# output; bf16 also rounds p, ds and dout * res before the second products
# (a bf16 ulp, 0.4%, in other places than the plain version's einsums).
TOL_GRAD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# That bar alone lets a kernel drop part of its work: one of K2-dW's 256
# channel steps is ~0.06 of its RMS per element, under 2e-2 of the largest
# entry.  So the RMS error is also held at 1e-2 of the plain version's RMS
# in bf16 (both sides round the same bf16 operands; they differ in
# summation order and in a rare bf16 rounding flip) and 1e-4 in f32.
TOL_GRAD_RMS = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The f32 train step through the kernels against the plain versions:
# every gradient leaf at 1e-3 of its largest magnitude (12 layers of
# summation-order differences), the loss at 1e-4 relative; after three
# Adam steps each leaf's update (p3 - p0) at 1e-2 of its RMS, and no
# element farther than 6 * lr (a gradient element within rounding of zero
# may take Adam's +-lr step either way).
TOL_TRAIN_GRAD = 1e-3
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_UPDATE_RMS = 1e-2
TRAIN_BATCH = 8
TRAIN_STEPS = 12    # optimizer steps of the training path (accumulation 1)
TRAIN_WARMUP = 2    # steps left out of the median step time
TRAIN_LR = 2e-4
TRAINER_DATA = Path(__file__).resolve().parent / "train_data_synth"
TRAINER_STEPS = 8   # optimizer steps of run (a); run (b) stops at half, then resumes
TRAINER_EVERY = 4   # checkpoint and validation cadence of the trainer phase
TRAINER_HOST_BATCHES = 20  # batches timed on the host alone
TRAINER_DEPTH = 3   # the trainer phase's ProGen-small layers (12 before phase 19)
FEED_DEPTHS = (0, 2)  # the feed comparison's prefetch depths (0, 2, 0, 2 before phase 14)
FEED_STEPS = 12     # steps of each run of the feed comparison
# Resume skips timed on the reader alone: none, the largest an unshuffled
# resume takes on this corpus (it wraps the cursor), and looped skips as far
# as a large corpus's cursor would go, unshuffled and shuffled.
RESUME_SKIPS = ((0, 0), (1899, 0), (200_000, 0), (20_000, 64))
# How much farther from the f32 answer the bf16 decode may be than the bf16
# parallel forward, and the bf16 hidden states through the kernels than
# through the plain versions (two paths with equal bf16 rounding sit at a
# ratio ~1).
DECODE_VS_FORWARD_RATIO = 1.5
# The paged gate mix and its plain version multiply the same f32 values (a
# bf16 or int8 operand widens exactly) and differ only in the order of up to
# 1024 additions: every case, whatever the pool's and the weights' types, is
# held at 1e-5 * (1 + |plain|), the JAX package's bar for its own kernel
# (tests/test_paged.py); 3.1e-6 measured on an H100, on outputs up to 6.5.
TOL_PAGED = 1e-5
PAGED_POS = (0, 15, 16, 300, 511, 777, 1022, 1023)
ENGINE_SLOTS = 8
ENGINE_CHUNK = 32
ENGINE_PAGE = 16
ENGINE_REQUESTS = 12
ENGINE_TIGHT_PAGES = 2 + 96    # pool pages of the tight run, 2 reserved
ENGINE_TOKEN_MATCH = 0.98      # the JAX package's accuracy gate (bench_serving.py)
ENGINE_SPEC_K = 4              # draft tokens a speculative round (the CLI's default)
SPEC_NEW_TOKENS = 32           # the speculative runs' cap on the requests (64 before phase 19, 64-192 before phase 18)
SPIN_CYCLES = 40_000_000       # ~20 ms of device spin ahead of a timed run
FLUSH_BYTES = 256 << 20        # written before each cold call: five times L2
# The served workloads: a bank of 4 tenants (0 = the base) at rank 8, a
# best-of-4 fork; LoRA training at rank 8, lr 1e-3, 6 steps.  Embeddings
# through the kernels are held to the plain versions' at 0.05 of each row's
# largest plain value (an f32 mean of up to 512 bf16 rows; K2-fwd's own bf16
# bar), and the hidden states they pool no farther from the f32 model's than
# the plain versions' are, within DECODE_VS_FORWARD_RATIO (a mean dilutes an
# error confined to a few positions); the trained bank served as tenant 1 to the training forward's f32 logits
# at 1e-5 (the same kernels on the same shapes: only the bank's stacking
# differs).
LORA_TENANTS = 4
LORA_RANK = 8
WORKLOAD_FORKS = 4
LORA_TRAIN_STEPS = 6
LORA_TRAIN_LR = 1e-3
TOL_EMBED = 0.05
TOL_LORA_SERVE = 1e-5
SEED = 0
PRIME_LENGTHS = (37, 200, 300, 511)
SAMPLES_PER_PRIME = 2
AMINO = "ACDEFGHIKLMNPQRSTVWY"


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase; ``t`` is the seconds since the script
    started (a phase's time is the difference of two lines' ``t``)."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T0, 1),
                      **fields}), flush=True)


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` calls, after warm-up.
    The stream first spins for ~20 ms, so the host has every call enqueued
    before the first one starts: a kernel that runs shorter than the host
    takes to launch it would otherwise be timed at the host's pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_cold(fn, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` with the 50 MB L2 cold, as a decode
    step finds it (the model passes through L2 between two calls): each of
    ``iters`` calls follows a write of a 256 MB buffer and is bracketed by
    its own event pair, the median of the pairs is returned.  After one
    warm-up call, everything is enqueued behind a ~20 ms device spin, so
    the host's pace does not enter."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for i, (start, end) in enumerate(pairs):
        flush.fill_(i & 1)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs]))


def compare(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """Max abs/rel error and whether ``|got - want| <= tol + tol*|want|``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return {
        "max_abs_err": float(diff.max()),
        "max_rel_err": float((diff / want.abs().clamp_min(1e-6)).max()),
        "tol": tol,
        "ok": bool((diff <= tol + tol * want.abs()).all()),
    }


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 3: kernels against their plain versions ----------------------------


def attention_case(gen, b, h, n, d, wsz, dtype):
    """K1-fwd against its plain version; the launch must take the route
    the shape is meant for (the Hopper kernel for bf16, dim_head 64/128 and
    windows that are multiples of 128) and a second run must give the same
    bits (no atomics)."""
    route = ("wgmma" if dtype == torch.bfloat16 and d in (64, 128) and wsz % 128 == 0
             else "wmma")
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    before = dict(cuda_attention.fwd_route_launches)
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    torch.cuda.synchronize()
    routed = {r: cuda_attention.fwd_route_launches[r] - before[r] for r in before}
    ref_out, ref_lse = local_attention(q, k, v, window_size=wsz,
                                       return_lse=True)
    res_out = compare(out, ref_out, TOL_ATTN_OUT[dtype])
    res_lse = compare(lse, ref_lse, TOL[torch.float32])
    again = cuda_attention.local_attention_fwd(q, k, v, wsz)
    same = torch.equal(again[0], out) and torch.equal(again[1], lse)
    fields = {"shape": [b, h, n, d], "window": wsz, "dtype": str(dtype),
              "route": cuda_attention.fwd_route(dtype, d, wsz), "want_route": route,
              "launches_by_route": routed, "out": res_out, "lse": res_lse,
              "second_run_same_bits": same}
    emit("kernel_check", kernel="local_attention_fwd", **fields)
    require(res_out["ok"] and res_lse["ok"] and same
            and routed == {"wgmma": 0, "wmma": 0, route: 1},
            f"local_attention_fwd disagrees with its plain version: {fields}")
    return (q, k, v), max(res_out["max_abs_err"], res_lse["max_abs_err"])


def sgu_case(gen, b, n, d, weights, dtype):
    """K2-fwd against its plain version, on the route of its dtype (the
    Hopper kernel for bf16), a second run the same bits."""
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    res, gate = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                 for _ in range(2))
    if weights == "init":  # the model's init scale U(+-1e-3/n): mix ~ bias
        w = (torch.rand(n, n, device="cuda", generator=gen) * 2 - 1) * (1e-3 / n)
    else:  # N(0, 0.05): a mix far from the bias
        w = torch.randn(n, n, device="cuda", generator=gen) * 0.05
    w = w.to(dtype)
    bias = torch.ones(n, 1, device="cuda", dtype=dtype)
    before = dict(cuda_sgu.fwd_route_launches)
    out = cuda_sgu.spatial_gate_fwd(res, gate, w, bias)
    torch.cuda.synchronize()
    routed = {r: cuda_sgu.fwd_route_launches[r] - before[r] for r in before}
    result = compare(out, gated_mix(res, gate, w, bias), TOL[dtype])
    same = torch.equal(cuda_sgu.spatial_gate_fwd(res, gate, w, bias), out)
    fields = {"shape": [b, n, d], "weights": weights, "dtype": str(dtype),
              "route": cuda_sgu.fwd_route(dtype), "want_route": route,
              "launches_by_route": routed, "out": result, "second_run_same_bits": same}
    emit("kernel_check", kernel="sgu_fwd", **fields)
    require(result["ok"] and same and routed == {"wgmma": 0, "fma": 0, route: 1},
            f"sgu_fwd disagrees with its plain version: {fields}")
    return (res, gate, w, bias), result["max_abs_err"]


# K1-fwd's cases (b, h, n, d, wsz): in bf16 the first seven take the Hopper
# kernel (the "wgmma" route), the last two the WMMA kernel; f32 takes the
# WMMA kernel at the serving shape, the phantom window and the largest
# prefill.  The first two are timed (serving and training shapes).
K1_FWD_CASES = (
    (4, 8, 1024, 128, 256),             # ProGen-small's serving shape
    (TRAIN_BATCH, 8, 1024, 128, 256),   # ProGen-small's training shape
    (4, 8, 256, 128, 256),              # one window: the phantom window only
    (SAMPLES_PER_PRIME, 8, 512, 128, 256),  # the main path's largest prefill
    (2, 8, 1024, 64, 256),              # ProGen-tiny's head
    (1, 12, 2048, 128, 512),            # ProGen-base's window
    (1, 3, 512, 128, 128),              # the smallest window the route takes
    (2, 3, 1024, 32, 512),              # ProGen-default's head: WMMA
    (2, 8, 1024, 128, 64),              # a window under 128: WMMA
)
K1_FWD_F32_CASES = (K1_FWD_CASES[0], K1_FWD_CASES[2], K1_FWD_CASES[3])
# K2-fwd's cases (b, n, d, weights) at ProGen-small's gMLP width d = 2048
# unless given: both weight scales, batch 1 and 8, a ragged n (1000), the
# main path's largest prefill (512), n = 100 under one tile with d = 520
# (W padded to 16-byte rows on the Hopper route).  The second and third
# are timed (serving and training shapes).
K2_FWD_CASES = (
    (4, 1024, None, "init"),
    (4, 1024, None, "normal"),
    (TRAIN_BATCH, 1024, None, "normal"),
    (1, 1024, None, "normal"),
    (4, 1000, None, "normal"),
    (SAMPLES_PER_PRIME, 512, None, "normal"),
    (3, 100, 520, "normal"),
)
K2_FWD_F32_CASES = (K2_FWD_CASES[0], K2_FWD_CASES[1], K2_FWD_CASES[4], K2_FWD_CASES[5])


def attention_fwd_row(inputs, err, errs) -> dict:
    """CUDA-event times of K1-fwd, its plain version and one SDPA call on
    the masked ``[prev ‖ own]`` layout, with the bound, on ``inputs``."""
    q, k, v = inputs
    b, h, n, d = q.shape
    wsz = SMALL.window_size
    w = n // wsz
    qw = q.reshape(b, h * w, wsz, d)
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d)).reshape(b, h * w, 2 * wsz, d)
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d)).reshape(b, h * w, 2 * wsz, d)
    mask = window_mask(wsz, q.device)
    ms = time_ms(lambda: cuda_attention.local_attention_fwd(q, k, v, wsz))
    plain_ms = time_ms(lambda: local_attention(q, k, v, window_size=wsz,
                                               return_lse=True))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qw, kw, vw, attn_mask=mask, scale=d ** -0.5))
    esize = q.element_size()
    visible = sum(wsz + (i % wsz) + 1 for i in range(n))  # keys per (b, h)
    flops = 4.0 * d * visible * b * h
    nbytes = 4.0 * b * h * n * d * esize + 4.0 * b * h * n
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    return {
        "name": "local_attention_fwd", "route": "cuda",
        "fwd_route": cuda_attention.fwd_route(q.dtype, d, wsz),
        "source": "progen_tpu_torch/kernels/csrc/local_attention_fwd.cu",
        "replaces": "progen_tpu/ops/pallas_attention.py:65",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "timed_shape": [b, h, n, d], "timed_dtype": str(q.dtype),
        "bytes": nbytes, "flops": flops, "max_abs_err_all_checks": max(errs),
    }


def sgu_fwd_row(inputs, err, errs) -> dict:
    """CUDA-event times of K2-fwd, its plain version and the library call
    ``res * (matmul(tril(W), gate) + b)``, with the bound, on ``inputs``."""
    res, gate, wts, bias = inputs
    b, n, dd = gate.shape
    ms = time_ms(lambda: cuda_sgu.spatial_gate_fwd(res, gate, wts, bias))
    plain_ms = time_ms(lambda: gated_mix(res, gate, wts, bias))
    library_ms = time_ms(
        lambda: res * (torch.matmul(torch.tril(wts), gate) + bias).to(res.dtype))
    esize = gate.element_size()
    tri = n * (n + 1) / 2
    flops = 2.0 * b * dd * tri + 2.0 * b * n * dd
    nbytes = (3.0 * b * n * dd + tri + n) * esize
    bound_ms, bound_by = bound(nbytes, flops, gate.dtype)
    return {
        "name": "sgu_fwd", "route": "cuda", "fwd_route": cuda_sgu.fwd_route(gate.dtype),
        "source": "progen_tpu_torch/kernels/csrc/sgu_fwd.cu",
        "replaces": "progen_tpu/ops/pallas_sgu.py:128",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "timed_shape": [b, n, dd], "timed_dtype": str(gate.dtype),
        "bytes": nbytes, "flops": flops, "max_abs_err_all_checks": max(errs),
    }


def check_kernels() -> list[dict]:
    """K1-fwd and K2-fwd against their plain versions in every case above,
    each timed at the serving shape (the row of the ``kernels`` line) and
    at the training shape (under ``at_train_shape``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    half = SMALL.dim * SMALL.ff_mult // 2
    rows = []
    for case_fn, row_fn, cases, f32_cases, timed in (
            (attention_case, attention_fwd_row, K1_FWD_CASES, K1_FWD_F32_CASES, (0, 1)),
            (sgu_case, sgu_fwd_row,
             [(b, n, d or half, w) for b, n, d, w in K2_FWD_CASES],
             [(b, n, d or half, w) for b, n, d, w in K2_FWD_F32_CASES], (1, 2))):
        errs, kept = [], {}
        for dtype, todo in ((torch.bfloat16, cases), (torch.float32, f32_cases)):
            for i, case in enumerate(todo):
                inputs, err = case_fn(gen, *case, dtype)
                errs.append(err)
                if dtype == torch.bfloat16 and i in timed:
                    kept[i] = (inputs, err)
                else:
                    del inputs
        serving, training = (row_fn(*kept[i], errs) for i in timed)
        emit("kernel_time", **serving)
        emit("kernel_time", **training)
        serving["at_train_shape"] = {key: training[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "timed_shape",
            "max_abs_err")}
        rows.append(serving)
    return rows


def close_scaled(got: torch.Tensor, want: torch.Tensor, dtype) -> dict:
    """``compare`` with ``TOL_GRAD * max|want|`` added to the absolute bar,
    and the RMS error held at ``TOL_GRAD_RMS`` of the plain version's RMS."""
    tol = TOL_GRAD[dtype]
    want = want.float()
    scale = float(want.abs().max())
    result = compare(got, want, tol)
    diff = got.float() - want
    rms_want = float(want.pow(2).mean().sqrt())
    rms_err = float(diff.pow(2).mean().sqrt())
    result["ok"] = (bool((diff.abs() <= tol * scale + tol * want.abs()).all())
                    and rms_err <= TOL_GRAD_RMS[dtype] * rms_want)
    result.update(max_abs_want=scale, rms_err=rms_err, rms_want=rms_want,
                  tol_rms=TOL_GRAD_RMS[dtype])
    return result


def real_visible(n: int, wsz: int, halo: bool = False) -> int:
    """Visible (query, key) pairs per (b, h), the phantom window's left out:
    the backward kernels' work (phantom keys are zeros: nothing to dq, and
    their dk/dv are dropped).  With a halo window 0's previous window is
    real keys: every row sees wsz + i % wsz + 1 of them."""
    if halo:
        return sum(wsz + i % wsz + 1 for i in range(n))
    return sum(min(wsz + i % wsz + 1, i + 1) for i in range(n))


def attention_bwd_case(gen, b, h, n, d, wsz, dtype, route):
    """K1-dq and K1-dkv against the plain backward; ``route`` is the one the
    shape must take (``cuda_attention.bwd_route``), and a second run must
    give the same bits (no atomics)."""
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    dd = (do.float() * out.float()).sum(-1)
    before = dict(cuda_attention.bwd_route_launches)
    dq = cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz)
    dk, dv = cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz)
    torch.cuda.synchronize()
    routed = {r: cuda_attention.bwd_route_launches[r] - before[r] for r in before}
    want = local_attention_bwd(q, k, v, out, lse, do, wsz)
    res = {name: close_scaled(g, w, dtype)
           for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
    again = (cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz),
             *cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz))
    same = all(torch.equal(a, g) for a, g in zip(again, (dq, dk, dv)))
    fields = {"shape": [b, h, n, d], "window": wsz, "dtype": str(dtype),
              "route": cuda_attention.bwd_route(dtype, d, wsz), "want_route": route,
              "launches_by_route": routed, **res, "second_run_same_bits": same}
    emit("kernel_check", kernel="local_attention_bwd", **fields)
    require(all(r["ok"] for r in res.values()) and same
            and routed == {"wgmma": 0, "wmma": 0, route: 2},
            f"local_attention_bwd disagrees with its plain version: {fields}")
    return (q, k, v, do, out, lse, dd), res


def sgu_bwd_case(gen, b, n, d, dtype):
    res, gate, dout = (torch.randn(b, n, d, device="cuda", generator=gen).to(dtype)
                       for _ in range(3))
    w = (torch.randn(n, n, device="cuda", generator=gen) * 0.05).to(dtype)
    dgate = cuda_sgu.spatial_gate_dgate(w, dout, res)
    dw = cuda_sgu.spatial_gate_dw(dout, res, gate)
    torch.cuda.synchronize()
    checks = {"dgate": close_scaled(dgate, spatial_gate_dgate(w, dout, res), dtype),
              "dw": close_scaled(dw, spatial_gate_dw(dout, res, gate), dtype)}
    upper = int(torch.count_nonzero(torch.triu(dw, 1)))
    # no atomics and a fixed order of every sum: a second run, same bits
    same = (torch.equal(cuda_sgu.spatial_gate_dgate(w, dout, res), dgate)
            and torch.equal(cuda_sgu.spatial_gate_dw(dout, res, gate), dw))
    fields = {"shape": [b, n, d], "dtype": str(dtype), **checks,
              "dw_nonzero_above_diagonal": upper, "second_run_same_bits": same}
    emit("kernel_check", kernel="sgu_bwd", **fields)
    require(checks["dgate"]["ok"] and checks["dw"]["ok"] and upper == 0 and same,
            f"sgu_bwd disagrees with its plain version: {fields}")
    return (res, gate, dout, w), checks


# K1's backward cases (b, h, n, d, wsz): in bf16 the first five take the
# Hopper kernels (the "wgmma" route), the last two the WMMA kernels; f32
# takes the WMMA kernels at the training shape and the phantom window.
K1_BWD_CASES = (
    (TRAIN_BATCH, 8, 1024, 128, 256),   # ProGen-small's training shape
    (2, 8, 256, 128, 256),              # one window: the phantom window only
    (2, 8, 1024, 64, 256),              # ProGen-tiny's head
    (1, 12, 2048, 128, 512),            # ProGen-base's window
    (1, 3, 512, 128, 128),              # the smallest window the route takes
    (2, 3, 1024, 32, 512),              # ProGen-default's head: WMMA
    (2, 8, 1024, 128, 64),              # a window under 128: WMMA
)
K1_BWD_F32_CASES = K1_BWD_CASES[:2]


def check_backward_kernels() -> list[dict]:
    """K1-dq, K1-dkv, K2-dgate and K2-dW against their plain versions, at
    the training path's shapes, the single-window phantom case and other
    configs' heads and windows (K1), a ragged n and d (K2), in bf16 and f32;
    timed in bf16 at the training shapes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    c = SMALL
    d, h, wsz, b = c.dim_head, c.heads, c.window_size, TRAIN_BATCH
    rows = []

    errs = {"dq": [], "dk": [], "dv": []}
    for dtype, cases in ((torch.bfloat16, K1_BWD_CASES),
                         (torch.float32, K1_BWD_F32_CASES)):
        for case in cases:
            route = ("wgmma" if dtype == torch.bfloat16 and case[4] % 128 == 0
                     and case[3] in (64, 128) else "wmma")
            inputs, res = attention_bwd_case(gen, *case, dtype, route)
            if dtype == torch.bfloat16 and case == K1_BWD_CASES[0]:
                timed, timed_res = inputs, res
            for name in errs:
                errs[name].append(res[name]["max_abs_err"])
    q, k, v, do, out, lse, dd = timed
    n = q.shape[2]
    ms_dq = time_ms(lambda: cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz))
    ms_dkv = time_ms(lambda: cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz))
    plain_ms = time_ms(lambda: local_attention_bwd(q, k, v, out, lse, do, wsz), iters=5)
    library_ms = sdpa_backward_ms(q, k, v, do, wsz)
    esize = q.element_size()
    pairs = real_visible(n, wsz) * b * h
    vec = b * h * n * d * esize       # one (B, H, L, D) tensor
    rowvec = 4.0 * b * h * n          # one (B, H, L) f32 tensor
    for name, ms, flops, nbytes, line, grads in (
            ("local_attention_bwd_dq", ms_dq, 6.0 * d * pairs, 5 * vec + 2 * rowvec,
             126, ("dq",)),
            ("local_attention_bwd_dkv", ms_dkv, 8.0 * d * pairs, 6 * vec + 2 * rowvec,
             152, ("dk", "dv"))):
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        rows.append({
            "name": name, "route": "cuda",
            "bwd_route": cuda_attention.bwd_route(q.dtype, d, wsz),
            "source": "progen_tpu_torch/kernels/csrc/local_attention_bwd.cu",
            "replaces": f"progen_tpu/ops/pallas_attention.py:{line}",
            "launches": None,
            "max_abs_err": max(timed_res[g]["max_abs_err"] for g in grads),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "plain_and_library_compute": "dq, dk and dv in one call",
            "timed_shape": [b, h, n, d], "timed_dtype": str(q.dtype),
            "bytes": nbytes, "flops": flops,
            "max_abs_err_all_checks": max(e for g in grads for e in errs[g]),
        })
        emit("kernel_time", **rows[-1])

    half = c.dim * c.ff_mult // 2
    errs = {"dgate": [], "dw": []}
    # besides the training shape: batch 1, a ragged n, n = 100 (under one
    # tile, W padded to 16-byte rows), d = 520 (a ragged channel step)
    edges = ((1, c.seq_len, half), (b, 1000, half), (3, 100, 520), (2, 1000, 520))
    for dtype in (torch.bfloat16, torch.float32):
        inputs, res = sgu_bwd_case(gen, b, c.seq_len, half, dtype)
        if dtype == torch.bfloat16:
            timed, timed_res = inputs, res
        for name in errs:
            errs[name].append(res[name]["max_abs_err"])
        for shape in edges:
            edge = sgu_bwd_case(gen, *shape, dtype)[1]
            for name in errs:
                errs[name].append(edge[name]["max_abs_err"])
    res, gate, dout, w = timed
    b, n, dd_ = gate.shape
    esize = gate.element_size()
    tri = n * (n + 1) / 2
    flops = 2.0 * b * dd_ * tri + 1.0 * b * n * dd_
    dmix_flat = lambda: (dout * res).transpose(0, 1).reshape(n, b * dd_)
    gate_flat = gate.transpose(0, 1).reshape(n, b * dd_)
    for name, fn, plain, library, nbytes, line in (
            ("sgu_bwd_dgate", lambda: cuda_sgu.spatial_gate_dgate(w, dout, res),
             lambda: spatial_gate_dgate(w, dout, res),
             lambda: torch.matmul(torch.tril(w).T, dout * res),
             (3.0 * b * n * dd_ + tri) * esize, 150),
            ("sgu_bwd_dw", lambda: cuda_sgu.spatial_gate_dw(dout, res, gate),
             lambda: spatial_gate_dw(dout, res, gate),
             lambda: torch.tril(dmix_flat() @ gate_flat.T),
             (3.0 * b * n * dd_ + n * n) * esize, 170)):
        key = name.split("_")[-1]
        bound_ms, bound_by = bound(nbytes, flops, gate.dtype)
        rows.append({
            "name": name, "route": "cuda",
            "source": "progen_tpu_torch/kernels/csrc/sgu_bwd.cu",
            "replaces": f"progen_tpu/ops/pallas_sgu.py:{line}",
            "launches": None, "max_abs_err": timed_res[key]["max_abs_err"],
            "ms": time_ms(fn), "plain_ms": time_ms(plain), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": time_ms(library),
            "timed_shape": [b, n, dd_], "timed_dtype": str(gate.dtype),
            "bytes": nbytes, "flops": flops, "max_abs_err_all_checks": max(errs[key]),
        })
        if key == "dw":  # the split reduction's plan and workspace at this shape
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            splits, _ = cuda_sgu.dw_split(b, n, dd_, sms)
            rows[-1].update(splits=splits, sms=sms,
                            workspace_bytes=4 * cuda_sgu.dw_workspace_numel(n, splits))
        emit("kernel_time", **rows[-1])
    return rows


def sdpa_backward_ms(q, k, v, do, wsz) -> float:
    """One backward of ``scaled_dot_product_attention`` on the masked
    ``[prev ‖ own]`` layout, dq, dk and dv together."""
    b, h, n, d = q.shape
    w = n // wsz
    qw = q.reshape(b, h * w, wsz, d).detach().requires_grad_()
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d)).reshape(
        b, h * w, 2 * wsz, d).detach().requires_grad_()
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d)).reshape(
        b, h * w, 2 * wsz, d).detach().requires_grad_()
    out = F.scaled_dot_product_attention(qw, kw, vw, attn_mask=window_mask(wsz, q.device),
                                         scale=d ** -0.5)
    dow = do.reshape(b, h * w, wsz, d)
    return time_ms(lambda: torch.autograd.grad(out, (qw, kw, vw), dow,
                                               retain_graph=True))


# -- phase 4: the serving path ------------------------------------------------


def plain_versions():
    """Patch each kernel wrapper to its plain version (the reference run)."""
    def attention(q, k, v, window_size, scale=None, k_halo=None, v_halo=None):
        return local_attention(q, k, v, window_size=window_size, scale=scale,
                               return_lse=True, k_halo=k_halo, v_halo=v_halo)
    return (mock.patch.object(cuda_attention, "local_attention_fwd", attention),
            mock.patch.object(cuda_sgu, "spatial_gate_fwd", gated_mix))


def plain_backward_versions():
    """Patch each backward kernel wrapper to its plain version."""
    return (mock.patch.object(cuda_attention, "local_attention_bwd", local_attention_bwd),
            mock.patch.object(cuda_sgu, "spatial_gate_dgate", spatial_gate_dgate),
            mock.patch.object(cuda_sgu, "spatial_gate_dw", spatial_gate_dw))


COUNTERS = {
    "local_attention_fwd": (cuda_attention, "launches"),
    "local_attention_bwd_dq": (cuda_attention, "dq_launches"),
    "local_attention_bwd_dkv": (cuda_attention, "dkv_launches"),
    "local_attention_fwd_halo": (cuda_attention, "halo_launches"),
    "local_attention_bwd_dq_halo": (cuda_attention, "halo_dq_launches"),
    "local_attention_bwd_dkv_halo": (cuda_attention, "halo_dkv_launches"),
    "sgu_fwd": (cuda_sgu, "launches"),
    "sgu_bwd_dgate": (cuda_sgu, "dgate_launches"),
    "sgu_bwd_dw": (cuda_sgu, "dw_launches"),
    "paged_gate_mix": (cuda_paged_gate_mix, "launches"),
    "paged_gate_mix_q8": (cuda_paged_gate_mix, "q8_launches"),
}


# launches by route ("wgmma" and "bulk": the Hopper kernels, "wmma", "fma"
# and "simt": the first ones)
ROUTE_COUNTERS = {
    "local_attention_fwd": (cuda_attention, "fwd_route_launches"),
    "local_attention_bwd": (cuda_attention, "bwd_route_launches"),
    "sgu_fwd": (cuda_sgu, "fwd_route_launches"),
    "paged_gate_mix": (cuda_paged_gate_mix, "route_launches"),
}


def reset_counts() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)
    for module, attr in ROUTE_COUNTERS.values():
        setattr(module, attr, dict.fromkeys(getattr(module, attr), 0))


def read_routes() -> dict[str, dict[str, int]]:
    return {name: dict(getattr(module, attr))
            for name, (module, attr) in ROUTE_COUNTERS.items()}


def require_forward_routes(routes: dict, launches: dict, hopper: bool, what: str) -> None:
    """Every K1-fwd and K2-fwd launch of a run went through the Hopper
    kernels (``hopper``, bf16 at ProGen-small) or through the first ones."""
    for name, first in (("local_attention_fwd", "wmma"), ("sgu_fwd", "fma")):
        route = "wgmma" if hopper else first
        want = {**dict.fromkeys(routes[name], 0), route: launches[name]}
        require(routes[name] == want,
                f"{what}: {name} launches by route {routes[name]}, want {want}")


def read_counts() -> dict[str, int]:
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def serve(model) -> dict:
    """Answer the primes through the chunked sampler; returns what was run.
    The launch counts are set to 0 just before and read just after."""
    c = model.config
    rng = np.random.default_rng(SEED)
    primes = ["".join(rng.choice(list(AMINO), size=p)) for p in PRIME_LENGTHS]
    sampler = make_chunked_sampler(model, chunk_size=64)

    prefill_s = []
    steps = [0]
    prefill, step = sampler.prefill, sampler.step

    def timed_prefill(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(*args, **kwargs)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        return out

    def counted_step(*args, **kwargs):
        steps[0] += 1
        return step(*args, **kwargs)

    sampler.prefill, sampler.step = timed_prefill, counted_step
    answers = []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for i, text in enumerate(primes):
        tokens = torch.tensor([encode_tokens(text)] * SAMPLES_PER_PRIME,
                              device="cuda")
        before = cuda_attention.launches, cuda_sgu.launches
        # a generator per prime: the decode_mesh phase draws the same noise
        gen = torch.Generator(device="cuda").manual_seed(SEED + i)
        seq = sampler(tokens, c.seq_len, generator=gen, top_k=25,
                      add_bos=True, temperature=1.0)
        answers.append((text, seq, sampler.last_num_chunks,
                        [cuda_attention.launches - before[0],
                         cuda_sgu.launches - before[1]]))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    routes = read_routes()
    peak = torch.cuda.max_memory_allocated()
    require_forward_routes(routes, launches, True, "main path")

    for (text, seq, chunks, per_prefill), secs in zip(answers, prefill_s):
        p = len(text) + 1  # + BOS
        require(tuple(seq.shape) == (SAMPLES_PER_PRIME, c.seq_len),
                f"sample shape {tuple(seq.shape)}")
        require(bool(((seq >= 0) & (seq < c.num_tokens)).all()),
                "sampled token out of the vocabulary")
        want = torch.tensor(encode_tokens(text), device="cuda")
        require(bool((seq[:, 1:p] == want).all()), "prime not kept in the sample")
        require(per_prefill == [c.depth, c.global_mlp_depth],
                f"one prefill launched the kernels {per_prefill} times")
        emit("answer", prime_len=len(text), launches=per_prefill,
             p_pad=pad_prime_length(p, c.window_size, c.seq_len),
             chunks=chunks, prefill_ms=secs * 1e3,
             sample=[int(t) for t in seq[0, p:p + 16]])
    prefills = len(primes)
    want = {name: 0 for name in COUNTERS}
    want.update(local_attention_fwd=c.depth * prefills,
                sgu_fwd=c.global_mlp_depth * prefills)
    require(launches == want, f"kernel launches {launches}, want {want}")
    decode_s = total_s - sum(prefill_s)
    tokens = steps[0] * SAMPLES_PER_PRIME
    return {"launches": launches, "fwd_launches_by_route": {
                k: routes[k] for k in ("local_attention_fwd", "sgu_fwd")},
            "tokens": [seq for _, seq, _, _ in answers],
            "prefills": prefills,
            "prefill_ms": [s * 1e3 for s in prefill_s],
            "decode_steps": steps[0], "decode_tokens": tokens,
            "decode_tokens_per_s": tokens / decode_s, "total_s": total_s,
            "peak_bytes": peak}


def check_prefill_against_plain(model) -> dict:
    """Prefill last-logits through the kernels vs through the plain
    versions, on the card, at the longest prime's padded length, in the
    model's compute dtype."""
    c = model.config
    rng = np.random.default_rng(SEED + 1)
    p = PRIME_LENGTHS[-1] + 1
    p_pad = pad_prime_length(p, c.window_size, c.seq_len)
    tokens = torch.tensor(rng.integers(1, c.num_tokens, size=(2, p_pad)),
                          device="cuda")
    lengths = torch.tensor([p, p // 2], device="cuda")
    prefill = make_chunked_sampler(model).prefill
    got, _ = prefill(tokens, lengths, decode_len=c.seq_len)
    attn_patch, sgu_patch = plain_versions()
    with attn_patch, sgu_patch:
        want, _ = prefill(tokens, lengths, decode_len=c.seq_len)
    result = compare(got, want, TOL_MODEL[model.policy.compute_dtype])
    result["dtype"] = str(model.policy.compute_dtype)
    result["max_abs_logit"] = float(want.abs().max())
    require(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    require(result["ok"], f"kernel prefill disagrees with plain: {result}")
    return result


def decode_tokens(c) -> torch.Tensor:
    """Two rows of two windows of tokens, for the decode checks."""
    rng = np.random.default_rng(SEED + 2)
    return torch.tensor(rng.integers(1, c.num_tokens, size=(2, 2 * c.window_size)),
                        device="cuda")


def errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got - want).float()
    return {"max_abs_err": float(diff.abs().max()),
            "rms_err": float(diff.pow(2).mean().sqrt())}


def check_decode_against_forward(model) -> dict:
    """At f32, the cached decode step (plain PyTorch) reproduces the
    parallel forward (through the kernels' f32 path) position by position,
    over two windows at ProGen-small width."""
    tokens = decode_tokens(model.config)
    with torch.no_grad():
        parallel = model(tokens)
    stepped = teacher_forced_logits(model, tokens)
    result = {**errors(stepped, parallel), "tol": TOL_MODEL[torch.float32],
              "tokens": list(tokens.shape),
              "max_abs_logit": float(parallel.abs().max())}
    require(result["max_abs_err"] <= result["tol"],
            f"decode step disagrees with the forward: {result}")
    return result


def check_bf16_decode_against_f32(model, reference) -> dict:
    """The main path's bf16 decode step against the f32 answer.

    The bf16 decode and the bf16 parallel forward round in different places,
    so neither is the other's reference; the f32 parallel forward of the
    same weights (``reference``, checked above against its decode and the
    plain versions) is.  The bf16 decode must stay as close to it as the
    bf16 forward does, within half again, in RMS and in max error."""
    require(all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  reference.parameters())),
            "the f32 reference does not hold the bf16 model's weights")
    tokens = decode_tokens(model.config)
    with torch.no_grad():
        want = reference(tokens)
        parallel = model(tokens)
    stepped = teacher_forced_logits(model, tokens)
    require(bool(torch.isfinite(stepped).all()), "non-finite decode logits")
    fwd, dec = errors(parallel, want), errors(stepped, want)
    result = {"tokens": list(tokens.shape), "dtype": str(model.policy.compute_dtype),
              "forward_vs_f32": fwd, "decode_vs_f32": dec,
              "decode_vs_forward": errors(stepped, parallel),
              "max_ratio": DECODE_VS_FORWARD_RATIO,
              "max_abs_logit": float(want.abs().max())}
    require(all(dec[k] <= DECODE_VS_FORWARD_RATIO * fwd[k] for k in dec),
            f"bf16 decode is farther from the f32 answer than the bf16 forward: {result}")
    return result


# -- phase 5: the training path -----------------------------------------------


def train_batches(c, batch: int, steps: int, seed: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(synthetic_uniref_batch(rng, batch, c.seq_len)).cuda()
            for _ in range(steps)]


def train(model) -> dict:
    """TRAIN_STEPS optimizer steps of ``model`` on synthetic rows through
    ``train/step.py``; the launch counts are set to 0 just before and read
    just after."""
    c = model.config
    fns = make_train_functions(model.train(), make_optimizer(TRAIN_LR))
    state = fns.init_state()
    batches = train_batches(c, TRAIN_BATCH, TRAIN_STEPS, SEED)
    losses, grad_norms, step_s = [], [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = fns.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        grad_norms.append(float(metrics["grad_norm"]))
    torch.cuda.synchronize()
    launches = read_counts()
    all_routes = read_routes()
    routes = all_routes["local_attention_bwd"]
    peak = torch.cuda.max_memory_allocated()

    per_step = {"local_attention_fwd": c.depth, "local_attention_bwd_dq": c.depth,
                "local_attention_bwd_dkv": c.depth, "sgu_fwd": 2 * c.global_mlp_depth,
                "sgu_bwd_dgate": c.global_mlp_depth, "sgu_bwd_dw": c.global_mlp_depth}
    want = {name: per_step.get(name, 0) * TRAIN_STEPS for name in COUNTERS}
    require(launches == want, f"training launches {launches}, want {want}")
    # every K1 backward launch of the bf16 step on the Hopper kernels
    want_routes = {"wgmma": 2 * c.depth * TRAIN_STEPS, "wmma": 0}
    require(routes == want_routes, f"K1 backward routes {routes}, want {want_routes}")
    # and every K1-fwd and K2-fwd launch (d_res included) on the Hopper kernels
    require_forward_routes(all_routes, launches, True, "train")
    require(all(np.isfinite(losses)) and all(np.isfinite(grad_norms)),
            f"non-finite training loss or grad norm: {losses}, {grad_norms}")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    step_ms = float(np.median(step_s[TRAIN_WARMUP:])) * 1e3
    tokens = TRAIN_BATCH * c.seq_len
    params = sum(p.numel() for p in model.parameters())
    rate = tokens / (step_ms / 1e3)
    return {"launches": launches, "launches_per_step": per_step,
            "k1_bwd_launches_by_route": routes,
            "fwd_launches_by_route": {k: all_routes[k]
                                      for k in ("local_attention_fwd", "sgu_fwd")},
            "steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq_len": c.seq_len,
            "params": params, "losses": losses, "grad_norms": grad_norms,
            "step_ms_median": step_ms, "step_ms": [s * 1e3 for s in step_s],
            "tokens_per_s": rate,
            "mfu": mfu(rate, model_flops_per_token(c, params)),
            "mfu_peak_flops": H100_PEAK_BF16_FLOPS, "peak_bytes": peak}


def check_train_against_plain(lora: bool = False) -> dict:
    """At f32, ProGen-small, batch 2: one train step through the kernels
    against the same step through the plain versions (loss and every
    gradient leaf), then each leaf's update after three steps.  With
    ``lora``, the same for ``LoRAProGen`` at rank 8 through
    ``train/lora.py`` (the frozen base's gradients included; its updates
    are zero on both sides), but the loss is held at every step and the
    updates by their largest difference only: ``b`` starts at zero, so
    Adam's first steps move each factor element by about +-lr whatever its
    gradient's size, and an element whose gradient sits within rounding of
    zero steps either way: one such element is 1.1% of the RMS of a leaf of
    8192, where the base model's leaves are large enough to absorb it."""
    c = SMALL
    batches = train_batches(c, 2, 3, SEED + 4)
    lr = LORA_TRAIN_LR if lora else TRAIN_LR
    runs = []
    for plain in (False, True):
        if lora:
            model = LoRAProGen(c, LORA_RANK, make_policy(False), device="cuda", seed=SEED)
            fns = lora_train_functions(model, learning_rate=lr)
        else:
            model = ProGen(c, make_policy(False), device="cuda", seed=SEED)
            fns = make_train_functions(model, make_optimizer(lr))
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = fns.init_state()
        patches = (*plain_versions(), *plain_backward_versions()) if plain else ()
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            losses, grads = [], None
            for batch in batches:
                state, metrics = fns.train_step(state, batch)
                losses.append(float(metrics["loss"]))
                if grads is None:
                    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        updates = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
        runs.append((losses, grads, updates))
        del model, state, fns, p0
    (losses, grads, updates), (want_losses, want_grads, want_updates) = runs

    grad_err = {}
    for name, g in grads.items():
        scale = float(want_grads[name].abs().max())
        grad_err[name] = float((g - want_grads[name]).abs().max()) / max(scale, 1e-30)
    update_err, update_max = {}, 0.0
    for name, u in updates.items():
        diff = u - want_updates[name]
        rms = float(want_updates[name].pow(2).mean().sqrt())
        update_err[name] = float(diff.pow(2).mean().sqrt()) / max(rms, 1e-30)
        update_max = max(update_max, float(diff.abs().max()))
    held = len(losses) if lora else 1
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses[:held], want_losses[:held]))
    worst_grad = max(grad_err, key=grad_err.get)
    worst_update = max(update_err, key=update_err.get)
    result = {"model": "LoRAProGen rank 8" if lora else "ProGen",
              "dtype": "torch.float32", "batch": 2, "steps": 3,
              "losses": losses, "plain_losses": want_losses,
              "loss_rel_err": loss_err, "loss_steps_held": held,
              "loss_tol": TOL_TRAIN_LOSS,
              "grad_leaves": len(grad_err), "worst_grad_leaf": worst_grad,
              "worst_grad_rel_err": grad_err[worst_grad], "grad_tol": TOL_TRAIN_GRAD,
              "worst_update_leaf": worst_update,
              "worst_update_rms_rel_err": update_err[worst_update],
              "update_rms_tol": None if lora else TOL_TRAIN_UPDATE_RMS,
              "update_max_abs_err": update_max, "update_max_tol": 6 * lr}
    require(loss_err <= TOL_TRAIN_LOSS and grad_err[worst_grad] <= TOL_TRAIN_GRAD
            and (lora or update_err[worst_update] <= TOL_TRAIN_UPDATE_RMS)
            and update_max <= 6 * lr,
            f"the train step through the kernels disagrees with plain: {result}")
    return result

# -- phase 8: the Trainer over tfrecords, checkpoints and resume ---------------


def trainer_config(max_steps: int, **overrides) -> TrainerConfig:
    return dataclasses.replace(TrainerConfig(
        seed=SEED, batch_size=TRAIN_BATCH, grad_accum_every=1, learning_rate=TRAIN_LR,
        validate_every=TRAINER_EVERY, checkpoint_every=TRAINER_EVERY,
        sample_every=TRAINER_STEPS, checkpoint_keep_n=1, mixed_precision=True,
        prefetch_depth=2, background_checkpoint=True, log_every=1, max_steps=max_steps),
        **overrides)


def run_trainer(c, ckpt: Path, runs: Path, max_steps: int, device, **overrides):
    """One ``Trainer`` over ``train_data_synth/`` to ``max_steps``, resuming
    from ``ckpt`` when it holds a checkpoint; returns the trainer, its
    result, each train step's kernel launches and the tracker's rows."""
    trainer = Trainer(c, trainer_config(max_steps, **overrides), str(TRAINER_DATA),
                      str(ckpt), tracker=Tracker(out_dir=str(runs), use_wandb=False),
                      device=device)
    per_step = []
    real_step = trainer.fns.train_step

    def counted_step(state, batch):
        before = read_counts()
        out = real_step(state, batch)
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        return out

    trainer.fns = dataclasses.replace(trainer.fns, train_step=counted_step)
    result = trainer.run()
    trainer.tracker.finish()
    rows = [json.loads(line) for f in runs.glob("*/metrics.jsonl")
            for line in f.read_text().splitlines()]
    return trainer, result, per_step, rows


def host_batch_ms(c) -> float:
    """Host milliseconds to read, check and collate one batch of the
    trainer's stream (no device work)."""
    _, get_train = iterator_from_tfrecords_folder(str(TRAINER_DATA), "train")
    it = get_train(seq_len=c.seq_len, batch_size=TRAIN_BATCH, loop=True)
    next(it)  # the open
    t0 = time.perf_counter()
    for _ in range(TRAINER_HOST_BATCHES):
        next(it)
    return (time.perf_counter() - t0) / TRAINER_HOST_BATCHES * 1e3


def resume_open_seconds(c) -> list[dict]:
    """Seconds from asking the reader for a stream at each of RESUME_SKIPS
    to its first batch, and the seconds a skipped record costs."""
    _, get_train = iterator_from_tfrecords_folder(str(TRAINER_DATA), "train")
    out = []
    for skip, shuffle in RESUME_SKIPS:
        t0 = time.perf_counter()
        next(get_train(seq_len=c.seq_len, batch_size=TRAIN_BATCH, skip=skip, loop=True,
                       shuffle_buffer=shuffle, seed=SEED))
        out.append({"skip": skip, "shuffle_buffer": shuffle,
                    "seconds": time.perf_counter() - t0})
    base = out[0]["seconds"]  # skip 0: the open and one batch
    for row in out:
        if row["skip"]:
            row["us_per_skipped_record"] = (row["seconds"] - base) / row["skip"] * 1e6
    return out


class TimedPrefetcher(DevicePrefetcher):
    """The trainer's feed, noting for each batch the loop takes whether it
    was queued already and how many ms the take lasted."""

    takes: list = []

    def __next__(self):
        queued = self._q.qsize() > 0
        t0 = time.perf_counter()
        out = super().__next__()
        TimedPrefetcher.takes.append((queued, (time.perf_counter() - t0) * 1e3))
        return out


def feed_comparison(c, root: Path, device) -> list[dict]:
    """The Trainer with no hooks for FEED_STEPS steps at each prefetch depth
    of FEED_DEPTHS: the median step and the loop's median wait
    for a batch; with the prefetcher, the share of takes that found a batch
    queued and the median take then."""
    out = []
    with mock.patch.object(trainer_module, "DevicePrefetcher", TimedPrefetcher):
        for i, depth in enumerate(FEED_DEPTHS):
            TimedPrefetcher.takes = []
            never = 10 * FEED_STEPS
            trainer, _, _, rows = run_trainer(
                c, root / f"ck_feed{i}", root / f"runs_feed{i}", FEED_STEPS, device,
                prefetch_depth=depth, checkpoint_every=never, validate_every=never,
                sample_every=never, background_checkpoint=False)
            del trainer
            shutil.rmtree(root / f"ck_feed{i}")
            gc.collect()
            step = [r["step_ms"] for r in rows if "step_ms" in r][TRAIN_WARMUP:]
            wait = [r["data_wait_ms"] for r in rows if "data_wait_ms" in r][TRAIN_WARMUP:]
            row = {"prefetch_depth": depth, "step_ms_median": float(np.median(step)),
                   "data_wait_ms_median": float(np.median(wait))}
            takes = TimedPrefetcher.takes[TRAIN_WARMUP:]
            if takes:
                queued = [ms for ready, ms in takes if ready]
                row["queued_share"] = len(queued) / len(takes)
                row["take_ms_median_when_queued"] = (float(np.median(queued))
                                                     if queued else None)
            out.append(row)
    return out


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def trainer_phase(c=SMALL, device="cuda") -> dict:
    """The ``Trainer`` path: (a) TRAINER_STEPS uninterrupted steps with
    background checkpoints, validation and a sample; (c) its last
    checkpoint's params, restored into a fresh model, give the in-memory
    model's prefill logits bit for bit; (b) half the steps into a fresh
    store, then a new ``Trainer`` resumes to TRAINER_STEPS: its losses and
    final params equal (a)'s bit for bit.  The launch counts are set to 0
    just before (a) and read just after.  Runs in a temporary directory it
    deletes."""
    half = TRAINER_STEPS // 2
    cuda = torch.device(device).type == "cuda"
    root = Path(tempfile.mkdtemp(prefix="progen-smoke-trainer-"))
    sigterm = signal.getsignal(signal.SIGTERM)  # each Trainer takes SIGTERM
    try:
        free_bytes = shutil.disk_usage(root).free
        host_ms = host_batch_ms(c)
        resume_open = resume_open_seconds(c)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        a, out_a, per_step_a, rows_a = run_trainer(c, root / "ck_a", root / "runs_a",
                                                   TRAINER_STEPS, device)
        seconds_a = time.perf_counter() - t0
        launches, routes = read_counts(), read_routes()
        peak = torch.cuda.max_memory_allocated() if cuda else None
        saved_steps = a.store.all_steps()
        ckpt_bytes = dir_bytes(a.store.step_dir(saved_steps[-1]))
        losses_a = {r["step"]: r["loss"] for r in rows_a if "loss" in r}
        final_a = {k: v.detach().cpu() for k, v in out_a["state"].params.items()}

        # (c) the stored params through restore_params into a fresh model
        _, get_valid = iterator_from_tfrecords_folder(str(TRAINER_DATA), "valid")
        rows = next(get_valid(seq_len=c.seq_len, batch_size=2))
        tokens = torch.from_numpy(rows[:, :2 * c.window_size]).to(device)
        fresh = ProGen(c, make_policy(True), device=device, seed=SEED + 1).eval()
        t1 = time.perf_counter()
        fresh.load_state_dict(a.store.restore_params(map_location=device))
        if cuda:
            torch.cuda.synchronize()
        restore_params_s = time.perf_counter() - t1
        with torch.no_grad():
            logits_restored, logits_live = fresh(tokens), a.model.eval()(tokens)
        restored_equal = bool(torch.equal(logits_restored, logits_live))
        ckpt_log_a = a.checkpoint_log
        del a, out_a, fresh, logits_restored, logits_live
        shutil.rmtree(root / "ck_a")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        # (b) half, then a new Trainer resumes over the same store
        # no sample hook in (b): the sample of (a) is the phase's; the
        # resume is about the train state
        never = 10 * TRAINER_STEPS
        b1, out_b1, per_step_b1, _ = run_trainer(c, root / "ck_b", root / "runs_b1", half,
                                                 device, sample_every=never)
        ckpt_log_b = b1.checkpoint_log
        del b1, out_b1
        gc.collect()
        b2, out_b2, per_step_b2, rows_b2 = run_trainer(c, root / "ck_b", root / "runs_b2",
                                                       TRAINER_STEPS, device,
                                                       sample_every=never)
        losses_b2 = {r["step"]: r["loss"] for r in rows_b2 if "loss" in r}
        final_b2 = {k: v.detach().cpu() for k, v in out_b2["state"].params.items()}
        restore_s = b2.restore_seconds
        ckpt_log_b += b2.checkpoint_log
        del b2, out_b2
        differ = [k for k in final_a if not torch.equal(final_a[k], final_b2[k])]
        want_losses = {s: losses_a[s] for s in range(half + 1, TRAINER_STEPS + 1)}
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        feed = feed_comparison(c, root, device)
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(root, ignore_errors=True)

    step_ms = [r["step_ms"] for r in rows_a if "step_ms" in r]
    data_wait = [r["data_wait_ms"] for r in rows_a if "data_wait_ms" in r]
    steady = slice(TRAIN_WARMUP, None)
    result = {
        "steps": TRAINER_STEPS, "batch": TRAIN_BATCH, "seq_len": c.seq_len,
        "checkpoint_every": TRAINER_EVERY, "validate_every": TRAINER_EVERY,
        "sample_every": TRAINER_STEPS, "resumed_at": half,
        "run_a_seconds": seconds_a, "losses": [losses_a[s] for s in sorted(losses_a)],
        "step_ms": step_ms, "step_ms_median": float(np.median(step_ms[steady])),
        "tokens_per_s": TRAIN_BATCH * c.seq_len / (float(np.median(step_ms[steady])) / 1e3),
        "mfu": mfu(TRAIN_BATCH * c.seq_len / (float(np.median(step_ms[steady])) / 1e3),
                   model_flops_per_token(c, sum(p.numel() for p in final_a.values()))),
        # the meter's window at the last logged step (hooks excluded, the
        # steps a background save slows included)
        "meter_tokens_per_s": next((r["tokens_per_sec_per_chip"] for r in reversed(rows_a)
                                    if "tokens_per_sec_per_chip" in r), None),
        "meter_mfu": next((r["mfu"] for r in reversed(rows_a) if "mfu" in r), None),
        "host_batch_ms": host_ms, "data_wait_ms": data_wait,
        "data_wait_ms_median": float(np.median(data_wait[steady])),
        "prefetch_hides_host": bool(np.median(data_wait[steady]) < 0.5 * host_ms),
        "feed": feed, "resume_open": resume_open,
        "checkpoints_a": ckpt_log_a, "checkpoints_b": ckpt_log_b,
        "saved_steps_a": saved_steps, "checkpoint_bytes": ckpt_bytes,
        "disk_free_bytes": free_bytes, "restore_state_s": restore_s,
        "restore_params_s": restore_params_s, "peak_bytes": peak,
        "launches": launches, "routes": routes,
        "per_step_launches": per_step_a + per_step_b1 + per_step_b2,
        "resumed_losses": [losses_b2.get(s) for s in sorted(want_losses)],
        "resumed_losses_equal": losses_b2 == want_losses,
        "resumed_params_equal": not differ, "resumed_params_differ": differ[:8],
        "restored_logits_equal": restored_equal,
    }
    require(result["resumed_losses_equal"],
            f"resumed losses {losses_b2} differ from the uninterrupted {want_losses}")
    require(not differ, f"resumed final params differ from the uninterrupted: {differ[:8]}")
    require(restored_equal, "restored params give other prefill logits")
    require(all(np.isfinite(result["losses"])), f"non-finite losses {result['losses']}")
    return result


def require_trainer_launches(result: dict, c) -> None:
    """Every train step of the trainer ran each K1/K2 kernel as often as
    the bare train step does, every K1 launch and every K2-fwd launch on
    the Hopper kernels."""
    per_step = {"local_attention_fwd": c.depth, "local_attention_bwd_dq": c.depth,
                "local_attention_bwd_dkv": c.depth, "sgu_fwd": 2 * c.global_mlp_depth,
                "sgu_bwd_dgate": c.global_mlp_depth, "sgu_bwd_dw": c.global_mlp_depth}
    want = {name: per_step.get(name, 0) for name in COUNTERS}
    bad = [i for i, got in enumerate(result["per_step_launches"]) if got != want]
    require(not bad, f"trainer steps {bad} launched other than {want}")
    launches, routes = result["launches"], result["routes"]
    require(all(launches[k] > 0 for k in per_step),
            f"a kernel of the trainer path was not launched: {launches}")
    want_bwd = {"wgmma": 2 * c.depth * TRAINER_STEPS, "wmma": 0}
    require(routes["local_attention_bwd"] == want_bwd,
            f"trainer K1 backward routes {routes['local_attention_bwd']}, want {want_bwd}")
    require_forward_routes(routes, launches, True, "trainer")


# -- phase 6: the paged gate mix against its plain version --------------------


def paged_case(gen, n, d, ps, pos, pool_dtype, outside: bool = False) -> dict:
    """A pool of random rows (garbage in the dump page and in every row past
    a request's position; page 0 zeros), tables that name random pages up to
    each row's last page and NULL beyond, and the int8 twins of the weights
    (per row) and of the pool (per pool row).  ``outside``: every table
    entry past a row's last page names a page past the pool, and one used
    entry of each of the first two rows names one outside it (-1 and
    num_pages + 7), which the kernels skip; the plain version, which
    gathers every entry, is given NULL in their place (the zero page adds
    what a skipped page adds)."""
    batch = len(pos)
    ppr = -(-n // ps)
    num_pages = 2 + batch * ppr
    pool = torch.randn(num_pages, ps, d, device="cuda", generator=gen)
    pool[0] = 0.0
    perm = (torch.randperm(num_pages - 2, device="cuda", generator=gen) + 2).int()
    table = torch.zeros(batch, ppr, dtype=torch.int32, device="cuda")
    for b, p in enumerate(pos):
        used = p // ps + 1
        table[b, :used] = perm[b * ppr: b * ppr + used]
    plain_table = table.clone()
    if outside:
        for b, p in enumerate(pos):
            table[b, p // ps + 1:] = num_pages + b
        for b, bad in ((0, -1), (1, num_pages + 7)):
            table[b, pos[b] // ps] = bad
            plain_table[b, pos[b] // ps] = 0
    w = torch.randn(n, n, device="cuda", generator=gen) * 0.05
    bias = torch.randn(n, 1, device="cuda", generator=gen)
    wq, ws = quantize_w(w, channel_axis=0)
    pq, pscale = quantize_rows(pool)
    return {"w": w, "bias": bias, "pool": pool.to(pool_dtype), "table": table,
            "plain_table": plain_table,
            "pos": torch.tensor(pos, dtype=torch.int32, device="cuda"),
            "wq": wq, "ws": ws, "pq": pq, "pscale": pscale, "n": n, "d": d,
            "ps": ps, "rows_read": sum(p + 1 for p in pos)}


PAGED_VARIANTS = {
    # name -> (weights, pool, w_scale, pool_scale) keys of a paged case
    "f32_w": ("w", "pool", None, None),
    "int8_w_int8_pool": ("wq", "pq", "ws", "pscale"),
    "int8_w_bf16_pool": ("wq", "pool", "ws", None),
    "f32_w_int8_pool": ("w", "pq", None, "pscale"),
}


def paged_args(case: dict, variant: str):
    w, pool, ws, pscale = PAGED_VARIANTS[variant]
    return ((case[w], case["bias"], case[pool], case["table"], case["pos"]),
            {"n_rows": case["n"], "w_scale": case[ws] if ws else None,
             "pool_scale": case[pscale] if pscale else None})


def paged_check(name: str, case: dict, variant: str, kernel: str,
                want_route: str | None = "bulk") -> float:
    """One case through the wrapper, twice: both launches on ``want_route``
    (or on the route ``cuda_paged_gate_mix.route`` names, for None), the
    same bits both times, and 1e-5 * (1 + |plain|) from the plain version
    (given ``plain_table``)."""
    args, kwargs = paged_args(case, variant)
    route = want_route or cuda_paged_gate_mix.route(args[2].dtype, case["d"])
    before = dict(cuda_paged_gate_mix.route_launches)
    got = cuda_paged_gate_mix.paged_gate_mix(*args, **kwargs)
    again = cuda_paged_gate_mix.paged_gate_mix(*args, **kwargs)
    torch.cuda.synchronize()
    routed = {r: cuda_paged_gate_mix.route_launches[r] - before[r] for r in before}
    want = plain_paged.paged_gate_mix(*args[:3], case["plain_table"], *args[4:], **kwargs)
    diff = (got - want).abs()
    ok = bool((diff <= TOL_PAGED * (1 + want.abs())).all())
    fields = {"case": name, "variant": variant, "pool_dtype": str(args[2].dtype),
              "shape": {"B": len(case["pos"]), "n": case["n"], "d": case["d"],
                        "page_size": case["ps"]},
              "mix_route": route, "launches_by_route": routed,
              "same_bits_on_rerun": bool(torch.equal(got, again)),
              "max_abs_err": float(diff.max()), "max_abs_out": float(want.abs().max()),
              "tol": TOL_PAGED, "ok": ok}
    emit("kernel_check", kernel=kernel, **fields)
    require(bool(torch.isfinite(got).all()) and ok,
            f"{kernel} disagrees with its plain version: {fields}")
    require(routed == {**dict.fromkeys(before, 0), route: 2},
            f"{kernel} {name}: launches by route {routed}, want 2 on {route}")
    require(fields["same_bits_on_rerun"], f"{kernel} {name}: a rerun changed the bits")
    return fields["max_abs_err"]


def paged_row(name: str, line: int, case: dict, variant: str, errs: list) -> dict:
    """Times of one variant of the paged gate mix at the engine's shapes,
    beside its bytes bound: the pool rows, weights and scales that THIS
    run's positions make it read, each once, plus the table, the positions,
    the bias entries and the f32 output."""
    args, kwargs = paged_args(case, variant)
    w, bias, pool, table, pos = args
    batch, d, n, rows = len(case["pos"]), case["d"], case["n"], case["rows_read"]
    nbytes = (rows * d * pool.element_size() + rows * w.element_size()
              + table.numel() * 4 + batch * 4 + batch * 4 + batch * d * 4)
    if kwargs["pool_scale"] is not None:
        nbytes += rows * 4
    if kwargs["w_scale"] is not None:
        nbytes += batch * 4
    flops = 2.0 * rows * d
    bound_ms, bound_by = bound(nbytes, flops, torch.float32)  # f32 FMAs

    def library():
        # gather the rows, then one batched product
        dt = torch.float32 if pool.dtype == torch.int8 else pool.dtype
        rows_ = pool[table.long()].reshape(batch, -1, d)[:, :n].to(dt)
        if kwargs["pool_scale"] is not None:
            rows_ = rows_ * kwargs["pool_scale"][table.long()].reshape(batch, -1)[:, :n, None]
        w_rows = w[pos.long()].float()
        if kwargs["w_scale"] is not None:
            w_rows = w_rows * kwargs["w_scale"][pos.long()][:, None]
        w_rows = w_rows * (torch.arange(n, device="cuda")[None, :] <= pos[:, None])
        return torch.bmm(w_rows[:, None, :].to(dt), rows_)[:, 0].float() + bias[pos.long()]

    mix_route = cuda_paged_gate_mix.route(pool.dtype, d)
    kernel = lambda: cuda_paged_gate_mix.paged_gate_mix(*args, **kwargs)
    simt = lambda: cuda_paged_gate_mix.launch("simt", *args, w_scale=kwargs["w_scale"],
                                              pool_scale=kwargs["pool_scale"])
    row = {
        "name": name, "route": "cuda", "mix_route": mix_route,
        "source": "progen_tpu_torch/kernels/csrc/paged_gate_mix.cu",
        "replaces": f"progen_tpu/ops/pallas_paged_attention.py:{line}",
        "launches": None, "max_abs_err": errs[0], "ms": time_ms(kernel),
        "ms_cold": time_ms_cold(kernel),
        "simt_ms": time_ms(simt), "simt_ms_cold": time_ms_cold(simt),
        "plain_ms": time_ms(lambda: plain_paged.paged_gate_mix(*args, **kwargs)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": time_ms(library),
        "library_ms_cold": time_ms_cold(library),
        "library": "gather + torch.bmm",
        "timed_shape": {"B": batch, "n": n, "d": d, "page_size": case["ps"],
                        "pos": list(case["pos"].tolist())},
        "timed_dtype": f"weights {w.dtype}, pool {pool.dtype}",
        "bytes": nbytes, "flops": flops, "max_abs_err_all_checks": max(errs),
    }
    emit("kernel_time", **row)
    return row


def check_paged_kernels() -> list[dict]:
    """K3 and K3-q8 against the plain paged gate mix at the engine's shapes
    (ProGen-small: n = seq_len, d = hidden / 2, page 16, 8 rows at ragged
    positions; then one row at 1023, eight rows at 0, eight at 1023, and
    table entries outside the pool), all on the bulk route, and at page 24
    with n = 1000 (the pages overhang the weight square) on the route
    ``route`` names; every case twice, for the same bits.  Timed at the
    engine's shapes with a bf16 pool (K3) and with int8 weights and an int8
    pool (K3-q8), warm and cold, beside the first (simt) kernel."""
    plan = (ctypes.c_int * 6)()
    kernels.load(cuda_paged_gate_mix.LIBRARY).paged_gate_mix_bulk_plan(plan)
    mirror = [getattr(cuda_paged_gate_mix, k) for k in (
        "SPLIT_ROWS", "SPLIT_ROWS_INT8", "SLAB_BYTES", "STAGE_ROWS", "GROUPS", "CLUSTER")]
    require(list(plan) == mirror,
            f"the bulk kernel's plan {list(plan)} is not the wrapper's mirror {mirror}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    c = SMALL
    half = c.dim * c.ff_mult // 2
    ragged = (0, 23, 24, 300, 511, 777, 998, 999)
    cases = {dt: paged_case(gen, c.seq_len, half, ENGINE_PAGE, PAGED_POS, dt)
             for dt in (torch.bfloat16, torch.float32)}
    overhang = {dt: paged_case(gen, 1000, half, 24, ragged, dt)
                for dt in (torch.bfloat16, torch.float32)}
    edge = {name: paged_case(gen, c.seq_len, half, ENGINE_PAGE, pos, torch.bfloat16,
                             outside=name == "outside_the_pool")
            for name, pos in (("one_row_at_1023", (1023,)), ("all_at_0", (0,) * 8),
                              ("all_at_1023", (1023,) * 8),
                              ("outside_the_pool", PAGED_POS))}
    k3 = [paged_check(name, case, "f32_w", "paged_gate_mix", want_route)
          for name, case, want_route in (
              ("engine_bf16", cases[torch.bfloat16], "bulk"),
              ("engine_f32", cases[torch.float32], "bulk"),
              ("overhang_bf16", overhang[torch.bfloat16], None),
              ("overhang_f32", overhang[torch.float32], None),
              *((name, case, "bulk") for name, case in edge.items()))]
    q8 = [paged_check(name, case, variant, "paged_gate_mix_q8", want_route)
          for variant in ("int8_w_int8_pool", "int8_w_bf16_pool", "f32_w_int8_pool")
          for name, case, want_route in (
              ("engine_bf16", cases[torch.bfloat16], "bulk"),
              ("overhang_bf16", overhang[torch.bfloat16], None),
              *((name, case, "bulk") for name, case in edge.items()))]
    return [paged_row("paged_gate_mix", 54, cases[torch.bfloat16], "f32_w", k3),
            paged_row("paged_gate_mix_q8", 81, cases[torch.bfloat16],
                      "int8_w_int8_pool", q8)]


# -- phase 7: the engine path -------------------------------------------------


def capped(requests: list[dict], new_tokens: int) -> list[dict]:
    """``requests`` with at most ``new_tokens`` new tokens each."""
    return [{**r, "max_new_tokens": min(r["max_new_tokens"], new_tokens)} for r in requests]


def cut(tokens: dict, new_tokens: int) -> dict:
    """Tokens by uid cut to their first ``new_tokens``: what the same
    requests capped at ``new_tokens`` answer (a request's tokens depend on
    its prime, seed and knobs, not on its cap)."""
    return {u: t[:new_tokens] for u, t in tokens.items()}


def engine_requests(c, greedy: bool = False) -> list[dict]:
    """12 requests from the seed: prime lengths 37-511, ``max_new_tokens``
    64-192, half greedy and half top-k 25 at temperature 1, each its own
    seed.  Requests 8 and 9 share their first 256 residues with requests 0
    and 1 (one long-prime pair each side of the first admission), so the
    paged engine's prefix cache has something to find."""
    rng = np.random.default_rng(SEED + 6)
    out = []
    for i in range(ENGINE_REQUESTS):
        n = int(rng.integers(257, 512)) if i in (0, 1, 8, 9) else int(rng.integers(37, 512))
        tokens = [0] + encode_tokens("".join(rng.choice(list(AMINO), size=n - 1)))
        out.append({"uid": i, "tokens": tokens,
                    "max_new_tokens": int(rng.integers(64, 193)),
                    "top_k": None if i % 2 == 0 else 25,
                    "temperature": 0.0 if (greedy or i % 2 == 0) else 1.0,
                    "seed": 1000 + i})
    for late, early in ((8, 0), (9, 1)):
        out[late]["tokens"][:256] = out[early]["tokens"][:256]
    return out


# each run_engine phase's emitted fields, by phase (engine_graphs reads the
# eager runs' beside its warmed ones)
ENGINE_FIELDS: dict[str, dict] = {}


def warm_up(engine, embed: bool = False) -> dict:
    """``engine.aot_warmup``: its programs and seconds, the bytes the
    captured grid holds (allocated: the static buffers and outputs;
    reserved: with the graphs' private pools, the allocator's cache emptied
    before and after), and the launches the host makes per call of the
    decode chunk (copies in, the replay, clones out).  Every program must
    be a captured graph."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    stats = engine.aot_warmup(embed=embed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    require(all(p.captured for p in engine._aot.values()),
            f"a program of {sorted(engine._aot)} was not captured")
    return {**stats, "keys": [list(k) for k in sorted(engine._aot)],
            "allocated_bytes": torch.cuda.memory_allocated() - allocated,
            "reserved_bytes": torch.cuda.memory_reserved() - reserved,
            "chunk_host_launches": engine._aot[("chunk",)].host_launches}


def drive(engine, phase: str, t0: float) -> tuple[list, float]:
    """Step ``engine`` until it has no work; returns its completions and the
    seconds from ``t0`` (before the first submit) to the end of its first
    decode chunk, synchronized."""
    done, first_chunk_s = [], None
    while engine.has_work:
        done += engine.step()
        if first_chunk_s is None and engine.chunks_run:
            torch.cuda.synchronize()
            first_chunk_s = time.perf_counter() - t0
        require(engine.chunks_run <= 400, f"{phase}: the engine did not drain")
    return done, first_chunk_s


def run_engine(phase: str, model, requests: list[dict], want: dict | None = None,
               aot: bool = False, zero_halo: bool = False, **engine_kwargs):
    """Answer ``requests`` through a ``ServingEngine`` over ``model`` (with
    ``aot``, warmed first: every program a captured CUDA graph; with
    ``zero_halo``, K1 through its halo entry, :func:`k1_zero_halo`); the
    launch counts are set to 0 just before and read just after.  Checks
    what every engine run must show, and with ``want`` (the plain engine's
    tokens in the same mode) the share of equal tokens; returns (tokens by
    uid, launches and the paged gate mix's launches by route, engine)."""
    with k1_zero_halo() if zero_halo else contextlib.nullcontext():
        return _run_engine(phase, model, requests, want, aot, zero_halo, **engine_kwargs)


@contextlib.contextmanager
def k1_zero_halo():
    """K1 through its halo entry with the zero window wherever the model
    calls it without a halo: the unmeshed forward then launches K1 as a
    meshed prefill does (``parallel/context.py:sharded_local_attention``),
    a reference that differs from the meshed decode only by the mesh."""
    plain = cuda_attention.local_attention

    def haloed(q, k, v, window_size, scale=None, k_halo=None, v_halo=None):
        if k_halo is None:
            b, h, _, d = k.shape
            k_halo = v_halo = torch.zeros(b, h, window_size, d, dtype=k.dtype,
                                          device=k.device)
        return plain(q, k, v, window_size, scale, k_halo, v_halo)

    with mock.patch.object(cuda_attention, "local_attention", haloed):
        yield


def _run_engine(phase: str, model, requests: list[dict], want: dict | None,
                aot: bool, zero_halo: bool, **engine_kwargs):
    c = model.config
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           max_len=c.seq_len, page_size=ENGINE_PAGE, **engine_kwargs)
    warmed = warm_up(engine) if aot else None
    programs = count_programs(engine)
    gc.collect()  # an engine holds bound methods of itself: free the last one's state
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for r in requests:
        engine.submit(Request(**r))
    done, first_chunk_s = drive(engine, phase, t0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = read_counts()
    routes = read_routes()
    peak = torch.cuda.max_memory_allocated()
    # bf16 admit programs run the Hopper forward kernels, f32 the first ones
    require_forward_routes(routes, launches,
                           model.policy.compute_dtype == torch.bfloat16, phase)
    mixes = launches["paged_gate_mix"] + launches["paged_gate_mix_q8"]
    require(routes["paged_gate_mix"] == {"bulk": mixes, "simt": 0},
            f"{phase}: paged gate mix launches by route {routes['paged_gate_mix']}, "
            f"want all {mixes} on bulk")

    require(sorted(comp.uid for comp in done) == list(range(len(requests))),
            f"{phase}: not every request was answered exactly once")
    require(all(comp.status == "ok" for comp in done),
            f"{phase}: statuses {[comp.status for comp in done]}")
    by_uid = {comp.uid: comp for comp in done}
    for r in requests:
        toks = by_uid[r["uid"]].tokens
        require(1 <= len(toks) <= r["max_new_tokens"]
                and bool(((toks >= 0) & (toks < c.num_tokens)).all()),
                f"{phase}: request {r['uid']} got {len(toks)} tokens")
    # target steps: a plain chunk is ENGINE_CHUNK of them, a speculative one
    # its rounds of spec_k + 1 verify steps (the draft's steps are dense)
    per_chunk = (engine._spec_rounds * (engine.spec_k + 1) if engine.spec
                 else ENGINE_CHUNK)
    steps = engine.chunks_run * per_chunk
    paged = engine_kwargs.get("paged", False)
    q8 = engine_kwargs.get("quantize") == "weights+pages"
    # each prefill program runs the target's forward, and the draft's too
    depth, gmlp = c.depth, c.global_mlp_depth
    if engine.spec:
        depth += engine.draft_config.depth
        gmlp += engine.draft_config.global_mlp_depth
    expected = {name: 0 for name in COUNTERS}
    # and each embedding program the target's alone
    expected.update(local_attention_fwd=depth * programs["prefill"] + c.depth * programs["embed"],
                    sgu_fwd=gmlp * programs["prefill"] + c.global_mlp_depth * programs["embed"])
    if paged:
        expected["paged_gate_mix_q8" if q8 else "paged_gate_mix"] = \
            c.global_mlp_depth * steps
    if engine_kwargs.get("mesh") is not None or zero_halo:  # K1 through its halo entry
        expected["local_attention_fwd_halo"] = expected["local_attention_fwd"]
    require(launches == expected,
            f"{phase}: kernel launches {launches}, want {expected}")
    generated = sum(len(comp.tokens) for comp in done)
    fields = {"config": "small", "dtype": str(model.policy.compute_dtype),
              "requests": len(requests), "slots": ENGINE_SLOTS, "chunk": ENGINE_CHUNK,
              "launches": launches, "prefill_programs": programs["prefill"],
              "fwd_launches_by_route": {k: routes[k]
                                        for k in ("local_attention_fwd", "sgu_fwd")},
              "mix_launches_by_route": routes["paged_gate_mix"],
              "chunks_run": engine.chunks_run, "decode_steps": steps,
              "target_steps_per_chunk": per_chunk,
              "generated_tokens": generated, "total_s": total_s,
              "tokens_per_s": generated / total_s, "first_chunk_s": first_chunk_s,
              "stage_seconds": dict(engine.stage_seconds),
              "finish_reasons": sorted(comp.finish_reason for comp in done),
              "latency_s_median": float(np.median([comp.latency for comp in done])),
              "peak_bytes": peak, **describe(engine_kwargs)}
    if warmed is not None:
        fields["aot_warmup"] = warmed
    if engine.spec:
        fields["spec"] = engine.spec_counters()
    if engine.disagg:
        fields["handoff"] = engine.robustness_counters()["handoff"]
    if paged:
        cache = engine.cache_status()
        require(cache["free_pages"] + cache["cached_pages"] == cache["capacity"],
                f"{phase}: pages were not all returned: {cache}")
        fields.update(cache=cache, pause_events=engine.pause_events,
                      evictions=engine.evictions)
    require(engine.robustness_counters()["fallback_activations"] == 0,
            f"{phase}: a fallback was activated")
    tokens = {u: comp.tokens.tolist() for u, comp in by_uid.items()}
    if want is not None:
        fields["token_match_vs_plain"] = token_match(tokens, want)
        fields["min_token_match"] = ENGINE_TOKEN_MATCH
    emit(phase, **fields)
    ENGINE_FIELDS[phase] = fields
    if want is not None:
        require(fields["token_match_vs_plain"] >= ENGINE_TOKEN_MATCH,
                f"{phase}: {fields['token_match_vs_plain']} of the plain engine's "
                f"tokens, want >= {ENGINE_TOKEN_MATCH}")
    launches = {**launches, "paged_gate_mix_by_route": routes["paged_gate_mix"]}
    return tokens, launches, engine


def count_programs(engine) -> dict[str, int]:
    """Count, from now on, the engine's dispatches of the programs that run
    the parallel forward, eager or warmed (a replay of the captured
    program): ``prefill`` (the admit programs and, disaggregated, the
    prefill worker's) and ``embed`` (the embedding programs)."""
    programs = {"prefill": 0, "embed": 0}

    def counted(kind, dispatch):
        def call(*args):
            programs[kind] += 1
            return dispatch(*args)
        return call

    engine._admit_call = counted("prefill", engine._admit_call)
    if engine.disagg:
        engine._prefill_worker_call = counted("prefill", engine._prefill_worker_call)
    engine._embed_call = counted("embed", engine._embed_call)
    return programs


def describe(engine_kwargs: dict) -> dict:
    """The engine's arguments as JSON: a draft by its config, a LoRA bank by
    its tenants and rank."""
    out = {}
    for k, v in engine_kwargs.items():
        if k == "draft_params":
            v = v.config.to_dict()
        elif k == "lora_bank" and v is not None:
            v = {"tenants": bank_num_tenants(v), "rank": int(v["attn0"]["qkv"]["a"].shape[-1])}
        elif k == "mesh":
            v = dict(zip(v.mesh_dim_names, v.mesh.shape))
        elif k == "params_shardings":
            v = {"strategies": v.strategies}
        out[k] = v
    return out


def engine_modes(model, requests, dense: dict, paged: dict, q8: dict,
                 runs: dict | None = None) -> dict:
    """Speculative decoding and disaggregated prefill at ProGen-small, each
    held to the plain engine's tokens in its mode (``dense``, ``paged``,
    ``q8``): the ``draft_config_for`` draft (random weights from the seed)
    and the identity draft, spec_k 4.  Returns each phase's launches; fills
    ``runs`` with the paged and identity-draft speculative runs and the
    disaggregated one (tokens, launches) by phase."""
    draft = ProGen(draft_config_for(model.config), make_policy(True), device="cuda",
                   seed=SEED).eval()
    out = {}
    spec_requests = capped(requests, SPEC_NEW_TOKENS)
    tokens, out["engine_spec_paged"], engine = run_engine(
        "engine_spec_paged", model, spec_requests, want=cut(paged, SPEC_NEW_TOKENS),
        paged=True, spec=True, spec_k=ENGINE_SPEC_K, draft_params=draft)
    require(engine.draft_config.dim == model.config.dim // 4, "not the draft config")
    if runs is not None:
        runs["engine_spec_paged"] = (tokens, out["engine_spec_paged"])
    tokens, out["engine_spec_identity"], engine = run_engine(
        "engine_spec_identity", model, spec_requests, want=cut(dense, SPEC_NEW_TOKENS),
        spec=True, spec_k=ENGINE_SPEC_K)
    if runs is not None:
        runs["engine_spec_identity"] = (tokens, out["engine_spec_identity"])
    counters = engine.spec_counters()
    require(counters["accepted_tokens_per_round"] > 1.0
            and counters["accepted_tokens_per_slot_round"] > 1.0,
            f"the identity draft accepted nothing: {counters}")
    tokens, out["engine_disagg_paged"], engine = run_engine(
        "engine_disagg_paged", model, requests, want=paged, paged=True, disagg=True)
    if runs is not None:
        runs["engine_disagg_paged"] = (tokens, out["engine_disagg_paged"])
    handoff = engine.robustness_counters()["handoff"]
    require(handoff["puts"] == handoff["gets"] > 0 and engine.stage_seconds["merge_s"] > 0,
            f"engine_disagg_paged: handoff {handoff}")
    _, out["engine_spec_disagg_q8"], engine = run_engine(
        "engine_spec_disagg_q8", model, spec_requests, want=cut(q8, SPEC_NEW_TOKENS),
        paged=True, quantize="weights+pages", spec=True, spec_k=ENGINE_SPEC_K, disagg=True)
    del engine, draft
    return out


def engine_modes_alone() -> dict:
    """The speculative and disaggregated engine phases with what they need
    (the build, the model, the plain dense, paged and 8-bit runs), on their
    own: ``python3 -c "import chip_smoke as cs; cs.engine_modes_alone()"``."""
    kernels.build()
    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED).eval()
    requests = engine_requests(SMALL)
    dense, _, _ = run_engine("engine_dense", model, requests)
    paged, _, _ = run_engine("engine_paged", model, requests, paged=True)
    q8, _, _ = run_engine("engine_paged_q8", model, requests, paged=True,
                          quantize="weights+pages")
    return engine_modes(model, requests, dense, paged, q8)


def token_match(got: dict, want: dict) -> float:
    """Share of ``want``'s tokens that ``got`` has at the same place."""
    same = sum(a == b for u in want for a, b in zip(got[u], want[u]))
    return same / sum(len(v) for v in want.values())


def check_engine_steps_against_plain(model, quantize, bank=None) -> dict:
    """From one admitted state of the paged engine, 32 teacher-forced decode
    steps through the paged kernel against the same steps with the mix
    swapped for its plain version: every step's logits.  With a LoRA
    ``bank`` the slots run tenants ``slot % T`` and every step adds their
    adapters."""
    c = model.config
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           max_len=c.seq_len, paged=True, page_size=ENGINE_PAGE,
                           quantize=quantize, lora_bank=bank)
    for r in with_tenants(engine_requests(c)[:ENGINE_SLOTS], bank):
        engine.submit(Request(**r))
    engine._admit_pending()
    engine._ensure_chunk_pages()
    require(not engine._paused.any(), "the full pool paused a slot")
    table = torch.as_tensor(engine._page_table, device="cuda")
    live = torch.ones(ENGINE_SLOTS, dtype=torch.bool, device="cuda")
    rng = np.random.default_rng(SEED + 7)
    forced = torch.tensor(rng.integers(1, c.num_tokens, size=(ENGINE_CHUNK, ENGINE_SLOTS)),
                          device="cuda")
    runs = []
    for plain in (False, True):
        st = engine._working_copy(engine.state)
        patch = (mock.patch.object(incremental, "paged_gate_mix",
                                   plain_paged.paged_gate_mix)
                 if plain else contextlib.nullcontext())
        reset_counts()
        with patch:
            logits = [engine._step_model(forced[j], st["pos"] + j, st["caches"],
                                         table, live, engine._bank, st.get("tenant"))[0]
                      for j in range(ENGINE_CHUNK)]
        counts = read_counts()
        key = "paged_gate_mix_q8" if quantize else "paged_gate_mix"
        want = 0 if plain else c.global_mlp_depth * ENGINE_CHUNK
        require(counts[key] == want
                and read_routes()["paged_gate_mix"] == {"bulk": want, "simt": 0},
                f"engine_vs_plain launched {counts}, {read_routes()['paged_gate_mix']}")
        runs.append(torch.stack(logits))
    got, want = runs
    dtype = model.policy.compute_dtype
    result = compare(got, want, TOL_MODEL[dtype])
    result.update(dtype=str(dtype), quantize=quantize, steps=ENGINE_CHUNK,
                  rows=ENGINE_SLOTS, max_abs_logit=float(want.abs().max()),
                  lora_tenants=bank_num_tenants(bank) if bank else 0,
                  positions=[int(p) for p in engine.state["pos"]])
    require(bool(torch.isfinite(got).all()), "non-finite engine logits")
    require(result["ok"], f"paged steps through the kernel disagree with plain: {result}")
    return result


def check_paged_engine_against_dense(reference, bank=None) -> dict:
    """In f32 and greedy, the 12 requests through the paged engine (K3)
    against the dense engine: the only difference is K3's summation order.
    Reports the share of equal tokens and, at the first difference, the
    margin between the two best logits there.  With a LoRA ``bank`` request
    ``i`` runs tenant ``i % T`` on both engines."""
    c = reference.config
    requests = with_tenants(engine_requests(c, greedy=True), bank)
    tag, extra = ("_lora", {"lora_bank": bank}) if bank else ("", {})
    dense, _, _ = run_engine(f"engine{tag}_dense_f32", reference, requests, **extra)
    paged, _, _ = run_engine(f"engine{tag}_paged_f32", reference, requests, paged=True,
                             **extra)
    share = token_match(paged, dense)
    result = {"dtype": "torch.float32", "token_match": share,
              "lora_tenants": bank_num_tenants(bank) if bank else 0,
              "min_token_match": ENGINE_TOKEN_MATCH, "first_difference": None}
    for r in requests:
        a, b = paged[r["uid"]], dense[r["uid"]]
        at = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if at is None:
            continue
        prefix = r["tokens"] + b[:at]
        p_pad = pad_prime_length(len(prefix), c.window_size, c.seq_len)
        tokens = torch.tensor([prefix + [0] * (p_pad - len(prefix))], device="cuda")
        ad = None
        if bank:
            ad = {"adapters": bank, "tenant": torch.tensor([r["tenant"]], device="cuda")}
        with torch.no_grad():
            top = reference(tokens, **(ad or {}))[0, len(prefix) - 1].float().topk(2).values
        result["first_difference"] = {
            "uid": r["uid"], "generated_index": at, "paged": a[at], "dense": b[at],
            "top2_logit_margin": float(top[0] - top[1])}
        break
    require(share >= ENGINE_TOKEN_MATCH, f"paged engine vs dense engine: {result}")
    return result


# -- phase 9: the served workloads and LoRA training -------------------------


def with_tenants(requests: list[dict], bank) -> list[dict]:
    """Request ``i`` on tenant ``i % T`` of ``bank`` (unchanged without)."""
    if not bank:
        return requests
    t = bank_num_tenants(bank)
    return [{**r, "tenant": i % t} for i, r in enumerate(requests)]


def residues(rng, n: int) -> list[int]:
    return encode_tokens("".join(rng.choice(list(AMINO), size=n)))


def workload_queue(c) -> dict:
    """The engine_workloads phase's mixed queue, from the seed: 4 generate
    requests on tenant 0 and 3 LoRA requests on tenants 1-3 (primes 37-511
    residues, 64-128 new tokens, greedy and top-k 25 in turns); 2 infill
    requests (one greedy, one sampled) over a scaffold of a 64-residue prime
    and 48 designed positions (free over the amino acids, hydrophobic sets,
    a frozen G every 8th); a best-of-4 fork off a 256-token prime; and 4
    embeds of 37, 200, 300 and 511 residues.  Every prime starts with BOS."""
    rng = np.random.default_rng(SEED + 8)
    plain = []
    for i in range(7):
        n = int(rng.integers(37, 512))
        plain.append({"uid": i, "tokens": [0] + residues(rng, n),
                      "max_new_tokens": int(rng.integers(64, 129)),
                      "top_k": None if i % 2 == 0 else 25,
                      "temperature": 0.0 if i % 2 == 0 else 1.0, "seed": 2000 + i,
                      "tenant": max(0, i - 3)})
    amino = sorted(set(encode_tokens(AMINO)))
    design = []
    for g in range(48):
        if g % 8 == 7:
            design.append(encode_tokens("G")[0])
        elif g % 4 == 1:
            design.append(tuple(encode_tokens("AILMFVW")))
        else:
            design.append(None)
    scaffold = ScaffoldSpec(template=[0] + residues(rng, 64) + design,
                            vocab=c.num_tokens, alphabet=amino)
    infill = [{"uid": 7 + j, "seed": 2100 + j, "top_k": None if j == 0 else 25,
               "temperature": 0.0 if j == 0 else 1.0, "workload": "infill",
               **scaffold.request_kwargs()} for j in range(2)]
    fork = {"uid": 10, "tokens": [0] + residues(rng, 255), "max_new_tokens": 64,
            "top_k": 25, "temperature": 1.0, "seed": 3000}
    embeds = [{"uid": 20 + j, "tokens": [0] + residues(rng, n), "workload": "embed"}
              for j, n in enumerate((37, 200, 300, 511))]
    return {"plain": plain, "infill": infill, "fork": fork, "embeds": embeds,
            "scaffold": scaffold}


def run_workloads(phase: str, model, queue: dict, bank, forked: bool,
                  aot: bool = False) -> tuple:
    """One paged engine (with ``bank``, or bankless with every tenant set to
    0) answers the whole ``queue``; the fork is ``submit_fork``ed when
    ``forked``, else its four requests are submitted one by one (uid + k,
    seed + k).  With ``aot`` the engine is warmed first, the embedding
    programs included.  The launch counts are set to 0 just before and read
    just after, and held to the programs run.  Returns (completions by uid,
    the phase's fields, launches, the engine)."""
    c = model.config
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           max_len=c.seq_len, page_size=ENGINE_PAGE, paged=True,
                           lora_bank=bank)
    warmed = warm_up(engine, embed=True) if aot else None
    programs = count_programs(engine)
    untenanted = lambda r: r if bank else {**r, "tenant": 0}
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    for r in queue["plain"] + queue["infill"]:
        engine.submit(Request(**untenanted(r)))
    fork = queue["fork"]
    if forked:
        engine.submit_fork(Request(**fork), WORKLOAD_FORKS)
    else:
        for k in range(WORKLOAD_FORKS):
            engine.submit(Request(**{**fork, "uid": fork["uid"] + k, "seed": fork["seed"] + k}))
    for r in queue["embeds"]:
        engine.submit_embed(Request(**r))
    done, holders, forks_in_flight, first_chunk_s = [], 0, 0, None
    fork_uids = set(range(fork["uid"], fork["uid"] + WORKLOAD_FORKS))
    prime_pages = None  # the leader's full prime pages, once it is admitted
    while engine.has_work:
        done += engine.step()
        if first_chunk_s is None and engine.chunks_run:
            torch.cuda.synchronize()
            first_chunk_s = time.perf_counter() - t0
        in_flight = {r.uid: slot for slot, r in engine._inflight.items()}
        forks_in_flight = max(forks_in_flight, len(fork_uids & set(in_flight)))
        if prime_pages is None and fork["uid"] in in_flight:
            pages = engine._slot_pages[in_flight[fork["uid"]]].pages
            prime_pages = pages[: len(fork["tokens"]) // ENGINE_PAGE]
        if prime_pages:
            # requests holding every prime page (the index holds one reference)
            holders = max(holders, min(engine._pool._ref.get(pid, 0)
                                       for pid in prime_pages) - 1)
        require(engine.chunks_run < 400, f"{phase}: the engine did not drain")
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()

    by_uid = {comp.uid: comp for comp in done}
    want_uids = ([r["uid"] for r in queue["plain"] + queue["infill"] + queue["embeds"]]
                 + sorted(fork_uids))
    require(sorted(by_uid) == sorted(want_uids) and len(done) == len(want_uids),
            f"{phase}: answered {sorted(comp.uid for comp in done)}")
    require(all(comp.status == "ok" for comp in done),
            f"{phase}: statuses {[comp.status for comp in done]}")
    steps = engine.chunks_run * ENGINE_CHUNK
    expected = {name: 0 for name in COUNTERS}
    fwd_programs = programs["prefill"] + programs["embed"]
    expected.update(local_attention_fwd=c.depth * fwd_programs,
                    sgu_fwd=c.global_mlp_depth * fwd_programs,
                    paged_gate_mix=c.global_mlp_depth * steps)
    require(launches == expected, f"{phase}: kernel launches {launches}, want {expected}")
    require_forward_routes(routes, launches, model.policy.compute_dtype == torch.bfloat16,
                           phase)
    require(routes["paged_gate_mix"] == {"bulk": launches["paged_gate_mix"], "simt": 0},
            f"{phase}: paged gate mix launches by route {routes['paged_gate_mix']}")
    cache = engine.cache_status()
    require(cache["free_pages"] + cache["cached_pages"] == cache["capacity"],
            f"{phase}: pages were not all returned: {cache}")

    classes = {"generate": [r["uid"] for r in queue["plain"][:4]],
               "lora": [r["uid"] for r in queue["plain"][4:]],
               "infill": [r["uid"] for r in queue["infill"]],
               "fork": sorted(fork_uids), "embed": [r["uid"] for r in queue["embeds"]]}
    per_class = {}
    for name, uids in classes.items():
        comps = [by_uid[u] for u in uids]
        toks = sum(len(comp.tokens) for comp in comps)
        per_class[name] = {"requests": len(uids), "generated_tokens": toks,
                           "prime_tokens": sum(len(comp.prime) for comp in comps),
                           "tokens_per_s": toks / total_s,
                           "latency_s_median": float(np.median([comp.latency for comp in comps]))}
    fields = {"config": "small", "dtype": str(model.policy.compute_dtype),
              "lora": describe({"lora_bank": bank})["lora_bank"] if bank else None,
              "forked": forked, "launches": launches,
              "prefill_programs": programs["prefill"], "embed_programs": programs["embed"],
              "fwd_launches_by_route": {k: routes[k] for k in ("local_attention_fwd", "sgu_fwd")},
              "mix_launches_by_route": routes["paged_gate_mix"],
              "chunks_run": engine.chunks_run, "decode_steps": steps, "total_s": total_s,
              "tokens_per_s": sum(len(comp.tokens) for comp in done) / total_s,
              "first_chunk_s": first_chunk_s, "aot_warmup": warmed,
              "per_workload": per_class, "stage_seconds": dict(engine.stage_seconds),
              "prefix_hits": engine.prefix_hits, "max_prime_page_holders": holders,
              "max_forks_in_flight": forks_in_flight, "peak_bytes": peak}
    return by_uid, fields, {**launches, "paged_gate_mix_by_route": routes["paged_gate_mix"]}, engine


def embed_batches(queue: dict, c) -> list[tuple[list[int], int]]:
    """The engine's embedding rounds for ``queue``: FIFO runs of one bucket
    of up to ``ENGINE_SLOTS`` requests, as (uids, padded length)."""
    out: list[tuple[list[int], int]] = []
    for r in queue["embeds"]:
        p_pad = pad_prime_length(len(r["tokens"]), c.window_size, c.seq_len, bucket=True)
        if out and out[-1][1] == p_pad and len(out[-1][0]) < ENGINE_SLOTS:
            out[-1][0].append(r["uid"])
        else:
            out.append(([r["uid"]], p_pad))
    return out


def check_embeddings(model, reference, queue: dict, got: dict) -> dict:
    """The engine's embeddings against ``make_embedder`` on the same padded
    batches (bit for bit) and against the same batches through the plain
    K1-fwd and K2-fwd (each row's ``max|d| <= 0.05 max|plain row|``).

    A mean over up to 511 positions dilutes an error confined to a few, so
    the final hidden states that are pooled (every real position of a row)
    are held too: the kernels' bf16 and the plain versions' bf16 round in
    different places, so neither is the other's reference; the f32 model of
    the same weights through the plain versions is.  Each row's hidden
    states through the kernels must stay as close to it as the plain
    versions' do, within half again, in RMS and in max error."""
    require(all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  reference.parameters())),
            "the f32 reference does not hold the bf16 model's weights")
    c = model.config
    tokens_of = {r["uid"]: r["tokens"] for r in queue["embeds"]}
    embed = make_embedder(model)
    rows, ms, hidden = [], {}, []
    for uids, p_pad in embed_batches(queue, c):
        tokens = torch.zeros(ENGINE_SLOTS, p_pad, dtype=torch.long, device="cuda")
        lengths = torch.ones(ENGINE_SLOTS, dtype=torch.long, device="cuda")
        for row, u in enumerate(uids):
            tokens[row, : len(tokens_of[u])] = torch.tensor(tokens_of[u])
            lengths[row] = len(tokens_of[u])
        vecs = embed(tokens, lengths)
        with torch.no_grad():
            states = model.final_hidden(tokens)
        with contextlib.ExitStack() as stack:
            for patch in plain_versions():
                stack.enter_context(patch)
            plain = embed(tokens, lengths)
            with torch.no_grad():
                plain_states = model.final_hidden(tokens)
                want_states = reference.final_hidden(tokens)
        for row, u in enumerate(uids):
            require(np.array_equal(vecs[row].cpu().numpy(), got[u].embedding),
                    f"embedding {u}: the engine's differs from make_embedder's")
            rows.append((float((vecs[row] - plain[row]).abs().max()),
                         float(plain[row].abs().max())))
            n = len(tokens_of[u])
            hidden.append({"uid": u, "kernels_vs_f32": errors(states[row, :n],
                                                             want_states[row, :n]),
                           "plain_vs_f32": errors(plain_states[row, :n],
                                                  want_states[row, :n]),
                           "kernels_vs_plain": errors(states[row, :n],
                                                      plain_states[row, :n])})
        ms[p_pad] = time_ms(lambda: embed(tokens, lengths), warmup=1, iters=5)
    worst, scale = max(rows, key=lambda r: r[0] / max(r[1], 1e-30))
    hidden_ok = all(h["kernels_vs_f32"][k] <= DECODE_VS_FORWARD_RATIO * h["plain_vs_f32"][k]
                    for h in hidden for k in h["kernels_vs_f32"])
    result = {"batches": [[uids, p_pad] for uids, p_pad in embed_batches(queue, c)],
              "worst_row_max_abs_err_vs_plain": worst, "worst_row_max_abs_plain": scale,
              "tol": TOL_EMBED * scale, "final_hidden": hidden,
              "final_hidden_max_ratio": DECODE_VS_FORWARD_RATIO,
              "embed_ms_by_bucket": ms, "bit_equal_to_embedder": True}
    require(worst <= TOL_EMBED * scale and hidden_ok, f"embeddings vs plain: {result}")
    return result


def decode_step_cost(model, bank) -> dict:
    """Launches and wall time of one paged decode step with and without the
    bank, from one admitted state: 32 teacher-forced steps timed on the host
    clock (two runs in turns, medians), and two steps each under
    ``torch.profiler``, whose device kernels are counted."""
    c = model.config
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           max_len=c.seq_len, paged=True, page_size=ENGINE_PAGE,
                           lora_bank=bank)
    for r in with_tenants(engine_requests(c)[:ENGINE_SLOTS], bank):
        engine.submit(Request(**r))
    engine._admit_pending()
    engine._ensure_chunk_pages()
    table = torch.as_tensor(engine._page_table, device="cuda")
    live = torch.ones(ENGINE_SLOTS, dtype=torch.bool, device="cuda")
    forced = torch.randint(1, c.num_tokens, (ENGINE_CHUNK, ENGINE_SLOTS), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED))

    def steps(with_bank: bool, n: int):
        st = engine._working_copy(engine.state)
        ad = (engine._bank, st["tenant"]) if with_bank else ()
        for j in range(n):
            engine._step_model(forced[j], st["pos"] + j, st["caches"], table, live, *ad)

    walls = {True: [], False: []}
    for with_bank in (False, True) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(with_bank, ENGINE_CHUNK)
        torch.cuda.synchronize()
        walls[with_bank].append((time.perf_counter() - t0) * 1e3 / ENGINE_CHUNK)
    launches, device_ms = {}, {}
    for with_bank in (False, True):
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            steps(with_bank, 2)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        launches[with_bank] = len(kernels) / 2
        device_ms[with_bank] = sum(e.time_range.elapsed_us() for e in kernels) / 2e3
    require(launches[False] > 0, "the profiler saw no kernel of the decode step")
    return {"launches_per_step": launches[False], "launches_per_step_with_bank": launches[True],
            "device_ms_per_step": device_ms[False],
            "device_ms_per_step_with_bank": device_ms[True],
            "wall_ms_per_step": float(np.median(walls[False])),
            "wall_ms_per_step_with_bank": float(np.median(walls[True])),
            "wall_ms_runs": walls[False], "wall_ms_runs_with_bank": walls[True]}


def engine_workloads(model, reference, runs: dict | None = None) -> dict:
    """The served workloads at ProGen-small through one paged engine with a
    LoRA bank (T = 4, rank 8, random from the seed), 8 slots, chunk 32,
    page 16: the mixed queue of ``workload_queue``.  Checks: the tenant-0
    requests' tokens (generate, infill, the forks) equal a bankless
    engine's on the same queue (the forks submitted there one by one, uid +
    k and seed + k); every infill token allowed, every frozen position
    forced; the followers admitted as prefix hits on the leader's 16 prime
    pages; the embeddings bit-equal to ``make_embedder``'s and near the
    plain versions'; 32 teacher-forced paged steps with the bank on K3 and
    K3-q8 against the plain mix; in f32 and greedy, paged LoRA tokens
    against dense LoRA's; last, the paged decode step's launches and wall
    with and without the bank.  Returns each engine run's launches; fills
    ``runs`` with the banked run (completions by uid, fields)."""
    c = model.config
    bank = random_lora_bank(c, LORA_TENANTS, LORA_RANK, seed=SEED, device="cuda")
    queue = workload_queue(c)
    got, fields, launches, engine = run_workloads("engine_workloads", model, queue, bank, True)
    if runs is not None:
        runs["engine_workloads"] = (got, fields)
    base, base_fields, base_launches, _ = run_workloads(
        "engine_workloads_bankless", model, queue, None, False)
    fork = queue["fork"]
    tenant0 = ([r["uid"] for r in queue["plain"] if r["tenant"] == 0]
               + [r["uid"] for r in queue["infill"]]
               + list(range(fork["uid"], fork["uid"] + WORKLOAD_FORKS)))
    differ = [u for u in tenant0 if got[u].tokens.tolist() != base[u].tokens.tolist()]
    lora_moved = [r["uid"] for r in queue["plain"] if r["tenant"]
                  and got[r["uid"]].tokens.tolist() != base[r["uid"]].tokens.tolist()]
    mask = queue["scaffold"].logit_mask()
    frozen = [g for g in range(mask.shape[0]) if mask[g].sum() == 1]
    infill_ok = all(mask[g, t] for r in queue["infill"]
                    for g, t in enumerate(got[r["uid"]].tokens.tolist()))
    forced_ok = all(got[r["uid"]].tokens[g] == int(np.flatnonzero(mask[g])[0])
                    for r in queue["infill"] for g in frozen
                    if g < len(got[r["uid"]].tokens))
    prime_pages = len(fork["tokens"]) // ENGINE_PAGE
    embeds_equal = all(np.array_equal(got[r["uid"]].embedding, base[r["uid"]].embedding)
                       for r in queue["embeds"])
    fields.update(tenant0_requests=len(tenant0), tenant0_differ_from_bankless=differ,
                  lora_requests_moved=lora_moved, infill_tokens_allowed=infill_ok,
                  infill_frozen_forced=forced_ok, infill_frozen_positions=len(frozen),
                  fork_prime_pages=prime_pages, embeddings_equal_bankless=embeds_equal,
                  bankless_tokens_per_s=base_fields["tokens_per_s"],
                  bankless_per_workload=base_fields["per_workload"],
                  bankless_chunks_run=base_fields["chunks_run"],
                  bankless_stage_seconds=base_fields["stage_seconds"],
                  embeddings=check_embeddings(model, reference, queue, got), nvidia_smi=smi_name_power())
    emit("engine_workloads", **fields)
    require(not differ, f"tenant-0 tokens differ from the bankless engine's: {differ}")
    require(lora_moved, "no adapter moved a LoRA request's tokens")
    require(infill_ok and forced_ok, "an infill token escaped its scaffold")
    require(fields["prefix_hits"] >= (WORKLOAD_FORKS - 1) * prime_pages
            and fields["max_prime_page_holders"] > 1,
            f"the forks did not share the leader's {prime_pages} prime pages: {fields}")
    require(embeds_equal, "the bank changed an embedding")
    del engine
    emit("engine_workloads_vs_plain", **check_engine_steps_against_plain(model, None, bank))
    emit("engine_workloads_vs_plain",
         **check_engine_steps_against_plain(model, "weights+pages", bank))
    emit("engine_lora_paged_vs_dense", **check_paged_engine_against_dense(reference, bank))
    # last: the profiler's tracing must not slow any run the phase times
    emit("engine_lora_decode_step", nvidia_smi=smi_name_power(),
         **decode_step_cost(model, bank))
    return {"engine_workloads": launches, "engine_workloads_bankless": base_launches}


def lora_train(full_step_ms: float | None) -> dict:
    """``LoRAProGen`` at ProGen-small, rank 8, bf16 compute: LORA_TRAIN_STEPS
    steps at batch 8 x 1024, lr 1e-3, through ``train/lora.py``; the launch
    counts are set to 0 just before and read after every step.  Then, in
    f32, ``bank_from_trained`` -> the engine's bank as tenant 1 -> the
    prefill's last logits against the training forward's (the wrapper's
    forward: its two-tenant bank of the trained factors, every row tenant
    1, through the f32 base).  Two ProGen-small models are built, each
    drawn on the host, the smoke's slowest set-up."""
    c = SMALL
    model = LoRAProGen(c, LORA_RANK, make_policy(True), device="cuda", seed=SEED)
    fns = lora_train_functions(model.train(), learning_rate=LORA_TRAIN_LR)
    state = fns.init_state()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    batches = train_batches(c, TRAIN_BATCH, LORA_TRAIN_STEPS, SEED + 9)
    losses, grad_norms, step_s, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_counts()
    for batch in batches:
        prior = read_counts()
        t0 = time.perf_counter()
        state, metrics = fns.train_step(state, batch)
        losses.append(float(metrics["loss"]))  # waits for the step
        step_s.append(time.perf_counter() - t0)
        grad_norms.append(float(metrics["grad_norm"]))
        per_step.append({k: v - prior[k] for k, v in read_counts().items()})
    torch.cuda.synchronize()
    launches, routes = read_counts(), read_routes()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in COUNTERS}
    want.update(local_attention_fwd=c.depth, local_attention_bwd_dq=c.depth,
                local_attention_bwd_dkv=c.depth, sgu_fwd=2 * c.global_mlp_depth,
                sgu_bwd_dgate=c.global_mlp_depth, sgu_bwd_dw=c.global_mlp_depth)
    require(all(s == want for s in per_step), f"LoRA train steps launched {per_step}, want {want}")
    want_bwd = {"wgmma": 2 * c.depth * LORA_TRAIN_STEPS, "wmma": 0}
    require(routes["local_attention_bwd"] == want_bwd,
            f"LoRA K1 backward routes {routes['local_attention_bwd']}, want {want_bwd}")
    require_forward_routes(routes, launches, True, "lora_train")
    require(all(np.isfinite(losses)) and all(np.isfinite(grad_norms)),
            f"non-finite LoRA loss or grad norm: {losses}, {grad_norms}")
    base_same = all(torch.equal(p, before[k]) for k, p in state.params.items()
                    if k.startswith("base."))
    moved = [k for k, p in state.params.items()
             if not k.startswith("base.") and not torch.equal(p, before[k])]
    require(base_same, "a frozen base parameter changed")
    require(len(moved) == 2 * len(model.sites), f"adapters that moved: {moved}")
    del before

    trained = extract_adapters(state.params, c)
    base = ProGen(c, make_policy(False), device="cuda")
    base.load_state_dict({k[len("base."):]: v for k, v in model.state_dict().items()
                          if k.startswith("base.")})
    two_tenant = {layer: {name: {k: f.detach().clone() for k, f in site.items()}
                          for name, site in sites.items()}
                  for layer, sites in model.adapters().items()}
    del model, state, fns
    gc.collect()
    engine = ServingEngine(base.eval(), num_slots=2, chunk_size=ENGINE_CHUNK,
                           lora_bank=bank_from_trained(c, LORA_RANK, [trained]))
    tokens = batches[0][:2, :-1]
    lengths = torch.tensor([c.seq_len, 700], device="cuda")
    with torch.no_grad():  # LoRAProGen.forward in f32
        train_logits = base(tokens, adapters=two_tenant,
                            tenant=torch.ones(2, dtype=torch.long, device="cuda"))
    want_last = train_logits[torch.arange(2, device="cuda"), lengths - 1]
    last, _ = make_prefiller(engine.model)(tokens, lengths, c.seq_len, adapters=engine._bank,
                                           tenant=torch.ones(2, dtype=torch.long, device="cuda"))
    serve = compare(last, want_last, TOL_LORA_SERVE)
    step_ms = float(np.median(step_s[TRAIN_WARMUP:])) * 1e3
    result = {"config": "small", "dtype": "bf16 compute, f32 params", "rank": LORA_RANK,
              "adapter_params": sum(int(t.numel()) for s in trained.values()
                                    for f in s.values() for t in f.values()),
              "steps": LORA_TRAIN_STEPS, "batch": TRAIN_BATCH, "seq_len": c.seq_len,
              "lr": LORA_TRAIN_LR, "losses": losses, "grad_norms": grad_norms,
              "launches": launches, "launches_per_step": per_step[0],
              "k1_bwd_launches_by_route": routes["local_attention_bwd"],
              "fwd_launches_by_route": {k: routes[k] for k in ("local_attention_fwd", "sgu_fwd")},
              "base_bit_unchanged": base_same, "adapters_moved": len(moved),
              "step_ms_median": step_ms, "step_ms": [t * 1e3 for t in step_s],
              "full_train_step_ms_median": full_step_ms,
              "tokens_per_s": TRAIN_BATCH * c.seq_len / (step_ms / 1e3), "peak_bytes": peak,
              "serve_vs_train_f32": serve, "nvidia_smi": smi_name_power()}
    emit("lora_train", **result)
    require(serve["ok"], f"tenant 1 of the trained bank disagrees with training: {serve}")
    return result


def engine_workloads_alone() -> dict:
    """The two workload phases (engine_workloads, lora_train) with what they
    need (the build, the bf16 and f32 models), on their own:
    ``python3 -c "import chip_smoke as cs; cs.engine_workloads_alone()"``."""
    kernels.build()
    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED).eval()
    reference = ProGen(SMALL, make_policy(False), device="cuda", seed=SEED).eval()
    out = engine_workloads(model, reference)
    del model, reference
    gc.collect()
    out["lora_train"] = lora_train(None)["launches"]
    gc.collect()
    emit("lora_train_vs_plain", **check_train_against_plain(lora=True))
    return out


# -- phase 12: the engine's resume and operations ------------------------------

LIFECYCLE_WATCHDOG_S = 30.0        # no step may take longer (cold dispatches exempt)
LIFECYCLE_SNAPSHOT_STEPS = 2       # steps before the mid-run snapshot
LIFECYCLE_FAULT = "serve.decode_chunk:unavailable:at=2"
LIFECYCLE_TRAINER_STEPS = 3
# the phase's ProGen-small depth: 12 (the whole model) before phase 14 came,
# cut to half to keep the whole smoke near 900 s; it runs its own
# uninterrupted runs
LIFECYCLE_DEPTH = 3
LIFECYCLE_NEW_TOKENS = 64  # its cap on the requests' new tokens (64-192 in phase 7)
LIFECYCLE_MEMORY_SLACK = 256 << 20  # live bytes allowed above the phase's start
LIFECYCLE_TRACE_CAPACITY = 1 << 16
# the engine's span and event names the phase's trace must hold
SERVE_SPANS = ("serve.submit", "serve.submit_embed", "serve.submit_fork",
               "serve.admit_prefill", "serve.prefill", "serve.merge",
               "serve.decode_chunk", "serve.harvest", "serve.embed", "serve.shed",
               "serve.preempt")
# the modes, and which of them the restart (b) and the reload (c) run in:
# the restart's fault plan hits serve.decode_chunk, which a speculative
# engine does not pass (it verifies); the reload is held bit for bit under
# 8-bit pages and plain
LIFECYCLE_MODES = ("dense", "paged", "weights+pages", "spec", "disagg", "workloads")
LIFECYCLE_RESTARTS = ("dense", "paged")
LIFECYCLE_RELOADS = ("dense", "weights+pages")


def lifecycle_engine_kwargs(mode: str, bank) -> dict:
    return {"dense": {}, "paged": {"paged": True},
            "weights+pages": {"paged": True, "quantize": "weights+pages"},
            "spec": {"spec": True, "spec_k": ENGINE_SPEC_K},
            "disagg": {"paged": True, "disagg": True},
            "workloads": {"paged": True, "lora_bank": bank}}[mode]


def lifecycle_queue(c, requests: list[dict], bank) -> dict:
    """What each mode serves: the 12 ``engine_requests`` (``first``); in the
    workloads mode on tenants ``i % 4``, with a masked infill request, an
    embed, a best-of-2 fork off a 64-residue prime, a request whose deadline
    is spent at submit (shed), a 600-residue prime (an admit bucket of 1024,
    cold for every engine before) and, once every slot is busy, 8 short
    requests of priority 1 (``late``: they preempt).  There every generate
    request's mask forbids EOS, so each runs its length and the slots fill
    at the first step."""
    if bank is None:
        return {"first": requests, "embeds": [], "forks": [], "late": []}
    rng = np.random.default_rng(SEED + 12)

    def no_eos(r: dict) -> dict:
        mask = np.ones((r["max_new_tokens"], c.num_tokens), bool)
        mask[:, 0] = False
        return {**r, "logit_mask": mask}

    scaffold = ScaffoldSpec(
        template=[0] + residues(rng, 48)
        + [None if g % 3 else tuple(encode_tokens("AILMFVW")) for g in range(40)],
        vocab=c.num_tokens, alphabet=sorted(set(encode_tokens(AMINO))))
    first = [no_eos(r) for r in with_tenants(requests, bank)] + [
        {"uid": 12, "seed": 4000, "top_k": 25, "temperature": 1.0, "tenant": 1,
         "workload": "infill", **scaffold.request_kwargs()},
        {"uid": 13, "tokens": [0] + residues(rng, 99), "max_new_tokens": 64,
         "seed": 4001, "ttl": -1.0},
        no_eos({"uid": 14, "tokens": [0] + residues(rng, 599), "max_new_tokens": 48,
                "top_k": 25, "seed": 4002, "tenant": 2})]
    return {"first": first,
            "embeds": [{"uid": 15, "tokens": [0] + residues(rng, 300), "workload": "embed"}],
            "forks": [no_eos({"uid": 16, "tokens": [0] + residues(rng, 63),
                              "max_new_tokens": 48, "top_k": 25, "temperature": 1.0,
                              "seed": 4003})],
            "late": [no_eos({"uid": 18 + j, "tokens": [0] + residues(rng, 40),
                             "max_new_tokens": 8, "seed": 4004 + j, "priority": 1,
                             "tenant": 3})
                     for j in range(ENGINE_SLOTS)],
            "scaffold": scaffold}


def lifecycle_drive(engine, queue: dict, steps: int | None = None) -> list:
    """Submit ``queue`` and step ``engine`` to idle, or ``steps`` steps; the
    ``late`` requests go in at the first step boundary where every slot is
    busy (so the next step preempts for them), and the steps are counted
    from there.  Returns the completions."""
    for r in queue["first"]:
        engine.submit(Request(**r))
    for r in queue["embeds"]:
        engine.submit_embed(Request(**r))
    for r in queue["forks"]:
        engine.submit_fork(Request(**r), 2)
    done, late, taken = [], list(queue["late"]), 0
    while engine.has_work or late:
        done += engine.step()
        if late and (engine.num_active >= engine.num_slots or not engine.has_work):
            for r in late:
                engine.submit(Request(**r))
            late = []
        require(engine.chunks_run <= 400, "engine_lifecycle: a run took over 400 chunks")
        if steps is not None and not late:
            taken += 1
            if taken >= steps:
                break
    return done


def lifecycle_answers(completions) -> dict:
    """Completions by uid: tokens, status, and an embedding's bytes."""
    return {comp.uid: (comp.tokens.tolist(), comp.status,
                       None if comp.embedding is None else comp.embedding.tobytes())
            for comp in completions}


class Lifecycle:
    """The phase's shared state: the model, the watchdog every engine beats,
    the memory the phase began at and each delete's live bytes, the launch
    counts of each run."""

    def __init__(self, model, watchdog, bank):
        self.model, self.watchdog, self.bank = model, watchdog, bank
        self.c = model.config
        self.start_bytes = torch.cuda.memory_allocated()
        self.after_delete: list[dict] = []

    def engine(self, mode: str, model=None, **kw) -> ServingEngine:
        """An engine of ``mode`` over ``model`` (the phase's by default; a
        config with ``seed``: weights of its own)."""
        return ServingEngine(model or self.model, num_slots=ENGINE_SLOTS,
                             chunk_size=ENGINE_CHUNK, max_len=self.c.seq_len,
                             page_size=ENGINE_PAGE, watchdog=self.watchdog,
                             **lifecycle_engine_kwargs(mode, self.bank), **kw)

    def deleted(self, what: str) -> None:
        """After an engine or Trainer is closed and its last reference
        dropped: the live bytes must be back within the slack of the start."""
        gc.collect()
        live = torch.cuda.memory_allocated()
        self.after_delete.append({"after": what, "live_bytes": live,
                                  "above_start_bytes": live - self.start_bytes})
        require(live - self.start_bytes <= LIFECYCLE_MEMORY_SLACK,
                f"engine_lifecycle: {live - self.start_bytes} bytes above the phase's "
                f"start after deleting {what} (slack {LIFECYCLE_MEMORY_SLACK})")

    def run(self, mode: str, queue: dict, label: str = "uninterrupted run") -> dict:
        """One uninterrupted run: answers, launches, tokens/s, chunks and the
        decode-chunk histogram's count over it, the admit buckets."""
        hist = get_registry().histogram("engine.decode_chunk_s")
        engine = self.engine(mode)
        torch.cuda.synchronize()
        before, count0, t0 = read_counts(), hist.count, time.perf_counter()
        done = lifecycle_drive(engine, queue)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = read_counts()
        out = {"answers": lifecycle_answers(done),
               "launches": {k: after[k] - before[k] for k in after},
               "tokens_per_s": sum(len(comp.tokens) for comp in done) / seconds,
               "seconds": seconds, "chunks_run": engine.chunks_run,
               "histogram_count": hist.count - count0,
               "admit_buckets": sorted(k[1] for k in engine._compiled_keys
                                       if k[0] == "admit")}
        engine.close()
        del engine
        self.deleted(f"{mode}: {label}")
        return out

    def snapshot_replay(self, mode: str, queue: dict, ref: dict, path: Path):
        """(a): LIFECYCLE_SNAPSHOT_STEPS steps, a snapshot to ``path``, a
        fresh engine restores it and replays; the completions before plus
        the replay must equal the uninterrupted run's.  Returns the fields
        and the replay's engine (idle, for the reload)."""
        before = read_counts()
        engine = self.engine(mode)
        lifecycle_drive(engine, queue, steps=LIFECYCLE_SNAPSHOT_STEPS)
        t0 = time.perf_counter()
        snap = engine.snapshot(str(path))
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        pre = lifecycle_answers(engine.completions)
        in_flight = engine.num_active
        engine.close()
        del engine
        self.deleted(f"{mode}: the snapshotted engine")
        fresh = self.engine(mode)
        t0 = time.perf_counter()
        restored = fresh.restore(str(path))
        restore_ms = (time.perf_counter() - t0) * 1e3
        post = lifecycle_answers(fresh.run_until_idle(max_chunks=400))
        after = read_counts()
        require(restored == len(snap["requests"]) > 0 and not set(pre) & set(post),
                f"{mode}: restored {restored} of {len(snap['requests'])}; "
                f"answered twice: {set(pre) & set(post)}")
        differ = sorted(u for u in ref["answers"] if {**pre, **post}.get(u) != ref["answers"][u])
        launches = {k: after[k] - before[k] for k in after}
        fields = {"snapshot_ms": snapshot_ms, "snapshot_bytes": path.stat().st_size,
                  "snapshot_requests": len(snap["requests"]), "in_flight_at_snapshot": in_flight,
                  "completed_before_snapshot": len(pre), "restore_ms": restore_ms,
                  "replay_launches": launches,
                  "replay_extra_launches": {k: launches[k] - ref["launches"][k]
                                            for k in ("local_attention_fwd", "sgu_fwd",
                                                      "paged_gate_mix", "paged_gate_mix_q8")},
                  "replay_differs": differ}
        require(not differ and set({**pre, **post}) == set(ref["answers"]),
                f"{mode}: the snapshot's replay differs from the uninterrupted run at {differ}")
        return fields, fresh

    def restart(self, mode: str, queue: dict, ref: dict) -> dict:
        """(b): ``run_with_restarts`` through LIFECYCLE_FAULT with no in-place
        retry: two engines built, the uninterrupted run's answers."""
        built = []

        def factory():
            built.append(self.engine(mode, fault_retries=0))
            return built[-1]

        faults.configure(LIFECYCLE_FAULT)
        try:
            done = run_with_restarts(factory, [Request(**r) for r in queue["first"]],
                                     attempts=3, max_chunks=400)
        finally:
            faults.reset()
        engines = len(built)
        del built
        self.deleted(f"{mode}: run_with_restarts' engines")
        differ = sorted(u for u, a in lifecycle_answers(done).items()
                        if a != ref["answers"][u])
        require(engines == 2 and not differ
                and set(lifecycle_answers(done)) == set(ref["answers"]),
                f"{mode}: run_with_restarts built {engines} engines, differs at {differ}")
        return {"engines_built": engines, "restart_differs": differ}

    def reload(self, mode: str, engine, queue: dict, fresh_p1: dict,
               p1_state: dict, p1_model_state: dict | None) -> dict:
        """(c): the idle ``engine`` reloads P1; its answers must be a fresh
        P1 engine's (``fresh_p1``), every completion of generation 1, and
        under ``quantize`` its serving weights bit-equal to the fresh one's
        (``p1_model_state``)."""
        t0 = time.perf_counter()
        generation = engine.reload_weights(params=p1_state)
        reload_ms = (time.perf_counter() - t0) * 1e3
        done = lifecycle_drive(engine, queue)
        answers = lifecycle_answers(done)
        differ = sorted(u for u in fresh_p1["answers"] if answers.get(u) != fresh_p1["answers"][u])
        weights_equal = None
        if p1_model_state is not None:
            weights_equal = all(torch.equal(v, p1_model_state[k].to(v.device))
                                for k, v in engine.model.state_dict().items())
        generations = sorted({comp.generation for comp in done})
        engine.close()
        require(generation == 1 and generations == [1] and not differ
                and weights_equal in (None, True),
                f"{mode}: reload generation {generation} {generations}, differs from a "
                f"fresh P1 engine at {differ}, weights equal {weights_equal}")
        return {"reload_ms": reload_ms, "reload_differs": differ,
                "reload_weights_bit_equal": weights_equal}


def engine_lifecycle(model, requests: list[dict], refs: dict | None = None) -> dict:
    """Phase 12: the engine's resume and operations at ProGen-small (bf16, 8
    slots, chunk 32, page 16) on ``requests`` (the 12 ``engine_requests``),
    dense, paged, 8-bit pages, speculative (identity draft), disaggregated
    (paged) and the workloads mode (paged, a LoRA bank of 4 tenants, an
    infill, an embed, a fork, a shed, a cold bucket and a late priority).
    ``refs`` holds earlier phases' uninterrupted runs by mode (answers and
    launches); a mode without one runs it here.  Checks: (a) a snapshot after
    two steps restored on a fresh engine replays to the uninterrupted
    answers; (b) ``run_with_restarts`` through a decode fault builds 2
    engines and gives the same answers (dense, paged); (c) ``reload_weights``
    at idle from P0 to P1 gives a fresh P1 engine's answers, the serving
    weights bit-equal under 8-bit pages, generation 1 (dense, 8-bit); (d) a
    watchdog of 30 s beaten by every engine never trips; (e) tracing on
    changes no token, the trace holds every engine span name, and the
    decode-chunk histogram counts every chunk; (f) a Trainer with
    ``statusz_port=0`` answers /healthz and /metricsz with ``train_loss``;
    (g) after each engine and Trainer is closed and deleted, the live
    memory is back within 256 MB of the phase's start.  The launch counts
    are set to 0 just before and read just after; returns them."""
    refs = dict(refs or {})
    smi = smi_name_power()
    c = model.config
    requests = capped(requests, LIFECYCLE_NEW_TOKENS)
    root = Path(tempfile.mkdtemp(prefix="progen-smoke-lifecycle-"))
    trips = []
    watchdog = Watchdog(LIFECYCLE_WATCHDOG_S, out_dir=str(root / "watchdog"),
                        exit_fn=trips.append, label="engine_lifecycle")
    bank = random_lora_bank(c, LORA_TENANTS, LORA_RANK, seed=SEED, device="cuda")
    queues = {mode: lifecycle_queue(c, requests, bank if mode == "workloads" else None)
              for mode in LIFECYCLE_MODES}
    sigterm = signal.getsignal(signal.SIGTERM)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    life = Lifecycle(model, watchdog, bank)
    t0 = time.perf_counter()
    reset_counts()
    watchdog.start()
    try:
        # (e) first, tracing off: the paged run timed without spans, and
        # against the earlier phase's paged run (the same answers)
        off = life.run("paged", queues["paged"], label="tracing off")
        if "paged" in refs:
            require(off["answers"] == refs["paged"]["answers"],
                    "engine_lifecycle: the paged run differs from the engine_paged phase's")
        refs["paged"] = off
        tracer = configure_tracing(enabled=True, capacity=LIFECYCLE_TRACE_CAPACITY,
                                   process="smoke")
        tracer.clear()
        on = life.run("paged", queues["paged"], label="tracing on")
        require(on["answers"] == off["answers"], "engine_lifecycle: tracing changed the tokens")
        require(on["histogram_count"] == on["chunks_run"] > 0,
                f"engine_lifecycle: engine.decode_chunk_s counted {on['histogram_count']} "
                f"of {on['chunks_run']} chunks")
        emit("engine_lifecycle_tracing", nvidia_smi=smi, tokens_per_s_tracing_off=off["tokens_per_s"],
             tokens_per_s_tracing_on=on["tokens_per_s"], chunks_run=on["chunks_run"],
             decode_chunk_histogram_count=on["histogram_count"], seconds_off=off["seconds"],
             seconds_on=on["seconds"])

        # weights P1: fresh engines that build their own from another seed
        p1_state, fresh_p1 = None, {}
        for mode in LIFECYCLE_RELOADS:
            engine = life.engine(mode, c, policy=make_policy(True), device="cuda",
                                 seed=SEED + 1)
            if p1_state is None:
                require(not engine.quantize, "the first fresh P1 engine must hold P1 whole")
                p1_state = {k: v.detach().cpu() for k, v in engine.model.state_dict().items()}
            fresh_p1[mode] = {"answers": lifecycle_answers(lifecycle_drive(engine, queues[mode])),
                              "weights": ({k: v.cpu() for k, v in engine.model.state_dict().items()}
                                          if engine.quantize else None)}
            engine.close()
            del engine
            life.deleted(f"{mode}: a fresh engine on P1")

        for mode in LIFECYCLE_MODES:
            if mode not in refs:
                refs[mode] = life.run(mode, queues[mode])
            ref = refs[mode]
            fields, engine = life.snapshot_replay(mode, queues[mode], ref,
                                                  root / f"snapshot_{mode}.json")
            if mode in LIFECYCLE_RELOADS:
                fields.update(life.reload(mode, engine, queues[mode], fresh_p1[mode],
                                          p1_state, fresh_p1[mode]["weights"]))
            engine.close()
            del engine
            life.deleted(f"{mode}: the replay's engine")
            if mode in LIFECYCLE_RESTARTS:
                fields.update(life.restart(mode, queues[mode], ref))
            if mode == "workloads":
                require(1024 in ref["admit_buckets"],
                        f"no cold admit bucket of 1024: {ref['admit_buckets']}")
            emit("engine_lifecycle", mode=mode, nvidia_smi=smi, **fields)
        del p1_state, fresh_p1
        engine_launches, routes = read_counts(), read_routes()
        require_forward_routes(routes, engine_launches, True, "engine_lifecycle")
        mixes = engine_launches["paged_gate_mix"] + engine_launches["paged_gate_mix_q8"]
        require(routes["paged_gate_mix"] == {"bulk": mixes, "simt": 0} and mixes > 0,
                f"engine_lifecycle: paged gate mix launches by route {routes['paged_gate_mix']}")

        # (e) the trace of every run since tracing went on
        (root / "trace").mkdir()
        tracer.dump(trace_dump_path(str(root / "trace"), "smoke"))
        configure_tracing(enabled=False, process="main")
        trace_file = merge_trace_dir(str(root / "trace"))
        names = {e["name"] for e in json.loads(Path(trace_file).read_text())["traceEvents"]}
        missing = sorted(set(SERVE_SPANS) - names)
        tracer.clear()
        require(not missing, f"engine_lifecycle: the trace lacks {missing}")

        statusz = lifecycle_statusz(c, root, life)
    finally:
        watchdog.stop()
        configure_tracing(enabled=False, process="main")
        faults.reset()
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(root, ignore_errors=True)
    require(not watchdog.tripped and not trips, f"engine_lifecycle: the watchdog tripped {trips}")
    launches = read_counts()
    emit("engine_lifecycle_summary", nvidia_smi=smi, seconds=time.perf_counter() - t0,
         modes=list(LIFECYCLE_MODES),
         watchdog_timeout_s=LIFECYCLE_WATCHDOG_S, watchdog_tripped=False,
         trace_span_names=sorted(n for n in names if n.startswith("serve.")),
         statusz=statusz, start_bytes=life.start_bytes, after_delete=life.after_delete,
         launches=launches)
    return {"engine_lifecycle": {**launches,
                                 "paged_gate_mix_by_route": routes["paged_gate_mix"]}}


def lifecycle_statusz(c, root: Path, life: Lifecycle) -> dict:
    """(f): a Trainer with ``statusz_port=0`` takes LIFECYCLE_TRAINER_STEPS
    steps over ``train_data_synth/``; /healthz and /metricsz answer on
    loopback, /metricsz with ``train_loss``; then it is closed and
    deleted."""
    never = 100 * LIFECYCLE_TRAINER_STEPS
    trainer = Trainer(c, trainer_config(
        LIFECYCLE_TRAINER_STEPS, statusz_port=0, prefetch_depth=0, warm_sampler=False,
        checkpoint_every=never, validate_every=never, sample_every=never),
        str(TRAINER_DATA), str(root / "ck"),
        tracker=Tracker(out_dir=str(root / "runs"), use_wandb=False), device="cuda")
    try:
        out = trainer.run()
        base = f"http://127.0.0.1:{trainer.statusz_port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        with urllib.request.urlopen(f"{base}/metricsz", timeout=10) as resp:
            metrics = resp.read().decode()
    finally:
        trainer.close()
        trainer.tracker.finish()
    loss = [line for line in metrics.splitlines() if line.startswith("train_loss ")]
    require(health["status"] == "ok" and health["last_step"]["step"] == LIFECYCLE_TRAINER_STEPS
            and loss == [f"train_loss {out['loss']!r}"],
            f"engine_lifecycle: statusz answered {health} and {loss}")
    fields = {"port": trainer.statusz_port, "healthz_last_step": health["last_step"]["step"],
              "metricsz_train_loss": loss[0], "metricsz_lines": len(metrics.splitlines())}
    del trainer, out
    shutil.rmtree(root / "ck", ignore_errors=True)
    life.deleted("the statusz Trainer")
    return fields


def lifecycle_model() -> ProGen:
    """The engine_lifecycle phase's model: ProGen-small at LIFECYCLE_DEPTH
    layers (bf16, seed 0)."""
    config = dataclasses.replace(SMALL, depth=LIFECYCLE_DEPTH)
    return ProGen(config, make_policy(True), device="cuda", seed=SEED).eval()


def engine_lifecycle_alone() -> dict:
    """The engine_lifecycle phase with what it needs (the build, the model),
    on its own:
    ``python3 -c "import chip_smoke as cs; cs.engine_lifecycle_alone()"``."""
    kernels.build()
    return engine_lifecycle(lifecycle_model(), engine_requests(SMALL))


# -- phase 11: across ranks ----------------------------------------------------

# K1 with a halo (b, h, n, d, wsz), dtype, timed: bf16 on the Hopper route
# at the training shape and ProGen-base's window, on the WMMA route at
# dim_head 32 and a window of 64; f32 (WMMA) at the training shape, the
# meshed f32 Trainer's own.  The two at the training shape are timed: each
# is the route of one of the meshed Trainer's runs.
GRAPH_REPLAYS = 3                  # replays of each kernel's captured launch
GRAPHS_FAULT = "serve.decode_chunk:io_error:at=1"
GRAPHS_NEW_TOKENS = 64             # the reload and fault runs' cap (64-192 before phase 18)
# mode -> the eager run's phase and the engine's arguments (the draft is
# filled in by the phase)
GRAPH_MODES = {
    "dense": ("engine_dense", {}),
    "paged": ("engine_paged", {"paged": True}),
    "weights+pages": ("engine_paged_q8", {"paged": True, "quantize": "weights+pages"}),
    "spec_paged": ("engine_spec_paged", {"paged": True, "spec": True,
                                         "spec_k": ENGINE_SPEC_K}),
    "disagg_paged": ("engine_disagg_paged", {"paged": True, "disagg": True}),
}


def capture_replay_check(kernel: str, call, refill) -> dict:
    """One launch of ``call()`` captured alone in a CUDA graph (after an
    eager warm-up on the capture's stream), then ``GRAPH_REPLAYS`` times:
    ``refill(k)`` writes new data into the captured inputs in place, the
    graph replays, and an eager launch on the same inputs must give the
    replay's bits."""
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    stream = graphs.capture_stream("cuda")  # the engine's: one cuBLAS workspace
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        static = as_tuple(call())
    equal = []
    for k in range(GRAPH_REPLAYS):
        refill(k)
        graph.replay()
        eager = as_tuple(call())
        torch.cuda.synchronize()
        equal.append(all(torch.equal(a, b) for a, b in zip(static, eager)))
    fields = {"kernel": kernel, "replays": GRAPH_REPLAYS, "bit_equal": equal}
    emit("graph_capture_check", **fields)
    require(all(equal), f"{kernel}: a replay differs from an eager launch: {equal}")
    return fields


def graph_capture_checks(gen) -> list[dict]:
    """K1-fwd, K2-fwd, K3 and K3-q8 each captured alone at the engine's
    shapes (an admit program of bucket 512 at 8 slots: K1-fwd (8, 8, 512,
    128) bf16 over windows of 256, K2-fwd (8, 512, 2048) bf16; the paged
    decode step's K3 over a bf16 pool with f32 weights and K3-q8 over int8
    ones, 8 rows, n = 1024, page 16) and replayed with new data: new inputs
    for K1 and K2, new positions, tables and pool rows for K3 and K3-q8."""
    c, bf16 = SMALL, torch.bfloat16

    def renew(*tensors):
        def refill(_):
            for t in tensors:
                t.copy_(torch.randn(t.shape, device="cuda", generator=gen).to(t.dtype))
        return refill

    out = []
    q, k, v = (torch.randn(ENGINE_SLOTS, c.heads, 512, c.dim_head, device="cuda",
                           generator=gen).to(bf16) for _ in range(3))
    out.append(capture_replay_check(
        "local_attention_fwd",
        lambda: cuda_attention.local_attention_fwd(q, k, v, c.window_size), renew(q, k, v)))
    half = c.dim * c.ff_mult // 2
    res, gate = (torch.randn(ENGINE_SLOTS, 512, half, device="cuda",
                             generator=gen).to(bf16) for _ in range(2))
    w = (torch.randn(512, 512, device="cuda", generator=gen) * 0.05).to(bf16)
    bias = torch.ones(512, 1, device="cuda", dtype=bf16)
    out.append(capture_replay_check(
        "sgu_fwd", lambda: cuda_sgu.spatial_gate_fwd(res, gate, w, bias),
        renew(res, gate, w)))
    rng = np.random.default_rng(SEED + 13)
    for name, variant in (("paged_gate_mix", "f32_w"), ("paged_gate_mix_q8", "int8_w_int8_pool")):
        case = paged_case(gen, c.seq_len, half, ENGINE_PAGE, list(PAGED_POS), bf16)
        args, kw = paged_args(case, variant)
        pool, table, pos = args[2], case["table"], case["pos"]
        num_pages, ppr = pool.shape[0], table.shape[1]

        def refill(_, pool=pool, table=table, pos=pos, num_pages=num_pages, ppr=ppr):
            new_pos = rng.integers(0, c.seq_len, size=len(PAGED_POS))
            perm = rng.permutation(num_pages - 2) + 2
            new_table = np.zeros((len(PAGED_POS), ppr), np.int32)
            for b, p in enumerate(new_pos):
                new_table[b, : p // ENGINE_PAGE + 1] = perm[b * ppr: b * ppr + p // ENGINE_PAGE + 1]
            table.copy_(torch.from_numpy(new_table))
            pos.copy_(torch.from_numpy(new_pos.astype(np.int32)))
            if pool.dtype == torch.int8:
                pool.copy_(torch.randint(-127, 128, pool.shape, device="cuda", generator=gen,
                                         dtype=torch.int8))
            else:
                pool.copy_(torch.randn(pool.shape, device="cuda", generator=gen).to(pool.dtype))

        out.append(capture_replay_check(
            name, lambda args=args, kw=kw: cuda_paged_gate_mix.paged_gate_mix(*args, **kw),
            refill))
    return out


def graph_engine(model, **kwargs) -> ServingEngine:
    """A warmed engine of the smoke's shape over ``model``."""
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           max_len=model.config.seq_len, page_size=ENGINE_PAGE, **kwargs)
    warm_up(engine)
    return engine


def graph_answers(engine, requests: list[dict], phase: str) -> dict:
    """``requests`` answered by ``engine``: tokens by uid, every status ok."""
    for r in requests:
        engine.submit(Request(**r))
    done, _ = drive(engine, phase, time.perf_counter())
    require(all(comp.status == "ok" for comp in done)
            and sorted(comp.uid for comp in done) == sorted(r["uid"] for r in requests),
            f"{phase}: statuses {[(comp.uid, comp.status) for comp in done]}")
    return {comp.uid: comp.tokens.tolist() for comp in done}


def graph_vs_eager(graphed: dict, eager: dict) -> dict:
    """The warmed run's warm-up and its tokens/s and time to the first
    chunk beside the eager run's (``run_engine``/``run_workloads`` fields)."""
    warm = graphed["aot_warmup"]
    return {"programs": warm["programs"], "warmup_s": warm["seconds"],
            "allocated_bytes": warm["allocated_bytes"], "reserved_bytes": warm["reserved_bytes"],
            "chunk_host_launches": warm["chunk_host_launches"],
            "chunks_run": graphed["chunks_run"],
            "tokens_per_s": {"eager": eager["tokens_per_s"], "graphed": graphed["tokens_per_s"]},
            "first_chunk_s": {"eager": eager["first_chunk_s"],
                              "graphed": graphed["first_chunk_s"],
                              "graphed_with_warmup": warm["seconds"] + graphed["first_chunk_s"]}}


def engine_graphs(model, requests: list[dict], eager: dict, workloads: tuple) -> dict:
    """``ServingEngine.aot_warmup`` at ProGen-small (bf16, 8 slots, chunk
    32, page 16): every program of the grid one captured CUDA graph, each
    dispatch one replay.  First K1-fwd, K2-fwd, K3 and K3-q8 each captured
    alone and replayed with new data, bit-equal to eager launches.  Then in
    every mode (dense, paged, 8-bit pages, speculative paged with the
    ``draft_config_for`` draft, disaggregated paged) the smoke's 12
    requests through a warmed engine: the tokens identical to the eager
    run's in the same mode (``eager``: tokens by phase), the launches the
    smoke's formula; and the workloads queue (a bank of 4 tenants, the
    embedding programs warmed) identical to the eager run's (``workloads``:
    completions by uid, fields): tokens, statuses and embeddings.  On the
    paged engine: a reload P0 -> P1 captures the grid again and answers as
    a fresh warmed engine on P1; an injected decode fault is retried and
    changes nothing; after every engine is closed and deleted the live
    memory is back within 256 MB of the phase's start.  Returns each
    warmed run's launches."""
    c = model.config
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    checks = graph_capture_checks(gen)
    draft = ProGen(draft_config_for(c), make_policy(True), device="cuda", seed=SEED).eval()
    launches, summary = {}, {}
    for mode, (eager_phase, kwargs) in GRAPH_MODES.items():
        phase = f"engine_graphs_{mode.replace('+', '_')}"
        kwargs = {**kwargs, "draft_params": draft} if kwargs.get("spec") else kwargs
        # the speculative runs are on the requests cut to SPEC_NEW_TOKENS
        mode_requests = capped(requests, SPEC_NEW_TOKENS) if kwargs.get("spec") else requests
        tokens, launches[phase], engine = run_engine(phase, model, mode_requests, aot=True,
                                                     **kwargs)
        differ = [u for u in eager[eager_phase] if tokens.get(u) != eager[eager_phase][u]]
        require(not differ, f"{phase}: tokens of {differ} differ from the eager engine's")
        summary[mode] = graph_vs_eager(ENGINE_FIELDS[phase], ENGINE_FIELDS[eager_phase])
        engine.close()
        del engine
    del draft

    got_eager, eager_fields = workloads
    queue = workload_queue(c)
    bank = random_lora_bank(c, LORA_TENANTS, LORA_RANK, seed=SEED, device="cuda")
    got, fields, launches["engine_graphs_workloads"], engine = run_workloads(
        "engine_graphs_workloads", model, queue, bank, True, aot=True)
    same = lambda a, b: (a.tokens.tolist() == b.tokens.tolist() and a.status == b.status
                         and (a.embedding is None) == (b.embedding is None)
                         and (a.embedding is None or np.array_equal(a.embedding, b.embedding)))
    differ = [u for u in got_eager if not same(got[u], got_eager[u])]
    emit("engine_graphs_workloads", **fields, differ_from_eager=differ)
    require(not differ, f"engine_graphs_workloads: {differ} differ from the eager run")
    summary["workloads"] = graph_vs_eager(fields, eager_fields)
    engine.close()
    del engine, bank

    # on the paged engine: a reload, a fault, on the requests cut to
    # GRAPHS_NEW_TOKENS
    paged = cut(eager["engine_paged"], GRAPHS_NEW_TOKENS)
    requests = capped(requests, GRAPHS_NEW_TOKENS)
    p1 = ProGen(c, make_policy(True), device="cuda", seed=SEED + 1).eval()
    engine = graph_engine(model, paged=True)
    t0 = time.perf_counter()
    engine.reload_weights(p1.state_dict())  # the caller's model: a copy, the grid again
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    require(all(p.captured for p in engine._aot.values()), "a program was not captured again")
    reloaded = graph_answers(engine, requests, "engine_graphs_reload")
    engine.close()
    fresh = graph_engine(p1, paged=True)
    on_p1 = graph_answers(fresh, requests, "engine_graphs_fresh_p1")
    fresh.close()
    del engine, fresh, p1
    require(reloaded == on_p1, "after a reload the warmed engine differs from a fresh one on P1")
    require(reloaded != paged, "the reload changed no token")

    faults.configure(GRAPHS_FAULT, seed=0)
    try:
        engine = graph_engine(model, paged=True)
        faulted = graph_answers(engine, requests, "engine_graphs_fault")
        contained = engine.robust.faults_contained
    finally:
        faults.reset()
    engine.close()
    del engine
    require(contained >= 1 and faulted == paged,
            f"the injected decode fault: {contained} contained, answers equal "
            f"{faulted == paged}")

    gc.collect()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    require(live - start_bytes <= LIFECYCLE_MEMORY_SLACK,
            f"engine_graphs: {live - start_bytes} bytes live above the phase's start")
    emit("engine_graphs", nvidia_smi=smi_name_power(), modes=summary, capture_checks=checks,
         reload={"seconds": reload_s, "answers_equal_fresh_p1": True},
         fault={"plan": GRAPHS_FAULT, "faults_contained": contained, "answers_equal": True},
         live_above_start_bytes=live - start_bytes, seconds=time.perf_counter() - t_phase)
    return launches


def engine_graphs_alone() -> dict:
    """The engine_graphs phase with the eager runs it compares against, on
    its own: ``python3 -c "import chip_smoke as cs; cs.engine_graphs_alone()"``."""
    kernels.build()
    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED).eval()
    requests = engine_requests(SMALL)
    draft = ProGen(draft_config_for(SMALL), make_policy(True), device="cuda", seed=SEED).eval()
    eager = {}
    for mode, (phase, kwargs) in GRAPH_MODES.items():
        kwargs = {**kwargs, "draft_params": draft} if kwargs.get("spec") else kwargs
        eager[phase], _, engine = run_engine(phase, model, requests, **kwargs)
        engine.close()
    del draft, engine
    bank = random_lora_bank(SMALL, LORA_TENANTS, LORA_RANK, seed=SEED, device="cuda")
    got, fields, _, engine = run_workloads("engine_workloads", model, workload_queue(SMALL),
                                           bank, True)
    engine.close()
    del engine, bank
    return engine_graphs(model, requests, eager, (got, fields))


SUPERSTEP_K = 4                   # the superstep Trainer's span
SUPERSTEP_SCHEDULE = dict(name="constant", base_lr=TRAIN_LR, warmup_steps=32)
SUPERSTEP_RUNS = ((4, 1, 2), (2, 2, 2))  # (K, accumulation, dispatches) against eager steps
SUPERSTEP_TIMED_STEPS = 8         # steps of each timed Trainer run (16 before phase 17)
SUPERSTEP_TRAINER_DEPTH = 3       # the superstep Trainers' layers (6 before phase 19, 12 before phase 17)
SUPERSTEP_TRACES = 1              # bare and profiled runs of each traced span (3 before phase 17)
SUPERSTEP_TRACED_STEPS = 2        # steps of each traced span (the profiler is slow)
SUPERSTEP_CADENCES = dict(validate_every=3, checkpoint_every=4, log_every=2,
                          sample_every=1000)  # tests/test_trainer_e2e.py:261
REMAT_POLICIES = (None, "full", "dots", "attn")
REMAT_RUNS_F32 = (None, "full", "dots", "attn")  # no remat once: its step is deterministic
REMAT_TIMED_STEPS = 4             # bf16 steps timed per policy, after one warm-up
TOL_REMAT_LOSS = 1e-6             # JAX's remat bars (tests/test_model.py:125-147)
TOL_REMAT_GRAD = (1e-5, 1e-6)     # rtol, atol


def remat_launch_formula(c, policy) -> dict:
    """Each kernel's launches a train step (accumulation 1) under a remat
    policy: K1-fwd once a layer, again in the backward under ``full`` and
    ``dots`` (``attn`` keeps its lse); K2-fwd twice a gMLP layer (forward,
    d_res), once more under every policy (the feed-forward is replayed)."""
    g = c.global_mlp_depth
    want = dict.fromkeys(COUNTERS, 0)
    want.update(local_attention_fwd=c.depth * (2 if policy in ("full", "dots") else 1),
                local_attention_bwd_dq=c.depth, local_attention_bwd_dkv=c.depth,
                sgu_fwd=2 * g + (g if policy else 0), sgu_bwd_dgate=g, sgu_bwd_dw=g)
    return want


def training_capture_checks(gen) -> list[dict]:
    """K1-fwd, K1-dq, K1-dkv, K2-fwd, K2-dgate and K2-dW each captured alone
    at the train step's shapes in bf16 (K1: (8, 8, 1024, 128) over windows
    of 256; K2: (8, 1024, 2048), the (1024, 1024) weights) and replayed
    GRAPH_REPLAYS times with new data, each replay bit-equal to an eager
    launch.  K1's backward inputs get the lse and D of a forward on the new
    data (eager, before the replay)."""
    c, bf16 = SMALL, torch.bfloat16
    b, h, n, d, wsz = TRAIN_BATCH, c.heads, c.seq_len, c.dim_head, c.window_size
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=gen).to(bf16)
    q, k, v, do = (rnd(b, h, n, d) for _ in range(4))
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
    dd = (do.float() * out.float()).sum(-1)

    def refill_attention(_):
        for t in (q, k, v, do):
            t.copy_(rnd(*t.shape))
        o, new_lse = cuda_attention.local_attention_fwd(q, k, v, wsz)
        lse.copy_(new_lse)
        dd.copy_((do.float() * o.float()).sum(-1))

    half = c.dim * c.ff_mult // 2
    res, gate, dout = (rnd(b, n, half) for _ in range(3))
    w = (torch.randn(n, n, device="cuda", generator=gen) * 0.05).to(bf16)
    bias = torch.ones(n, 1, device="cuda", dtype=bf16)

    def refill_sgu(_):
        for t in (res, gate, dout, w):
            t.copy_(rnd(*t.shape) * (0.05 if t is w else 1.0))

    return [
        capture_replay_check("local_attention_fwd",
                             lambda: cuda_attention.local_attention_fwd(q, k, v, wsz),
                             refill_attention),
        capture_replay_check("local_attention_bwd_dq", lambda: cuda_attention.
                             local_attention_bwd_dq(q, k, v, do, lse, dd, wsz),
                             refill_attention),
        capture_replay_check("local_attention_bwd_dkv", lambda: cuda_attention.
                             local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz),
                             refill_attention),
        capture_replay_check("sgu_fwd", lambda: cuda_sgu.spatial_gate_fwd(res, gate, w, bias),
                             refill_sgu),
        capture_replay_check("sgu_bwd_dgate", lambda: cuda_sgu.spatial_gate_dgate(w, dout, res),
                             refill_sgu),
        capture_replay_check("sgu_bwd_dw", lambda: cuda_sgu.spatial_gate_dw(dout, res, gate),
                             refill_sgu),
    ]


def superstep_model(lora: bool):
    """ProGen-small (or ``LoRAProGen`` rank 8) in bf16 compute from the
    smoke's seed, and a copy of its initial parameters."""
    if lora:
        model = LoRAProGen(SMALL, LORA_RANK, make_policy(True), device="cuda", seed=SEED)
    else:
        model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED)
    return model, {k: v.detach().clone() for k, v in model.state_dict().items()}


def superstep_fns(model, initial: dict, accum: int):
    """``model`` back at ``initial``, fresh train functions (no captured
    step) with a warmup schedule (the lr moves every step), a fresh state."""
    model.load_state_dict(initial)
    schedule = make_lr_schedule(**SUPERSTEP_SCHEDULE)
    if isinstance(model, LoRAProGen):
        fns = lora_train_functions(model, learning_rate=schedule, grad_accum_every=accum)
    else:
        fns = make_train_functions(model, make_optimizer(schedule, grad_accum_every=accum))
    return fns, fns.init_state()


def state_tensors(state) -> dict:
    """Clones of every tensor of a train state, by kind and name."""
    opt = state.opt_state
    out = {f"params.{k}": v for k, v in state.params.items()}
    for kind in ("mu", "nu", "acc_grads"):
        out.update({f"{kind}.{k}": v for k, v in (getattr(opt, kind) or {}).items()})
    return {k: t.detach().clone() for k, t in out.items()}


def superstep_vs_eager(k: int, accum: int, dispatches: int, lora: bool = False) -> dict:
    """From one init, ``dispatches`` calls of ``train_multi_step`` over
    ``(k, accum, 8, 1025)`` superbatches against the same micro-batches
    through ``train_step``: every loss, grad norm and lr, every parameter,
    both moments and the accumulator bit-equal (the step is deterministic:
    the embedding's weight gradient is a one-hot product); LoRA's base
    bit-unchanged."""
    micro = train_batches(SMALL, TRAIN_BATCH, dispatches * k * accum, SEED + 21)
    supers = [torch.stack(micro[i * k * accum:(i + 1) * k * accum]).reshape(
        k, accum, TRAIN_BATCH, -1) for i in range(dispatches)]
    runs = []
    model, initial = superstep_model(lora)
    for fused in (False, True):
        fns, state = superstep_fns(model, initial, accum)
        base = ({n: p.detach().clone() for n, p in state.params.items() if n.startswith("base.")}
                if lora and fused else None)
        metrics = []
        if fused:
            for sb in supers:
                state, m = fns.train_multi_step(state, sb)
                metrics.append(m)
            flat = {key: torch.cat([m[key].reshape(-1) for m in metrics])
                    for key in ("loss", "grad_norm", "lr")}
        else:
            for batch in micro:
                state, m = fns.train_step(state, batch)
                metrics.append(m)
            flat = {key: torch.stack([m[key] for m in metrics]) for key in ("loss", "grad_norm")}
            flat["lr"] = torch.stack([m["lr"] for m in metrics])[accum - 1::accum]
        torch.cuda.synchronize()
        tensors = state_tensors(state)
        if base is not None:
            require(all(torch.equal(state.params[n], t) for n, t in base.items()),
                    "a frozen base parameter changed in the LoRA superstep")
        runs.append((flat, tensors))
        del fns, state, metrics
        gc.collect()
    del model, initial

    def differ(a, b) -> dict:
        (fa, ta), (fb, tb) = a, b
        out = {key: float((fa[key].float() - fb[key].float()).abs().max()) for key in fa}
        out["state"] = max(float((ta[n].float() - tb[n].float()).abs().max()) for n in ta)
        out["state_tensors_differ"] = sum(not torch.equal(ta[n], tb[n]) for n in ta)
        return out

    fused_vs_eager = differ(runs[-1], runs[0])
    bit_equal = fused_vs_eager["state_tensors_differ"] == 0 and all(
        v == 0.0 for key, v in fused_vs_eager.items() if key != "state_tensors_differ")
    result = {"model": f"LoRAProGen rank {LORA_RANK}" if lora else "ProGen", "k": k,
              "accum": accum, "dispatches": dispatches, "bit_equal": bit_equal,
              "superstep_vs_eager": fused_vs_eager,
              "losses": runs[-1][0]["loss"].tolist(), "lrs": runs[-1][0]["lr"].tolist(),
              "state_tensors": len(runs[0][1])}
    emit("superstep_vs_eager", **result)
    require(bit_equal, f"the superstep differs from the eager steps: {result}")
    return result


def remat_checks(c=SMALL) -> dict:
    """Each remat policy at batch 8: in f32 the loss and every gradient
    bit-equal to no remat's (JAX's bar, loss 1e-6 relative and gradients
    1e-5 / 1e-6, is printed beside); in bf16 compute the peak memory, the
    eager step's ms (median of
    REMAT_TIMED_STEPS after one), each kernel's launches a step against
    :func:`remat_launch_formula`, and the ms of a step replayed from its
    capture."""
    batch = train_batches(c, TRAIN_BATCH, 1, SEED + 22)[0]
    f32, want_grads, want_loss = {}, None, None
    model = ProGen(c, make_policy(False), device="cuda", seed=SEED)
    for policy in REMAT_RUNS_F32:
        model.remat, model.remat_policy = policy is not None, policy
        model.zero_grad(set_to_none=True)
        loss = batch_loss(model(batch[:, :-1]), batch[:, 1:])
        loss.backward()
        loss = loss.detach()
        grads = {n: p.grad for n, p in model.named_parameters()}
        if want_grads is None:
            want_loss, want_grads = loss, grads
            continue
        rtol, atol = TOL_REMAT_GRAD
        bit = torch.equal(loss, want_loss) and all(torch.equal(g, want_grads[n])
                                                   for n, g in grads.items())
        loss_err = float((loss - want_loss).abs() / want_loss.abs())
        grad_ok = all(bool(((g - want_grads[n]).abs() <= atol + rtol * want_grads[n].abs()).all())
                      for n, g in grads.items())
        errs = {n: float((g - want_grads[n]).abs().max()) for n, g in grads.items()}
        worst = max(errs, key=errs.get)
        f32[policy] = {
            "bit_equal": bit, "within_jax_bar": loss_err <= TOL_REMAT_LOSS and grad_ok,
            "loss_rel_err": loss_err, "grad_max_abs_err": errs[worst], "worst_leaf": worst,
            "leaves_differ": sum(e > 0 for e in errs.values()), "leaves": len(errs)}
        require(bit, f"remat {policy}: gradients not bit-equal to no remat's: {f32[policy]}")
        del grads
    del want_grads, model
    gc.collect()

    bf16 = {}
    batches = train_batches(c, TRAIN_BATCH, REMAT_TIMED_STEPS + 1, SEED + 23)
    gc.collect()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    model, initial = superstep_model(False)
    # the copy of the initial parameters is the smoke's, not the step's
    initial_bytes = sum(t.numel() * t.element_size() for t in initial.values())
    for policy in REMAT_POLICIES:
        model.remat, model.remat_policy = policy is not None, policy
        model.load_state_dict(initial)
        model.zero_grad(set_to_none=True)
        fns = make_train_functions(model, make_optimizer(TRAIN_LR))
        state = fns.init_state()
        state, _ = fns.train_step(state, batches[0])  # warm-up
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step, step_ms = [], []
        for b in batches[1:]:
            prior = read_counts()
            t0 = time.perf_counter()
            state, m = fns.train_step(state, b)
            float(m["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: v - prior[k] for k, v in read_counts().items()})
        want = remat_launch_formula(c, policy)
        peak = torch.cuda.max_memory_allocated()
        bf16[policy or "none"] = {"peak_bytes": peak,
                                  "peak_above_start_bytes": peak - start - initial_bytes,
                                  "step_ms_median": float(np.median(step_ms)),
                                  "step_ms": step_ms, "launches_per_step": per_step[0],
                                  "formula": want}
        require(all(p == want for p in per_step),
                f"remat {policy}: launches a step {per_step}, want {want}")
        # the same steps as replays of the captured step: the device's cost
        superbatch = torch.stack(batches[1:]).reshape(len(batches) - 1, 1, TRAIN_BATCH, -1)
        state, _ = fns.train_multi_step(state, superbatch[:1])  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fns.train_multi_step(state, superbatch)
        float(m["loss"][-1, -1])
        bf16[policy or "none"]["captured_step_ms"] = ((time.perf_counter() - t0) * 1e3
                                                      / len(superbatch))
        del fns, state, m
        gc.collect()
    model.remat = False
    model.zero_grad(set_to_none=True)
    del model, initial
    gc.collect()
    return {"f32_vs_no_remat": f32, "bf16": bf16}


def superstep_trainer(c, root: Path, name: str, max_steps: int, superstep: int,
                      count: bool = True, **overrides):
    """A ``Trainer`` with ``superstep`` over ``train_data_synth/``; with
    ``count``, each dispatch's span and launches (a synchronize around
    each: not for the timed runs)."""
    trainer = Trainer(c, trainer_config(max_steps, superstep=superstep, prefetch_depth=0,
                                        checkpoint_keep_n=2, **overrides),
                      str(TRAINER_DATA), str(root / f"ck_{name}"),
                      tracker=Tracker(out_dir=str(root / f"runs_{name}"), use_wandb=False),
                      device="cuda")
    dispatches = []
    key = "train_multi_step" if superstep > 1 else "train_step"
    real = getattr(trainer.fns, key)

    def counted(state, batch):
        before = read_counts()
        out = real(state, batch)
        dispatches.append({"span": batch.shape[0] if superstep > 1 else 1,
                           "launches": {k: v - before[k] for k, v in read_counts().items()}})
        return out

    if count:
        trainer.fns = dataclasses.replace(trainer.fns, **{key: counted})
    result = trainer.run()
    trainer.tracker.finish()
    rows = [json.loads(line) for f in (root / f"runs_{name}").glob("*/metrics.jsonl")
            for line in f.read_text().splitlines()]
    return trainer, result, dispatches, rows


def superstep_timing(c) -> dict:
    """A superstep of SUPERSTEP_TRACED_STEPS replays against as many eager
    steps, at batch 8 in bf16, traced (``trace_main_path._traced``: wall,
    device ms, idle share, device and host launches, per step); the
    capture's seconds and the bytes its pool holds."""
    model, initial = superstep_model(False)
    fns, state = superstep_fns(model, initial, 1)
    del initial
    steps = SUPERSTEP_TRACED_STEPS
    batches = train_batches(c, TRAIN_BATCH, steps, SEED + 24)
    superbatch = torch.stack(batches).reshape(steps, 1, TRAIN_BATCH, -1)
    for b in batches[:2]:  # eager warm-up: the build, cuBLAS, the allocator
        state, _ = fns.train_step(state, b)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    state, _ = fns.train_multi_step(state, superbatch[:1])  # the warm-up step + the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    program = fns.captured_program()
    held = {"allocated_bytes": torch.cuda.memory_allocated() - alloc0,
            "reserved_bytes": torch.cuda.memory_reserved() - reserved0}

    def eager():
        nonlocal state
        for b in batches:
            state, _ = fns.train_step(state, b)

    def replayed():
        nonlocal state
        state, _ = fns.train_multi_step(state, superbatch)

    out = {}
    for label, fn in (("eager", eager), ("captured", replayed)):
        traced = trace_main_path._traced(fn, torch.device("cuda"), repeats=SUPERSTEP_TRACES)
        out[label] = {"step_ms": traced["wall_ms"] / steps,
                      "device_ms": traced["device_busy_ms"] / steps,
                      "idle_share": traced["idle_share"],
                      "device_launches": traced["device_launches"] / steps,
                      "host_launches": traced["host_launches"] / steps,
                      "event_span_ms": traced["event_span_ms"] / steps,
                      "tokens_per_s": TRAIN_BATCH * c.seq_len / (traced["wall_ms"] / steps / 1e3)}
    require(program is fns.captured_program(), "the superstep captured again on one state")
    out.update(capture_s=capture_s, pool=held, program_host_launches=program.host_launches)
    del model, fns, state, program
    gc.collect()
    return out


def trainer_superstep(c=SMALL) -> dict:
    """The Trainer's superstep and remat at ProGen-small, batch 8 (bf16
    compute unless said): (1) the six training kernels captured alone and
    replayed with new data, bit-equal to eager launches; (2) from one
    init, ``train_multi_step`` against the eager steps, K 4 at accumulation
    1 and K 2 at accumulation 2, two dispatches each, and LoRA (rank 8, K 2,
    accumulation 2): bit-equal;
    (3) remat: f32 gradients bit-equal to no remat per policy, bf16 peak memory,
    step ms and launches against the formula; (4) the Trainer (at
    SUPERSTEP_TRAINER_DEPTH layers) with
    ``superstep=4`` over ``train_data_synth/`` (validate 3, checkpoint 4,
    log 2): to 4, then a resume to 6, bit-equal to ``superstep=1`` straight
    to 6, every dispatch's launches the formula; then SUPERSTEP_TIMED_STEPS
    steps at superstep 1 and 4, and one superstep traced against the eager
    steps; (5) after the Trainers are closed and deleted, the live
    memory within 256 MB of the phase's start.  The launch counts are set
    to 0 just before (4)'s Trainers and read after them.  Runs in a
    temporary directory it deletes."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.synchronize()
    start_bytes = torch.cuda.memory_allocated()
    seconds = {}
    t0 = time.perf_counter()
    checks = training_capture_checks(torch.Generator(device="cuda").manual_seed(SEED + 20))
    seconds["capture_checks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    equal = [superstep_vs_eager(k, accum, n) for k, accum, n in SUPERSTEP_RUNS]
    equal.append(superstep_vs_eager(2, 2, 2, lora=True))
    seconds["superstep_vs_eager"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    remat = remat_checks(c)
    seconds["remat"] = time.perf_counter() - t0
    emit("remat", nvidia_smi=smi_name_power(), **remat)
    t0 = time.perf_counter()

    root = Path(tempfile.mkdtemp(prefix="progen-smoke-superstep-"))
    sigterm = signal.getsignal(signal.SIGTERM)
    full = c
    c = dataclasses.replace(c, depth=SUPERSTEP_TRAINER_DEPTH)  # the Trainers' model
    step_launches = remat_launch_formula(c, None)
    try:
        reset_counts()
        ref, out_ref, _, _ = superstep_trainer(c, root, "ref", 6, 1, **SUPERSTEP_CADENCES)
        want = {k: v.detach().clone() for k, v in out_ref["state"].params.items()}
        ref.close()
        del ref, out_ref
        gc.collect()
        t1, out1, d1, _ = superstep_trainer(c, root, "fused", 4, SUPERSTEP_K,
                                            **SUPERSTEP_CADENCES)
        t1.close()
        del t1, out1
        gc.collect()
        t2, out2, d2, rows2 = superstep_trainer(c, root, "fused", 6, SUPERSTEP_K,
                                                **SUPERSTEP_CADENCES)
        got = {k: v.detach() for k, v in out2["state"].params.items()}
        differ = [k for k in want if not torch.equal(want[k], got[k])]
        t2.close()
        del t2, out2, got, want
        gc.collect()
        torch.cuda.synchronize()
        launches, routes = read_counts(), read_routes()
        spans = [d["span"] for d in d1 + d2]
        bad = [d for d in d1 + d2 if d["launches"] != {
            k: v * d["span"] for k, v in step_launches.items()}]
        require(spans == [2, 1, 1, 2], f"superstep spans {spans}, want [2, 1, 1, 2]")
        require(not bad, f"superstep dispatches launched other than the formula: {bad[:2]}")
        require(not differ, f"the resumed superstep run's params differ: {differ[:8]}")
        require_forward_routes(routes, launches, True, "trainer_superstep")

        timed = {}
        never = 10 * SUPERSTEP_TIMED_STEPS
        for i, k in enumerate((1, SUPERSTEP_K)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t, _, _, rows = superstep_trainer(
                c, root, f"timed{i}", SUPERSTEP_TIMED_STEPS, k, count=False,
                checkpoint_every=never, validate_every=never, sample_every=never,
                log_every=SUPERSTEP_K, background_checkpoint=False)
            step_ms = [r["step_ms"] for r in rows if "step_ms" in r]
            timed.setdefault(f"superstep_{k}", []).append({
                "step_ms": step_ms, "step_ms_median_after_first": float(np.median(step_ms[1:])),
                "tokens_per_s": TRAIN_BATCH * c.seq_len / (float(np.median(step_ms[1:])) / 1e3),
                "peak_bytes": torch.cuda.max_memory_allocated()})
            t.close()
            del t
            gc.collect()
            shutil.rmtree(root / f"ck_timed{i}", ignore_errors=True)
    finally:
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(root, ignore_errors=True)
    seconds["trainer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = full
    traced = superstep_timing(c)
    seconds["traced"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    result = {"config": "small", "batch": TRAIN_BATCH, "capture_checks": checks,
              "superstep_vs_eager": equal, "remat": remat,
              "trainer": {"k": SUPERSTEP_K, "depth": SUPERSTEP_TRAINER_DEPTH,
                          **SUPERSTEP_CADENCES, "spans": spans,
                          "resumed_params_equal": True, "timed": timed, "traced": traced},
              "launches": launches, "routes": routes, "nvidia_smi": smi_name_power(),
              "live_above_start_bytes": live - start_bytes,
              "seconds": time.perf_counter() - t_phase, "seconds_by_part": seconds}
    emit("trainer_superstep", **result)
    require(live - start_bytes <= LIFECYCLE_MEMORY_SLACK,
            f"trainer_superstep: {live - start_bytes} bytes live above the phase's start")
    return result


def trainer_superstep_alone() -> dict:
    """The trainer_superstep phase on its own:
    ``python3 -c "import chip_smoke as cs; cs.trainer_superstep_alone()"``."""
    kernels.build()
    return trainer_superstep()


HALO_CASES = (
    ((TRAIN_BATCH, 8, 1024, 128, 256), torch.bfloat16, True),
    ((1, 12, 2048, 128, 512), torch.bfloat16, False),
    ((2, 3, 1024, 32, 512), torch.bfloat16, False),
    ((2, 8, 1024, 128, 64), torch.bfloat16, False),
    ((TRAIN_BATCH, 8, 1024, 128, 256), torch.float32, True),
)
PARALLEL_STEPS = 4        # the meshed Trainer's steps in each run
PARALLEL_F32_DEPTH = 6    # the f32 runs' depth (ProGen-small's 12 before phase 16)
PARALLEL_TOL_LOSS = {False: 1e-4,  # f32: the f32 train step's bar (TOL_TRAIN_LOSS)
                     True: 1e-2}   # bf16 compute: a mean over 8 x 1024 bf16 logits
HALO_COUNTERS = ("local_attention_fwd_halo", "local_attention_bwd_dq_halo",
                 "local_attention_bwd_dkv_halo")
# the halo rows' names by the dtype (and so the route) they time
HALO_ROW_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32"}


def halo_inputs(gen, b, h, n, d, wsz, dtype):
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
                   for _ in range(4))
    kh, vh = (torch.randn(b, h, wsz, d, device="cuda", generator=gen).to(dtype)
              for _ in range(2))
    return q, k, v, do, kh, vh


def halo_kernels(q, k, v, do, kh, vh, wsz):
    """K1-fwd, K1-dq and K1-dkv: out, lse, dq, dk, dv and, with a halo,
    dk_halo, dv_halo."""
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, kh, vh)
    dd = (do.float() * out.float()).sum(-1)
    dq = cuda_attention.local_attention_bwd_dq(q, k, v, do, lse, dd, wsz, None, kh, vh)
    return (out, lse, dq,
            *cuda_attention.local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz, None, kh, vh))


def halo_case(gen, shape, dtype) -> tuple:
    """The three kernels with a random halo against the plain version with
    the same halo, on the route the shape must take, twice for the same
    bits; returns the inputs and the errors."""
    b, h, n, d, wsz = shape
    route = ("wgmma" if dtype == torch.bfloat16 and d in (64, 128) and wsz % 128 == 0
             else "wmma")
    inputs = halo_inputs(gen, *shape, dtype)
    q, k, v, do, kh, vh = inputs
    before = read_routes()
    got = halo_kernels(*inputs, wsz)
    torch.cuda.synchronize()
    after = read_routes()
    routed = {name: {r: after[name][r] - before[name][r] for r in after[name]}
              for name in ("local_attention_fwd", "local_attention_bwd")}
    want_out, want_lse = local_attention(q, k, v, window_size=wsz, return_lse=True,
                                         k_halo=kh, v_halo=vh)
    want = local_attention_bwd(q, k, v, got[0], got[1], do, wsz, k_halo=kh, v_halo=vh)
    res = {"out": compare(got[0], want_out, TOL_ATTN_OUT[dtype]),
           "lse": compare(got[1], want_lse, TOL[torch.float32]),
           **{name: close_scaled(g, w, dtype) for name, g, w in
              zip(("dq", "dk", "dv", "dk_halo", "dv_halo"), got[2:], want)}}
    same = all(torch.equal(a, g) for a, g in zip(halo_kernels(*inputs, wsz), got))
    want_routes = {name: {**dict.fromkeys(routed[name], 0), route: n_}
                   for name, n_ in (("local_attention_fwd", 1), ("local_attention_bwd", 2))}
    fields = {"shape": list(shape), "dtype": str(dtype), "route": route,
              "launches_by_route": routed, **res, "second_run_same_bits": same}
    emit("kernel_check", kernel="local_attention_halo", **fields)
    require(all(r["ok"] for r in res.values()) and same and routed == want_routes,
            f"K1 with a halo disagrees with its plain version: {fields}")
    return inputs, {name: r["max_abs_err"] for name, r in res.items()}


def split_sequence_identity(gen) -> dict:
    """ProGen-small's training shape, L = 1024 as two halves of 512 through
    the kernels, the right half haloed by the left half's last window,
    against the whole sequence at K1's bars."""
    b, h, n, d, wsz = TRAIN_BATCH, 8, SMALL.seq_len, SMALL.dim_head, SMALL.window_size
    q, k, v, do = (torch.randn(b, h, n, d, device="cuda", generator=gen).bfloat16()
                   for _ in range(4))
    half = n // 2
    whole = halo_kernels(q, k, v, do, None, None, wsz)
    left = halo_kernels(*(t[:, :, :half].contiguous() for t in (q, k, v, do)), None, None, wsz)
    kh, vh = (t[:, :, half - wsz:half].contiguous() for t in (k, v))
    right = halo_kernels(*(t[:, :, half:].contiguous() for t in (q, k, v, do)), kh, vh, wsz)
    torch.cuda.synchronize()
    dk_l, dv_l = left[3].clone(), left[4].clone()
    dk_l[:, :, -wsz:] += right[5]
    dv_l[:, :, -wsz:] += right[6]
    dtype = torch.bfloat16
    res = {"out": compare(torch.cat([left[0], right[0]], 2), whole[0], TOL_ATTN_OUT[dtype]),
           "lse": compare(torch.cat([left[1], right[1]], 2), whole[1], TOL[torch.float32]),
           "dq": close_scaled(torch.cat([left[2], right[2]], 2), whole[2], dtype),
           "dk": close_scaled(torch.cat([dk_l, right[3]], 2), whole[3], dtype),
           "dv": close_scaled(torch.cat([dv_l, right[4]], 2), whole[4], dtype)}
    res["out_bits_equal"] = torch.equal(torch.cat([left[0], right[0]], 2), whole[0])
    res["dq_bits_equal"] = torch.equal(torch.cat([left[2], right[2]], 2), whole[2])
    require(all(r["ok"] for name, r in res.items() if isinstance(r, dict)),
            f"the split sequence disagrees with the whole: {res}")
    return {"shape": [b, h, n, d], "window": wsz, "halves": 2, **res}


def halo_rows(inputs, errs: dict, all_errs: dict) -> list[dict]:
    """CUDA-event times of the three kernels with a halo at one timed case's
    shape and dtype, beside the same kernels without it (the phantom
    window: what the halo costs a launch), their bounds, the plain version
    and SDPA on the ``[halo ‖ own]`` layout (forward; backward, dq, dk and
    dv in one call)."""
    q, k, v, do, kh, vh = inputs
    b, h, n, d = q.shape
    wsz = kh.shape[2]
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, kh, vh)
    dd = (do.float() * out.float()).sum(-1)
    w = n // wsz
    qw = q.reshape(b, h * w, wsz, d)
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d), kh).reshape(b, h * w, 2 * wsz, d)
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d), vh).reshape(b, h * w, 2 * wsz, d)
    mask = window_mask(wsz, q.device)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(qw, kw, vw, attn_mask=mask,
                                                              scale=d ** -0.5))
    qg, kg, vg = (t.detach().requires_grad_() for t in (qw, kw, vw))
    o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=d ** -0.5)
    dow = do.reshape(b, h * w, wsz, d)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dow, retain_graph=True))
    plain_fwd = time_ms(lambda: local_attention(q, k, v, window_size=wsz, return_lse=True,
                                                k_halo=kh, v_halo=vh))
    plain_bwd = time_ms(lambda: local_attention_bwd(q, k, v, out, lse, do, wsz,
                                                    k_halo=kh, v_halo=vh), iters=5)
    esize = q.element_size()
    pairs = real_visible(n, wsz, halo=True) * b * h
    vec = b * h * n * d * esize
    halo = b * h * wsz * d * esize  # one halo tensor
    rowvec = 4.0 * b * h * n
    suffix = HALO_ROW_SUFFIX[q.dtype]
    fwd = cuda_attention.local_attention_fwd
    dq = cuda_attention.local_attention_bwd_dq
    dkv = cuda_attention.local_attention_bwd_dkv
    rows = []
    for name, fn, flops, nbytes, grads, plain_ms, library_ms in (
            ("local_attention_fwd_halo",
             lambda *halo: fwd(q, k, v, wsz, None, *halo),
             4.0 * d * pairs, 4 * vec + 2 * halo + rowvec, ("out", "lse"), plain_fwd, sdpa_fwd),
            ("local_attention_bwd_dq_halo",
             lambda *halo: dq(q, k, v, do, lse, dd, wsz, None, *halo),
             6.0 * d * pairs, 5 * vec + 2 * halo + 2 * rowvec, ("dq",), plain_bwd, sdpa_bwd),
            ("local_attention_bwd_dkv_halo",
             lambda *halo: dkv(q, k, v, do, lse, dd, wsz, None, *halo),
             8.0 * d * pairs, 6 * vec + 4 * halo + 2 * rowvec,
             ("dk", "dv", "dk_halo", "dv_halo"), plain_bwd, sdpa_bwd)):
        bound_ms, bound_by = bound(nbytes, flops, q.dtype)
        source = "local_attention_fwd.cu" if name.startswith("local_attention_fwd") \
            else "local_attention_bwd.cu"
        rows.append({
            "name": name + suffix, "route": "cuda",
            "k1_route": cuda_attention.fwd_route(q.dtype, d, wsz),
            "source": f"progen_tpu_torch/kernels/csrc/{source}",
            "replaces": "progen_tpu/ops/pallas_attention.py:258",
            "launches": None, "max_abs_err": max(errs[g] for g in grads),
            "ms": time_ms(lambda: fn(kh, vh)), "ms_without_halo": time_ms(lambda: fn(None, None)),
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "timed_shape": [b, h, n, d], "window": wsz, "timed_dtype": str(q.dtype),
            "bytes": nbytes, "flops": flops,
            "max_abs_err_all_checks": max(e for g in grads for e in all_errs[q.dtype][g]),
        })
        if name != "local_attention_fwd_halo":
            rows[-1]["plain_and_library_compute"] = "dq, dk and dv in one call"
        emit("kernel_time", **rows[-1])
    return rows


def meshed_trainer(c, root: Path, label: str, mixed_precision: bool = False,
                   **overrides) -> dict:
    """The Trainer for PARALLEL_STEPS steps (f32, or bf16 compute with
    ``mixed_precision``), no hooks but the final save and validation; its
    losses, per-step launches, step time, tokens/s and peak memory.  The
    Trainer's SIGTERM handler (a bound method) is dropped after the run, so
    that nothing of it outlives the run."""
    never = 10 * PARALLEL_STEPS
    sigterm = signal.getsignal(signal.SIGTERM)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    trainer, out, per_step, rows = run_trainer(
        c, root / f"ck_{label}", root / f"runs_{label}", PARALLEL_STEPS, "cuda",
        mixed_precision=mixed_precision, prefetch_depth=0, checkpoint_every=never,
        validate_every=never, sample_every=never, **overrides)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [r["step_ms"] for r in rows if "step_ms" in r]
    median = float(np.median(step_ms[1:]))
    saved = trainer.store.all_steps()
    signal.signal(signal.SIGTERM, sigterm)
    del trainer, out
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root / f"ck_{label}", ignore_errors=True)
    return {"losses": [r["loss"] for r in rows if "loss" in r], "step_ms": step_ms,
            "step_ms_median": median, "tokens_per_s": TRAIN_BATCH * c.seq_len / (median / 1e3),
            "peak_bytes": peak, "start_bytes": start, "peak_above_start_bytes": peak - start,
            "per_step_launches": per_step, "saved_steps": saved,
            "dtype": "bf16 compute, f32 params" if mixed_precision else "f32"}


def parallel_config(bf16: bool):
    """ProGen-small for the bf16 runs, at PARALLEL_F32_DEPTH layers for the
    f32 ones (K1 on its slow WMMA route: the phase's time)."""
    return SMALL if bf16 else dataclasses.replace(SMALL, depth=PARALLEL_F32_DEPTH)


def meshed_launches(c) -> dict:
    """Each kernel's launches in one meshed train step of ``c``."""
    per_step = {"local_attention_fwd": c.depth, "local_attention_bwd_dq": c.depth,
                "local_attention_bwd_dkv": c.depth, "sgu_fwd": 2 * c.global_mlp_depth,
                "sgu_bwd_dgate": c.global_mlp_depth, "sgu_bwd_dw": c.global_mlp_depth,
                **dict.fromkeys(HALO_COUNTERS, c.depth)}
    return {name: per_step.get(name, 0) for name in COUNTERS}


# the meshed runs: label, strategy, bf16 compute; the f32 pair is held to
# the f32 unmeshed run, the bf16 one to the bf16 unmeshed run
MESHED_RUNS = (("dp", "dp", False), ("fsdp", "fsdp", False), ("fsdp_bf16", "fsdp", True))


def parallel_phase(smi: str) -> tuple[list[dict], dict]:
    """Phase 11: (a) the halo kernels against the plain version, (b) the
    split-sequence identity, (c) the Trainer on a mesh of one rank against
    the Trainer without one, in f32 (``dp``, ``fsdp``: K1 on the WMMA
    route) and in bf16 compute (``fsdp``: K1 on the Hopper route).  The
    launch counts are set to 0 just before each precision's meshed runs and
    read just after; each timed halo row takes the launches of its route's
    runs.  Returns the six halo rows and the phase's result."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    names = ("out", "lse", "dq", "dk", "dv", "dk_halo", "dv_halo")
    errs = {dtype: {name: [] for name in names} for dtype in HALO_ROW_SUFFIX}
    timed_cases = []
    for shape, dtype, timed in HALO_CASES:
        inputs, case_errs = halo_case(gen, shape, dtype)
        for name, e in case_errs.items():
            errs[dtype][name].append(e)
        if timed:
            timed_cases.append((inputs, case_errs))
        del inputs
    rows = [row for inputs, case_errs in timed_cases
            for row in halo_rows(inputs, case_errs, errs)]
    del timed_cases
    split = split_sequence_identity(gen)
    emit("split_sequence", **split)

    c = SMALL
    root = Path(tempfile.mkdtemp(prefix="progen-smoke-parallel-"))
    sigterm = signal.getsignal(signal.SIGTERM)
    gc.collect()
    torch.cuda.empty_cache()
    unmeshed, meshed, by_precision = {}, {}, {}
    try:
        for bf16 in (False, True):
            unmeshed[bf16] = meshed_trainer(parallel_config(bf16), root,
                                            f"unmeshed_{int(bf16)}", bf16)
        initialize_distributed("cuda")  # a world of one, NCCL
        for bf16 in (False, True):
            reset_counts()
            for label, strategy, run_bf16 in MESHED_RUNS:
                if run_bf16 == bf16:
                    meshed[label] = meshed_trainer(parallel_config(bf16), root, label, bf16,
                                                   mesh=MeshConfig(-1, 1, 1, 1),
                                                   strategies=(strategy,))
            by_precision[bf16] = {"launches": read_counts(), "routes": read_routes()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(root, ignore_errors=True)
    launches = {name: sum(p["launches"][name] for p in by_precision.values())
                for name in COUNTERS}
    result = {"split_sequence": split, "launches": launches, "nvidia_smi": smi,
              "batch": TRAIN_BATCH, "seq_len": c.seq_len, "steps": PARALLEL_STEPS,
              "depth": {"f32": PARALLEL_F32_DEPTH, "bf16": c.depth},
              "unmeshed": unmeshed[False], "unmeshed_bf16": unmeshed[True],
              "launches_by_precision": {("bf16" if bf16 else "f32"): p["launches"]
                                        for bf16, p in by_precision.items()}}
    for label, _, bf16 in MESHED_RUNS:
        run, base = meshed[label], unmeshed[bf16]
        rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], base["losses"])]
        run["loss_rel_err"] = max(rel)
        run["loss_rel_bar"] = PARALLEL_TOL_LOSS[bf16]
        result[label] = run
        require(len(run["losses"]) == PARALLEL_STEPS == len(base["losses"])
                and run["loss_rel_err"] <= PARALLEL_TOL_LOSS[bf16],
                f"the meshed Trainer ({label}) lost {run['losses']}, the unmeshed one "
                f"{base['losses']}")
        want = meshed_launches(parallel_config(bf16))
        bad = [i for i, got in enumerate(run["per_step_launches"]) if got != want]
        require(not bad, f"meshed ({label}) steps {bad} launched other than {want}")
        require(run["saved_steps"] == [PARALLEL_STEPS],
                f"meshed ({label}) saved {run['saved_steps']}")
    for bf16, p in by_precision.items():
        what = f"the meshed Trainer ({'bf16' if bf16 else 'f32'})"
        require(all(p["launches"][name] > 0 for name in HALO_COUNTERS),
                f"{what} did not launch the halo kernels: {p['launches']}")
        require_forward_routes(p["routes"], p["launches"], bf16, what)
        bwd = p["launches"]["local_attention_bwd_dq"] + p["launches"]["local_attention_bwd_dkv"]
        route = "wgmma" if bf16 else "wmma"
        want_bwd = {**dict.fromkeys(p["routes"]["local_attention_bwd"], 0), route: bwd}
        require(p["routes"]["local_attention_bwd"] == want_bwd,
                f"{what}: K1's backward by route {p['routes']['local_attention_bwd']}, "
                f"want {want_bwd}")
    for row in rows:
        bf16 = not row["name"].endswith(HALO_ROW_SUFFIX[torch.float32])
        counter = row["name"].removesuffix(HALO_ROW_SUFFIX[torch.float32])
        row["launches"] = by_precision[bf16]["launches"][counter]
        row["launches_by_path"] = {"parallel_bf16" if bf16 else "parallel_f32": row["launches"]}
    return rows, result


def parallel_summary(result: dict) -> dict:
    """The phase's result without the per-step launch lists (the first step's
    stands for every step, all having been checked equal)."""
    return {**{k: ({key: val for key, val in v.items() if key != "per_step_launches"}
                   if isinstance(v, dict) and "per_step_launches" in v else v)
               for k, v in result.items()},
            "launches_per_step": {label: result[label]["per_step_launches"][0]
                                  for label, _, _ in MESHED_RUNS}}


def parallel_alone() -> dict:
    """Phase 11 on its own, with the build:
    ``python3 -c "import chip_smoke as cs; cs.parallel_alone()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("build", per_source=kernels.build())
    rows, result = parallel_phase(smi_name_power())
    emit("parallel", **parallel_summary(result))
    print(json.dumps({"kernels": rows}), flush=True)
    return result


# the trainer_mesh phase: the memory planner against the card, tensor
# parallelism and the superstep on a world-1 mesh
MEMORY_BIG_BATCH = 40          # ProGen-small, no remat: a peak above 40 GB
MEMORY_OVER_BATCH = 96         # a plan over 80 GB, refused before any allocation
# more (batch, policy) points: with batch 8 and MEMORY_BIG_BATCH, the
# points the activation model's factors were fitted to (memory_fit_alone)
MEMORY_FIT_BATCHES = ((16, None), (16, "full"), (16, "attn"), (16, "dots"), (48, "full"),
                      (32, "attn"))
TOL_MEMORY_PLAN = 0.05         # plan against the measured peak
MESH_SUPERSTEP_STEPS = 8       # each superstep Trainer's steps (spans of 4, log 4)
MESH_SUPERSTEP_DEPTH = 3       # their ProGen-small's layers (bf16 compute; 6 before phase 19)
# the tp runs: label, strategies, bf16 compute; each held to the unmeshed run
# of its precision at the readings of phase 11's meshed runs
TP_RUNS = (("fsdp_tp", ("fsdp", "tp"), False), ("dp_tp_sp", ("dp", "tp", "sp"), False),
           ("fsdp_tp_bf16", ("fsdp", "tp"), True), ("dp_tp_sp_bf16", ("dp", "tp", "sp"), True))
TP_TOL_LOSS = {False: 1.3e-6, True: 4.0e-4}   # phase 11's meshed f32 / bf16 readings


def step_peak(c, batch: int, policy=None, steps: int = 2) -> dict:
    """``steps`` eager bf16 train steps of a fresh model at ``batch``: the
    peak of ``max_memory_allocated`` above the bytes live before the model
    was built."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = ProGen(c, make_policy(True), device="cuda", seed=SEED,
                   remat=policy is not None, remat_policy=policy or "full")
    fns = make_train_functions(model, make_optimizer(TRAIN_LR))
    state = fns.init_state()
    for b in train_batches(c, batch, steps, SEED + 30):
        state, m = fns.train_step(state, b)
    float(m["loss"])
    peak = torch.cuda.max_memory_allocated() - start
    del model, fns, state, m
    gc.collect()
    return {"peak_above_start_bytes": peak}


def memory_point(label: str, measured: int, **plan_kw) -> dict:
    """One calibration point: the plan's total and terms beside the
    measured peak above the start."""
    p = memory_plan(SMALL, **plan_kw)
    terms = {k: getattr(p, k) for k in (
        "params_bytes", "moments_bytes", "accumulator_bytes", "grad_bytes",
        "activation_bytes", "cast_bytes", "logits_bytes", "unshard_bytes",
        "snapshot_bytes", "superbatch_bytes")}
    return {"point": label, **{k: v for k, v in plan_kw.items()},
            "measured_bytes": measured, "plan_bytes": p.total_bytes,
            "plan_over_measured": p.total_bytes / measured, "terms": terms}


def memory_calibration(remat: dict | None, root: Path, fit: bool = False) -> dict:
    """(a) The plan against ``max_memory_allocated`` above the start: the
    four remat policies at batch 8 (``trainer_superstep``'s peaks, or
    measured here), no remat at MEMORY_BIG_BATCH, the Trainer with its
    background checkpoint's snapshot and ``superstep=4``; a Trainer whose
    plan is over the card refused before anything is allocated; the serving
    plan against a paged engine's own state bytes.  ``fit``: also the
    MEMORY_FIT_BATCHES points."""
    c = SMALL
    points = []
    for policy in REMAT_POLICIES:
        name = policy or "none"
        measured = (remat["bf16"][name]["peak_above_start_bytes"] if remat is not None
                    else step_peak(c, TRAIN_BATCH, policy)["peak_above_start_bytes"])
        points.append(memory_point(f"batch 8, remat {name}", measured,
                                   batch_size=TRAIN_BATCH, remat=policy is not None,
                                   remat_policy=policy or "full"))
    for batch, policy in ((MEMORY_BIG_BATCH, None), *(MEMORY_FIT_BATCHES if fit else ())):
        points.append(memory_point(
            f"batch {batch}, remat {policy or 'none'}",
            step_peak(c, batch, policy)["peak_above_start_bytes"],
            batch_size=batch, remat=policy is not None, remat_policy=policy or "full"))
    # the Trainer: a background checkpoint at step 4 whose snapshot lives
    # through the next span, superstep 4 (captured).  The span's replays
    # run in the graph's private pool, which allocates nothing: the card
    # holds the bytes allocated when the snapshot is made plus the pool's
    # reserved bytes that no live tensor holds (the step's working set)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    at_snapshot = []
    real_snapshot = trainer_module._snapshot

    def snapshot(state):
        out = real_snapshot(state)
        torch.cuda.synchronize()
        at_snapshot.append(torch.cuda.memory_allocated())
        return out

    never = 100
    with mock.patch.object(trainer_module, "_snapshot", snapshot):
        t, out, _, _ = superstep_trainer(c, root, "memory", 8, SUPERSTEP_K, count=False,
                                         checkpoint_every=4, validate_every=never,
                                         sample_every=never, log_every=4,
                                         background_checkpoint=True)
    peak_allocated = torch.cuda.max_memory_allocated() - start
    pool = t.fns.captured_program()._graph.pool()
    segments = [seg for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool)]
    pool_free = sum(seg["total_size"] - seg["allocated_size"] for seg in segments)
    peak = max(peak_allocated, max(at_snapshot) - start + pool_free)
    saved = [s for s in t.checkpoint_log if s.get("background")]
    t.close()
    del t, out
    gc.collect()
    shutil.rmtree(root / "ck_memory", ignore_errors=True)
    points.append(memory_point("Trainer, snapshot, superstep 4", peak,
                               batch_size=TRAIN_BATCH, checkpoint_snapshot=True,
                               superstep_k=SUPERSTEP_K))
    points[-1].update(background_saves=len(saved), peak_allocated_bytes=peak_allocated,
                      allocated_at_snapshots=[b - start for b in at_snapshot],
                      graph_pool_free_bytes=pool_free,
                      graph_pool_reserved_bytes=sum(seg["total_size"] for seg in segments))
    # a configuration over the card: refused before anything is allocated
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    refused = None
    try:
        Trainer(c, trainer_config(1, batch_size=MEMORY_OVER_BATCH), str(TRAINER_DATA),
                str(root / "ck_over"), device="cuda")
    except ValueError as e:
        refused = str(e)
    after = torch.cuda.memory_allocated()
    over = memory_plan(c, batch_size=MEMORY_OVER_BATCH, checkpoint_snapshot=True)
    refusal = {"batch": MEMORY_OVER_BATCH, "plan_bytes": over.total_bytes,
               "card_bytes": device_hbm_bytes(), "refused": refused is not None,
               "message_head": (refused or "").splitlines()[0] if refused else None,
               "allocated_before": before, "allocated_after": after}
    # the serving plan against a paged engine's state (no request run)
    model = ProGen(c, make_policy(True), device="cuda", seed=SEED).eval()
    engine = ServingEngine(model, num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                           paged=True, page_size=ENGINE_PAGE)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in graphs.flatten(engine.state)[0])
    seq = engine.state["seq"]
    sp = serving_plan(c, num_slots=ENGINE_SLOTS, max_len=engine.max_len, paged=True,
                      page_size=ENGINE_PAGE, num_pages=engine._pool.num_pages)
    scalars = state_bytes - sum(t.numel() * t.element_size() for t in (
        *graphs.flatten(engine.state["caches"])[0], seq, engine.state["lmask"]))
    serving = {"mode": "paged", "slots": ENGINE_SLOTS, "page": ENGINE_PAGE,
               "state_bytes": state_bytes, "plan_bytes": sp.total_bytes,
               "table_bytes_on_host": sp.table_bytes,
               "seq_int64_extra_bytes": seq.numel() * (seq.element_size() - 4),
               "slot_scalar_bytes": scalars,
               "plan_vs_state_minus_int64_and_scalars": sp.total_bytes - sp.table_bytes
               - (state_bytes - seq.numel() * (seq.element_size() - 4) - scalars),
               "weight_bytes_full": sp.weight_bytes_full,
               "engine_workloads_peak_bytes_pr10": 3_104_229_376}
    engine.close()
    del engine, model
    gc.collect()
    worst = max(abs(p["plan_over_measured"] - 1) for p in points)
    return {"points": points, "worst_rel_err": worst, "tol": TOL_MEMORY_PLAN,
            "over_card": refusal, "serving": serving,
            "act_efficiency": dict(memory_module.ACT_EFFICIENCY)}


def require_memory(mem: dict) -> None:
    bad = [p for p in mem["points"] if abs(p["plan_over_measured"] - 1) > TOL_MEMORY_PLAN]
    require(not bad, f"the memory plan is off the measured peak by more than "
            f"{TOL_MEMORY_PLAN}: {[(p['point'], p['plan_over_measured']) for p in bad]}")
    require(any(p["measured_bytes"] > 40e9 for p in mem["points"]),
            "no calibration point above 40 GB")
    over = mem["over_card"]
    require(over["refused"] and over["allocated_after"] == over["allocated_before"],
            f"the over-card Trainer was not refused before allocating: {over}")
    require(mem["serving"]["plan_vs_state_minus_int64_and_scalars"] == 0,
            f"the serving plan differs from the engine's state: {mem['serving']}")


def mesh_trainer_params(trainer, out) -> dict:
    """The final parameters of a (meshed) Trainer's run, whole."""
    pieces = trainer._pieces
    return {n: full_tensor(p.detach(), pieces(n)).clone()
            for n, p in out["state"].params.items()}


def mesh_superstep_runs(c, root: Path) -> dict:
    """(c) On a world-1 mesh under ``dp`` and ``fsdp`` (bf16 compute,
    ProGen-small at MESH_SUPERSTEP_DEPTH layers): the Trainer with
    ``superstep=4`` against the per-step Trainer on the same mesh,
    MESH_SUPERSTEP_STEPS steps logged every 4: the logged losses and grad
    norms and every final parameter bit-equal; the spans and the route."""
    never = 100
    c = dataclasses.replace(c, depth=MESH_SUPERSTEP_DEPTH)
    out = {}
    for strategy in ("dp", "fsdp"):
        runs = {}
        for k in (1, SUPERSTEP_K):
            label = f"mesh_{strategy}_{k}"
            t, res, dispatches, rows = superstep_trainer(
                c, root, label, MESH_SUPERSTEP_STEPS, k, checkpoint_every=never,
                validate_every=never, sample_every=never, log_every=SUPERSTEP_K,
                background_checkpoint=False, mesh=MeshConfig(-1, 1, 1, 1),
                strategies=(strategy,))
            runs[k] = {"params": mesh_trainer_params(t, res),
                       "logged": [(r["step"], r["loss"], r["grad_norm"]) for r in rows
                                  if "loss" in r],
                       "spans": [d["span"] for d in dispatches],
                       "route": t.fns.superstep_route}
            t.close()
            del t, res
            gc.collect()
            shutil.rmtree(root / f"ck_{label}", ignore_errors=True)
        one, fused = runs[1], runs[SUPERSTEP_K]
        differ = [n for n in one["params"] if not torch.equal(one["params"][n],
                                                              fused["params"][n])]
        out[strategy] = {"route": fused["route"], "spans": fused["spans"],
                         "logged_per_step": one["logged"], "logged_superstep": fused["logged"],
                         "params_differ": differ, "params": len(one["params"]),
                         "bit_equal": not differ and one["logged"] == fused["logged"]}
        emit("mesh_superstep", strategy=strategy, **{k: v for k, v in out[strategy].items()})
        require(out[strategy]["bit_equal"],
                f"the meshed superstep ({strategy}) differs from its per-step run: "
                f"{out[strategy]}")
        require(fused["spans"] == [SUPERSTEP_K] * (MESH_SUPERSTEP_STEPS // SUPERSTEP_K),
                f"meshed superstep spans {fused['spans']}")
        del runs
    return out


def halo_capture_checks(gen) -> list[dict]:
    """K1-fwd, K1-dq and K1-dkv with a halo, each captured alone at the
    training shape (bf16, batch 8) and replayed with new data, bit-equal to
    eager launches."""
    c, bf16 = SMALL, torch.bfloat16
    wsz = c.window_size
    q, k, v, do, kh, vh = halo_inputs(gen, TRAIN_BATCH, c.heads, c.seq_len, c.dim_head,
                                      wsz, bf16)
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, kh, vh)
    dd = (do.float() * out.float()).sum(-1)

    def refill(_):
        for t in (q, k, v, do, kh, vh):
            t.copy_(torch.randn(t.shape, device="cuda", generator=gen).to(bf16))
        o, new_lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, kh, vh)
        lse.copy_(new_lse)
        dd.copy_((do.float() * o.float()).sum(-1))

    return [
        capture_replay_check("local_attention_fwd_halo", lambda: cuda_attention.
                             local_attention_fwd(q, k, v, wsz, None, kh, vh), refill),
        capture_replay_check("local_attention_bwd_dq_halo", lambda: cuda_attention.
                             local_attention_bwd_dq(q, k, v, do, lse, dd, wsz, None, kh, vh),
                             refill),
        capture_replay_check("local_attention_bwd_dkv_halo", lambda: cuda_attention.
                             local_attention_bwd_dkv(q, k, v, do, lse, dd, wsz, None, kh, vh),
                             refill),
    ]


def trainer_mesh_phase(smi: str, unmeshed: dict | None = None, remat: dict | None = None
                       ) -> dict:
    """Phase 16 (after ``parallel``): (a) the memory plan against the card
    (:func:`memory_calibration`); (b) the Trainer on a world-1 NCCL mesh
    under ``("fsdp", "tp")`` and ``("dp", "tp", "sp")``, f32 and bf16
    compute, PARALLEL_STEPS steps, its losses against the unmeshed run of
    its precision (``unmeshed``: the parallel phase's, else run here) at PR
    11's meshed bars; (c) the superstep on the mesh under ``dp`` and
    ``fsdp`` bit-equal to the per-step meshed run, the captured meshed step
    traced against its eager step, and K1 with a halo captured alone.  The
    launch counts are set to 0 just before (b) and read just after (c)'s
    Trainers."""
    t_phase = time.perf_counter()
    c = SMALL
    seconds = {}
    root = Path(tempfile.mkdtemp(prefix="progen-smoke-mesh-"))
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        t0 = time.perf_counter()
        mem = memory_calibration(remat, root)
        seconds["memory"] = time.perf_counter() - t0
        emit("memory_plan", nvidia_smi=smi, **mem)
        require_memory(mem)
        if unmeshed is None:
            unmeshed = {bf16: meshed_trainer(parallel_config(bf16), root,
                                             f"unmeshed_{int(bf16)}", bf16)
                        for bf16 in (False, True)}
        initialize_distributed("cuda")  # a world of one, NCCL
        tp, by_precision = {}, {}
        for precision in (False, True):  # the counts of each precision's runs
            t0 = time.perf_counter()
            reset_counts()
            for label, strategies, bf16 in TP_RUNS:
                if bf16 != precision:
                    continue
                run = meshed_trainer(parallel_config(bf16), root, label, bf16,
                                     mesh=MeshConfig(-1, 1, 1, 1), strategies=strategies)
                base = unmeshed[bf16]
                run["loss_rel_err"] = max(abs(a - b) / abs(b)
                                          for a, b in zip(run["losses"], base["losses"]))
                run["loss_rel_bar"] = TP_TOL_LOSS[bf16]
                run["unmeshed_step_ms_median"] = base["step_ms_median"]
                tp[label] = run
                require(len(run["losses"]) == PARALLEL_STEPS
                        and run["loss_rel_err"] <= TP_TOL_LOSS[bf16],
                        f"the tp Trainer ({label}) lost {run['losses']}, the unmeshed one "
                        f"{base['losses']}")
                want = meshed_launches(parallel_config(bf16))
                require(all(got == want for got in run["per_step_launches"]),
                        f"the tp Trainer ({label}) launched other than {want} a step")
                # the meshed Trainer's peak: one more calibration point
                run["plan_bytes"] = memory_plan(
                    parallel_config(bf16), batch_size=TRAIN_BATCH,
                    mesh_shape=dict.fromkeys(("data", "fsdp", "tensor", "seq"), 1),
                    strategies=strategies, mixed_precision=bf16).total_bytes
                run["plan_over_measured"] = run["plan_bytes"] / run["peak_above_start_bytes"]
                require(abs(run["plan_over_measured"] - 1) <= TOL_MEMORY_PLAN,
                        f"the plan of the tp Trainer ({label}) is off its peak: "
                        f"{run['plan_bytes']} against {run['peak_above_start_bytes']}")
            seconds[f"tp_{'bf16' if precision else 'f32'}"] = time.perf_counter() - t0
            if precision:
                t0 = time.perf_counter()
                superstep = mesh_superstep_runs(c, root)
                seconds["superstep"] = time.perf_counter() - t0
            by_precision[precision] = {"launches": read_counts(), "routes": read_routes()}
        launches = {name: sum(p["launches"][name] for p in by_precision.values())
                    for name in COUNTERS}
        t0 = time.perf_counter()
        traced = {}
        for strategy in ("fsdp",):  # FSDP2's host work: what the capture removes
            mesh = make_mesh(MeshConfig(-1, 1, 1, 1), "cuda")
            traced[strategy] = trace_main_path._trace_train(
                torch.device("cuda"), c, True, mesh, (strategy,),
                label=f"train_step_bf16_{strategy}_world1", superstep=SUPERSTEP_TRACED_STEPS,
                repeats=SUPERSTEP_TRACES)
            gc.collect()
            torch.cuda.empty_cache()
        seconds["traced"] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        signal.signal(signal.SIGTERM, sigterm)
        shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    halo_checks = halo_capture_checks(torch.Generator(device="cuda").manual_seed(SEED + 31))
    seconds["halo_capture"] = time.perf_counter() - t0
    require(all(launches[name] > 0 for name in COUNTERS
                if not name.startswith("paged_gate_mix")),
            f"trainer_mesh did not launch every training kernel: {launches}")
    for precision, p in by_precision.items():
        require_forward_routes(p["routes"], p["launches"], precision,
                               f"trainer_mesh ({'bf16' if precision else 'f32'})")
    result = {"config": "small", "batch": TRAIN_BATCH, "memory": mem, "tp": tp,
              "superstep": superstep, "traced": traced, "halo_capture_checks": halo_checks,
              "launches": launches, "nvidia_smi": smi,
              "launches_by_precision": {("bf16" if k else "f32"): p["launches"]
                                        for k, p in by_precision.items()},
              "seconds": time.perf_counter() - t_phase, "seconds_by_part": seconds}
    return result


def trainer_mesh_summary(result: dict) -> dict:
    """The phase's result without the per-step launch lists and traces'
    detail."""
    tp = {label: {k: v for k, v in run.items() if k != "per_step_launches"}
          for label, run in result["tp"].items()}
    traced = {s: [{k: r[k] for k in ("dispatch", "per_step_wall_ms", "per_step_device_busy_ms",
                                     "idle_share", "per_step_device_launches",
                                     "per_step_host_launches", "event_span_ms", "steps")
                   if k in r} for r in rows]
              for s, rows in result["traced"].items()}
    return {**{k: v for k, v in result.items() if k not in ("tp", "traced")},
            "tp": tp, "traced": traced}


# -- phase 17: decode under a mesh ----------------------------------------------

# the world-1 meshes of the phase: label, strategies
DECODE_MESH_RUNS = (("fsdp_tp", ("fsdp", "tp")), ("dp_tp_sp", ("dp", "tp", "sp")))
DECODE_MESH_MODES = (("dense", {}), ("paged", {"paged": True}),
                     ("paged_q8", {"paged": True, "quantize": "weights+pages"}))
RANK_TENSOR = 2  # the tensor split whose rank shapes the kernels are held at
TWO_RANK_SECONDS = 300  # the two gloo ranks' budget, their start included
TWO_RANK_LENGTH = 64    # the two ranks' sampler: the first prime to this length (128 before phase 18)
DECODE_MESH_LENGTH = 64  # the meshed samplers' length (the first prime; 256 before phase 19, 512 before phase 18, 1024 in phase 4)
DECODE_MESH_NEW_TOKENS = 32  # the meshed engines' cap on phase 7's requests (64-192 there; 64 before phase 18)
TWO_RANK_DEPTH = 6  # the two ranks' ProGen-small layers (12 before phase 18)


def mesh_model(dtype_bf16: bool, strategies):
    """ProGen-small (seed SEED) placed on a world-1 NCCL mesh under
    ``strategies``; returns the model, its mesh and its plan."""
    mesh = make_mesh(MeshConfig(1, 1, 1, 1), "cuda")
    model = ProGen(SMALL, make_policy(dtype_bf16), device="cuda", seed=SEED).eval()
    plan = parallelize(model, mesh, strategies)
    return model, mesh, plan


def mesh_primes() -> list[str]:
    rng = np.random.default_rng(SEED)
    return ["".join(rng.choice(list(AMINO), size=p)) for p in PRIME_LENGTHS]


def sample_primes(sampler, primes: list[str], length: int | None = None
                  ) -> tuple[list, dict]:
    """Each prime, SAMPLES_PER_PRIME rows of it, to ``length`` (default
    ``seq_len``) through ``sampler`` as phase 4 samples it (a generator
    seeded SEED + i per prime, top-k 25, temperature 1: a shorter length
    gives the prefix of the longer run); the tokens and the run's seconds
    and decode steps."""
    c = sampler.model.config
    length = length or c.seq_len
    out, steps = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, text in enumerate(primes):
        tokens = torch.tensor([encode_tokens(text)] * SAMPLES_PER_PRIME, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(SEED + i)
        out.append(sampler(tokens, length, generator=gen, top_k=25, add_bos=True,
                           temperature=1.0))
        start = len(text) + 1
        steps += min(start + sampler.last_num_chunks * sampler.chunk_size, length - 1) - start
    torch.cuda.synchronize()
    return out, {"total_s": time.perf_counter() - t0, "decode_steps": steps}


def prefill_ms(model, view, primes: list[str]) -> list[float]:
    """Each prime's prefill (SAMPLES_PER_PRIME rows, BOS-prefixed) alone,
    synchronized, after one warm call."""
    c = model.config
    prefill = make_prefiller(model, view)
    out = []
    for text in primes:
        p = len(text) + 1
        p_pad = pad_prime_length(p, c.window_size, c.seq_len)
        tokens = torch.zeros(SAMPLES_PER_PRIME, p_pad, dtype=torch.long, device="cuda")
        tokens[:, 1:p] = torch.tensor(encode_tokens(text), device="cuda")
        lengths = torch.full((SAMPLES_PER_PRIME,), p, device="cuda")
        prefill(tokens, lengths, decode_len=c.seq_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(tokens, lengths, decode_len=c.seq_len)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def mesh_prefill_vs_unmeshed(bf16: bool) -> dict:
    """The prefill's last logits of ProGen-small on each world-1 mesh
    against the unmeshed model's (both through the kernels; K1 through its
    halo entry on the mesh), at the longest prime's padded length, at the
    whole-model bars (f32 1e-3, bf16 0.1)."""
    c = SMALL
    rng = np.random.default_rng(SEED + 40)
    p = PRIME_LENGTHS[-1] + 1
    p_pad = pad_prime_length(p, c.window_size, c.seq_len)
    tokens = torch.tensor(rng.integers(1, c.num_tokens, size=(2, p_pad)), device="cuda")
    lengths = torch.tensor([p, p // 2], device="cuda")
    dtype = torch.bfloat16 if bf16 else torch.float32
    want, _ = make_prefiller(ProGen(c, make_policy(bf16), device="cuda", seed=SEED).eval())(
        tokens, lengths, decode_len=c.seq_len)
    out = {"dtype": str(dtype)}
    for label, strategies in DECODE_MESH_RUNS:
        model, _, _ = mesh_model(bf16, strategies)
        got, _ = make_prefiller(model, decode_view(model))(tokens, lengths, decode_len=c.seq_len)
        out[label] = compare(got, want, TOL_MODEL[dtype])
        require(bool(torch.isfinite(got).all()) and out[label]["ok"],
                f"the meshed prefill ({label}, {dtype}) is off the unmeshed one: {out[label]}")
        del model
        gc.collect()
    return out


def param_bytes(model) -> int:
    """The bytes of the parameters this rank holds (its shards)."""
    return sum(local(p).numel() * local(p).element_size() for p in model.parameters())


def step_bytes(model, view) -> dict:
    """One decode step of 8 rows at position 600 after a prefill: the
    parameter bytes the rank holds, and the step's peak above the bytes live
    before it (the blocks' unsharded copies under ``fsdp``, the
    activations)."""
    c = model.config
    prefill = make_prefiller(model, view)
    tokens = torch.randint(1, 25, (8, 768), device="cuda")
    lengths = torch.full((8,), 600, device="cuda")
    _, caches = prefill(tokens, lengths, decode_len=c.seq_len)
    step = incremental.ProGenDecodeStep(model, view)
    step(tokens[:, 599], lengths, caches)
    gc.collect()  # no garbage of earlier work freed inside the measured step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    step(tokens[:, 599], lengths, caches)
    torch.cuda.synchronize()
    return {"param_bytes": param_bytes(model),
            "step_peak_above_start_bytes": torch.cuda.max_memory_allocated() - start}


def rank_shape_rows(gen) -> list[dict]:
    """The kernels of the meshed path at the shapes a rank of a ``tensor``
    RANK_TENSOR mesh gives them at ProGen-small, bf16: K1-fwd through its
    halo entry with the zero window on 4 of 8 heads (B 4, L 1024, D 128),
    K2-fwd on 1024 of 2048 gate channels (B 4, n 1024), K3 and K3-q8 at d
    1024 (the engine's 8 ragged rows, page 16); each against its plain
    version at its row's bars, twice for the same bits and on the route of
    the whole width, then timed with its bound, plain version and library
    call.  ``launches`` is left to the caller."""
    c = SMALL
    h, half, wsz = c.heads // RANK_TENSOR, c.dim * c.ff_mult // 2 // RANK_TENSOR, c.window_size
    b, n, d = 4, c.seq_len, c.dim_head
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).bfloat16()
               for _ in range(3))
    zero = torch.zeros(b, h, wsz, d, device="cuda", dtype=torch.bfloat16)
    before = dict(cuda_attention.fwd_route_launches)
    out, lse = cuda_attention.local_attention_fwd(q, k, v, wsz, None, zero, zero)
    again = cuda_attention.local_attention_fwd(q, k, v, wsz, None, zero, zero)
    torch.cuda.synchronize()
    routed = {r: cuda_attention.fwd_route_launches[r] - before[r] for r in before}
    want, want_lse = local_attention(q, k, v, window_size=wsz, return_lse=True,
                                     k_halo=zero, v_halo=zero)
    res = {"out": compare(out, want, TOL_ATTN_OUT[torch.bfloat16]),
           "lse": compare(lse, want_lse, TOL[torch.float32]),
           "second_run_same_bits": torch.equal(out, again[0]) and torch.equal(lse, again[1]),
           "launches_by_route": routed}
    emit("kernel_check", kernel="local_attention_fwd_halo", shape=[b, h, n, d],
         halo="zero window", **res)
    require(res["out"]["ok"] and res["lse"]["ok"] and res["second_run_same_bits"]
            and routed == {**dict.fromkeys(routed, 0), "wgmma": 2},
            f"K1 with a zero halo at a rank's heads disagrees with its plain version: {res}")
    w = n // wsz
    qw = q.reshape(b, h * w, wsz, d)
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d), zero).reshape(b, h * w, 2 * wsz, d)
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d), zero).reshape(b, h * w, 2 * wsz, d)
    mask = window_mask(wsz, q.device)
    pairs = real_visible(n, wsz, halo=True) * b * h
    nbytes = 4.0 * b * h * n * d * 2 + 2 * b * h * wsz * d * 2 + 4.0 * b * h * n
    bound_ms, bound_by = bound(nbytes, 4.0 * d * pairs, torch.bfloat16)
    k1 = {"name": f"local_attention_fwd_halo_tp{RANK_TENSOR}", "route": "cuda",
          "k1_route": cuda_attention.fwd_route(torch.bfloat16, d, wsz),
          "source": "progen_tpu_torch/kernels/csrc/local_attention_fwd.cu",
          "replaces": "progen_tpu/ops/pallas_attention.py:258",
          "launches": None,
          "max_abs_err": max(res["out"]["max_abs_err"], res["lse"]["max_abs_err"]),
          "ms": time_ms(lambda: cuda_attention.local_attention_fwd(q, k, v, wsz, None,
                                                                   zero, zero)),
          "plain_ms": time_ms(lambda: local_attention(q, k, v, window_size=wsz,
                                                      return_lse=True, k_halo=zero,
                                                      v_halo=zero)),
          "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
              qw, kw, vw, attn_mask=mask, scale=d ** -0.5)),
          "timed_shape": [b, h, n, d], "window": wsz, "halo": "zero window",
          "timed_dtype": str(torch.bfloat16), "bytes": nbytes, "flops": 4.0 * d * pairs}
    emit("kernel_time", **k1)
    del q, k, v, qw, kw, vw, out, again, want
    inputs, err = sgu_case(gen, b, n, half, "normal", torch.bfloat16)
    k2 = {**sgu_fwd_row(inputs, err, [err]), "name": f"sgu_fwd_tp{RANK_TENSOR}"}
    emit("kernel_time", **k2)
    del inputs
    case = paged_case(gen, n, half, ENGINE_PAGE, PAGED_POS, torch.bfloat16)
    k3 = [paged_check(f"rank_of_tp{RANK_TENSOR}", case, "f32_w", "paged_gate_mix")]
    q8 = [paged_check(f"rank_of_tp{RANK_TENSOR}", case, "int8_w_int8_pool",
                      "paged_gate_mix_q8")]
    rows = [k1, k2,
            {**paged_row(f"paged_gate_mix_tp{RANK_TENSOR}", 54, case, "f32_w", k3)},
            {**paged_row(f"paged_gate_mix_q8_tp{RANK_TENSOR}", 81, case,
                         "int8_w_int8_pool", q8)}]
    return rows


def two_rank_config():
    """ProGen-small at TWO_RANK_DEPTH layers: a rank's real widths."""
    return dataclasses.replace(SMALL, depth=TWO_RANK_DEPTH)


def _two_rank_worker(rank: int, store: str, prime: str, length: int, bf16: bool,
                     queue) -> None:
    """One of two ranks on ``cuda:0`` meeting over gloo (NCCL refuses two
    ranks on one GPU): ProGen-small (TWO_RANK_DEPTH layers) placed on
    ``(1, 1, 2, 1)`` under ``tp``,
    ``prime`` through the meshed sampler as phase 4 samples it, then phase
    7's first two requests (16 new tokens each) through a paged and an
    8-bit paged engine; puts its tokens, the sampler's seconds and the
    launch counts of these runs.  Each stage is noted on stderr."""
    def note(stage: str) -> None:
        print(f"two ranks: rank {rank}: {stage}", file=sys.stderr, flush=True)

    try:
        note("started")
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2,
                                rank=rank, timeout=datetime.timedelta(seconds=300))
        note("process group")
        mesh = make_mesh(MeshConfig(1, 1, 2, 1), "cuda")
        model = ProGen(two_rank_config(), make_policy(bf16), device="cuda", seed=SEED).eval()
        # the 8-bit engine's int8 model, quantized whole on each rank (its
        # scales the whole weights') and then placed, as a user would
        quantized = ServingEngine._quantize_variables(model)
        plans = {"paged": parallelize(model, mesh, ("tp",)),
                 "paged_q8": parallelize(quantized, mesh, ("tp",))}
        plan = plans["paged"]
        note("placed")
        sampler = make_sampler(model, 64, mesh=mesh, strategies=("tp",), params_shardings=plan)
        reset_counts()
        got, run = sample_primes(sampler, [prime], length)
        note("sampled")
        # every K1-fwd and K2-fwd launch of the sampler on its dtype's route
        require_forward_routes(read_routes(), read_counts(), bf16, f"tp rank {rank}")
        routes = read_routes()
        engines = {}
        for mode, kwargs in DECODE_MESH_MODES[1:]:
            served = quantized if mode == "paged_q8" else model
            engine = ServingEngine(served, num_slots=2, chunk_size=16, max_len=SMALL.seq_len,
                                   page_size=ENGINE_PAGE, mesh=mesh, strategies=("tp",),
                                   params_shardings=plans[mode], **kwargs)
            for r in engine_requests(SMALL)[:2]:
                engine.submit(Request(**{**r, "max_new_tokens": 16}))
            engines[mode] = {c.uid: c.tokens.tolist() for c in engine.run_until_idle()}
            engine.close()
            note(f"served {mode}")
        # plain lists: a tensor crosses the queue as shared memory that dies
        # with this process
        queue.put((rank, {"tokens": got[0].tolist(), "engines": engines,
                          "launches": read_counts(),
                          "routes": routes, **run, "param_bytes": param_bytes(model)}))
        dist.destroy_process_group()
    except BaseException as e:
        note(f"failed: {type(e).__name__}: {e}")
        queue.put((rank, {"error": f"{type(e).__name__}: {e}"[-2000:]}))


def two_rank_decode(prime: str, want: torch.Tensor, length: int, bf16: bool) -> dict:
    """Two processes on the one card, each a rank of a ``(1, 1, 2, 1)``
    mesh under ``tp`` meeting over gloo (its collectives on CUDA tensors):
    the sampler at a tensor rank's real shapes end to end, eager.  Both
    ranks' tokens equal, at least ENGINE_TOKEN_MATCH of ``want`` (the
    unmeshed sampler's on the same prime and noise), every K1-fwd launch
    through the halo entry and every K1/K2-fwd launch on ``wgmma``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = tempfile.mktemp(prefix="progen-smoke-gloo-")
    procs = [ctx.Process(target=_two_rank_worker,
                         args=(r, store, prime, length, bf16, queue))
             for r in range(RANK_TENSOR)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + TWO_RANK_SECONDS
    try:
        while len(got) < len(procs) and time.monotonic() < deadline:
            with contextlib.suppress(queue_module.Empty):
                rank, out = queue.get(timeout=5)
                got[rank] = out
            if any("error" in g for g in got.values()):
                break
    finally:
        for p in procs:
            p.join(timeout=5 if len(got) < len(procs) else 60)
            if p.is_alive():
                p.kill()
    errors = {r: g["error"] for r, g in got.items() if "error" in g}
    require(not errors and len(got) == len(procs),
            f"two gloo ranks on the card failed or took over {TWO_RANK_SECONDS} s: "
            f"{errors or sorted(got)}")
    tokens = [torch.tensor(got[r].pop("tokens")) for r in range(RANK_TENSOR)]
    result = {**got[0], "ranks": RANK_TENSOR, "backend": "gloo", "length": length,
              "dtype": "bf16 compute" if bf16 else "f32",
              "every_rank_equal": all(torch.equal(t, tokens[0]) for t in tokens)
              and all(got[r]["engines"] == got[0]["engines"] for r in got),
              "token_match_vs_unmeshed": float((tokens[0] == want[:, :length].cpu())
                                               .float().mean()),
              "min_token_match": ENGINE_TOKEN_MATCH}
    launches = result["launches"]
    require(result["every_rank_equal"], "the two tp ranks sampled different tokens")
    require(result["token_match_vs_unmeshed"] >= ENGINE_TOKEN_MATCH,
            f"the two tp ranks kept {result['token_match_vs_unmeshed']} of the unmeshed tokens")
    require(launches["local_attention_fwd"] == launches["local_attention_fwd_halo"] > 0
            and launches["sgu_fwd"] > 0 and launches["paged_gate_mix"] > 0
            and launches["paged_gate_mix_q8"] > 0,
            f"the two tp ranks did not launch K1 through its halo entry, K2, K3 and K3-q8: "
            f"{launches}")
    return result


def step_vs_unmeshed(model, base) -> dict:
    """One bf16 decode step of the placed ``model`` on the caches of the
    unmeshed ``base``'s prefill (8 rows at ragged positions 37-600) against
    ``base``'s step on the same caches: the meshed step reads the same
    weights (FSDP2's unsharded copies under ``fsdp``), so bit-equal."""
    c = model.config
    rng = np.random.default_rng(SEED + 42)
    tokens = torch.tensor(rng.integers(1, 25, size=(8, 768)), device="cuda")
    lengths = torch.tensor([37, 100, 256, 257, 300, 511, 512, 600], device="cuda")
    _, caches = make_prefiller(base)(tokens, lengths, decode_len=c.seq_len)
    tok = tokens[torch.arange(8, device="cuda"), lengths - 1]
    want, _ = incremental.ProGenDecodeStep(base)(tok, lengths, incremental.copy_caches(caches))
    got, _ = incremental.ProGenDecodeStep(model, decode_view(model))(
        tok, lengths, incremental.copy_caches(caches))
    return {"bit_equal": torch.equal(got, want),
            "max_abs_err": float((got.float() - want.float()).abs().max())}


def sampled_match(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of equal tokens of two samplers' ``(B, length)`` outputs."""
    return float((got == want).float().mean())


def decode_rate(run: dict) -> float:
    """A sampler run's decode tokens/s: its rows' decode steps over its
    seconds less its prefill's (``prefill_ms``, timed alone)."""
    return (run["decode_steps"] * SAMPLES_PER_PRIME
            / (run["total_s"] - sum(run["prefill_ms"]) / 1e3))


def decode_mesh_phase(smi: str, unmeshed_engine: dict | None = None) -> dict:
    """Phase 17 (after ``trainer_mesh``): decode under a world-1 NCCL mesh
    at ProGen-small's full width and depth under ``(fsdp, tp)`` and ``(dp,
    tp, sp)``.  In bf16 compute over f32 params (the serving configuration):
    (a) the prefill's logits against the unmeshed model's (0.1; and in f32,
    1e-3); a decode step on the unmeshed prefill's caches bit-equal to the
    unmeshed step (:func:`step_vs_unmeshed`); the parameter bytes on the
    rank and a decode step's peak; (b) the sampler on phase 4's first prime
    x 2 samples to DECODE_MESH_LENGTH with phase 4's noise, under ``(fsdp,
    tp)`` twice, bit-equal, with prefill ms and decode tokens/s beside the
    unmeshed sampler's on the same prime and length, and once under ``(dp,
    tp, sp)``; (c) under ``(fsdp, tp)`` the engine on phase 7's 12
    requests cut to DECODE_MESH_NEW_TOKENS new tokens, dense, paged and
    8-bit pages, eager and warmed by ``aot_warmup``: warmed bit-equal to
    eager, tokens/s beside the unmeshed engine's.  The meshed bf16 tokens
    are held, at least ENGINE_TOKEN_MATCH, to unmeshed runs with K1
    through its halo entry (:func:`k1_zero_halo`), which every meshed
    prefill takes: that entry is one bf16 ulp from K1's plain launch, and
    a random-weight model's near-tied logits turn that into other tokens
    within a few steps, so the match with the plain unmeshed runs (phase
    4's sampler and phase 7's engines, ``unmeshed_engine``, else run here)
    is printed, not held.  (d) Two ranks on the one card meeting over gloo
    (:func:`two_rank_decode`), f32, held to the plain unmeshed f32
    sampler, and (e) the kernels at a tensor rank's shapes
    (:func:`rank_shape_rows`).  The launch counts are set to 0 at the
    start of (b) and summed over (b) and (c)."""
    t_phase = time.perf_counter()
    c = SMALL
    seconds = {}
    primes = mesh_primes()
    requests = capped(engine_requests(c), DECODE_MESH_NEW_TOKENS)
    t0 = time.perf_counter()
    base = ProGen(c, make_policy(True), device="cuda", seed=SEED).eval()
    if unmeshed_engine is None:
        unmeshed_engine = {}
        for mode, kwargs in DECODE_MESH_MODES:
            unmeshed_engine[mode], _, engine = run_engine(f"engine_{mode}_unmeshed", base,
                                                          requests, **kwargs)
            engine.close()
    # the references of the meshed bf16 tokens: K1 through its halo entry
    zero_halo_engine = {}
    for mode, kwargs in DECODE_MESH_MODES:
        zero_halo_engine[mode], _, engine = run_engine(
            f"decode_mesh_engine_{mode}_zero_halo_unmeshed", base, requests,
            zero_halo=True, **kwargs)
        engine.close()
    with k1_zero_halo():
        want, _ = sample_primes(make_sampler(base, 64), primes[:1], DECODE_MESH_LENGTH)
    plain, base_run = sample_primes(make_sampler(base, 64), primes[:1], DECODE_MESH_LENGTH)
    base_run.update(prefill_ms=prefill_ms(base, None, primes[:1]), **step_bytes(base, None))
    base_run["decode_tokens_per_s"] = decode_rate(base_run)
    base32 = ProGen(two_rank_config(), make_policy(False), device="cuda", seed=SEED).eval()
    want32, _ = sample_primes(make_sampler(base32, 64), primes[:1], TWO_RANK_LENGTH)
    del base32
    gc.collect()
    seconds["unmeshed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    two_ranks = two_rank_decode(primes[0], want32[0], TWO_RANK_LENGTH, False)
    seconds["two_ranks"] = time.perf_counter() - t0
    emit("decode_mesh_two_ranks", nvidia_smi=smi,
         **{k: v for k, v in two_ranks.items() if k != "routes"})
    initialize_distributed("cuda")  # a world of one, NCCL
    try:
        t0 = time.perf_counter()
        prefill_checks = {"f32": mesh_prefill_vs_unmeshed(False),
                          "bf16": mesh_prefill_vs_unmeshed(True)}
        emit("decode_mesh_prefill_vs_unmeshed", **prefill_checks)
        seconds["prefill_checks"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        reset_counts()
        sampled, launches, steps = {}, {name: 0 for name in COUNTERS}, {}
        for label, strategies in DECODE_MESH_RUNS:
            model, mesh, plan = mesh_model(True, strategies)
            steps[label] = step_vs_unmeshed(model, base)
            require(steps[label]["bit_equal"],
                    f"the meshed decode step ({label}) is off the unmeshed one: {steps[label]}")
            run = step_bytes(model, decode_view(model))
            reset_counts()
            sampler = make_sampler(model, 64, mesh=mesh, strategies=strategies,
                                   params_shardings=plan)
            got, timed = sample_primes(sampler, primes[:1], DECODE_MESH_LENGTH)
            require(bool(((got[0] >= 0) & (got[0] < c.num_tokens)).all())
                    and tuple(got[0].shape) == (SAMPLES_PER_PRIME, DECODE_MESH_LENGTH),
                    f"the meshed sampler ({label}) gave tokens out of shape or range")
            run.update(timed, token_match_vs_zero_halo_unmeshed=sampled_match(got[0], want[0]),
                       bit_equal_to_zero_halo_unmeshed=torch.equal(got[0], want[0]),
                       min_token_match=ENGINE_TOKEN_MATCH,
                       bf16_token_match_vs_unmeshed=sampled_match(got[0], plain[0]))
            require(run["token_match_vs_zero_halo_unmeshed"] >= ENGINE_TOKEN_MATCH,
                    f"the meshed bf16 sampler ({label}) kept "
                    f"{run['token_match_vs_zero_halo_unmeshed']} of the unmeshed tokens "
                    "with K1 through its halo entry")
            if label == "fsdp_tp":  # twice bit-equal; the sampler's time
                again, _ = sample_primes(sampler, primes[:1], DECODE_MESH_LENGTH)
                run["repeat_bit_equal"] = torch.equal(again[0], got[0])
                require(run["repeat_bit_equal"],
                        f"two meshed samplers ({label}) gave other tokens")
                run["prefill_ms"] = prefill_ms(model, decode_view(model), primes[:1])
                run["decode_tokens_per_s"] = decode_rate(run)
                del again
            del model, sampler, got
            gc.collect()
            for name, n in read_counts().items():
                launches[name] += n
            run["unmeshed"] = base_run
            run["step_vs_unmeshed"] = steps[label]
            sampled[label] = run
            emit("decode_mesh_sampler", mesh=label, strategies=strategies, nvidia_smi=smi,
                 **run)
        require(launches["local_attention_fwd"] == launches["local_attention_fwd_halo"] > 0
                and launches["sgu_fwd"] > 0,
                f"the meshed prefills did not all go through K1's halo entry and K2: {launches}")
        seconds["sampler"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        engines = {}
        model, mesh, plan = mesh_model(True, ("fsdp", "tp"))
        placed = dict(mesh=mesh, strategies=("fsdp", "tp"), params_shardings=plan)
        for mode, kwargs in DECODE_MESH_MODES:
            runs = {}
            for run_label, aot in (("eager", False), ("warmed", True)):
                phase = f"decode_mesh_engine_{mode}_{run_label}"
                tokens, counts, engine = run_engine(phase, model, requests, aot=aot,
                                                    **kwargs, **placed)
                engine.close()
                del engine
                runs[run_label] = tokens
                for name in COUNTERS:
                    launches[name] += counts[name]
                engines[f"{mode}_{run_label}"] = ENGINE_FIELDS[phase]
            equal = runs["warmed"] == runs["eager"]
            engines[f"{mode}_warmed"]["bit_equal_to_eager"] = equal
            eager = engines[f"{mode}_eager"]
            # phase 7's runs cut to this phase's cap (printed, not held)
            eager["bf16_token_match_vs_unmeshed"] = token_match(
                runs["eager"], {u: t[:DECODE_MESH_NEW_TOKENS]
                                for u, t in unmeshed_engine[mode].items()})
            eager["token_match_vs_zero_halo_unmeshed"] = token_match(
                runs["eager"], zero_halo_engine[mode])
            eager["min_token_match"] = ENGINE_TOKEN_MATCH
            eager["unmeshed_zero_halo_tokens_per_s"] = ENGINE_FIELDS[
                f"decode_mesh_engine_{mode}_zero_halo_unmeshed"]["tokens_per_s"]
            require(equal, f"the meshed {mode} engine's warmed run gave other tokens "
                           "than its eager run")
            require(eager["token_match_vs_zero_halo_unmeshed"] >= ENGINE_TOKEN_MATCH,
                    f"the meshed bf16 {mode} engine kept "
                    f"{eager['token_match_vs_zero_halo_unmeshed']} of the unmeshed "
                    "tokens with K1 through its halo entry")
        del model
        gc.collect()
        seconds["engine"] = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    del base
    gc.collect()
    t0 = time.perf_counter()
    rows = rank_shape_rows(torch.Generator(device="cuda").manual_seed(SEED + 41))
    seconds["rank_shapes"] = time.perf_counter() - t0
    for row in rows:  # the launches at these shapes: the two f32 ranks' (rank 0's)
        kernel = row["name"].removesuffix(f"_tp{RANK_TENSOR}")
        row["launches"] = two_ranks["launches"][kernel]
        row["launches_of"] = ("the two gloo tp ranks' f32 run, rank 0: K1 and K2-fwd on "
                              "their f32 routes (wmma, fma), K3 and K3-q8 on bulk; the "
                              "times are the bf16 routes'")
        row["launches_by_path"] = {"decode_mesh_two_ranks_f32": two_ranks["launches"][kernel],
                                   "decode_mesh_world_1_whole_width": launches[kernel]}
    return {"config": "small", "prefill_vs_unmeshed": prefill_checks, "sampler": sampled,
            "engine": engines, "two_ranks": two_ranks, "launches": launches,
            "rank_shape_rows": rows, "nvidia_smi": smi,
            "seconds": time.perf_counter() - t_phase, "seconds_by_part": seconds}


def decode_mesh_summary(result: dict) -> dict:
    """The phase's result without the rows (they go into the kernels line)."""
    return {k: v for k, v in result.items() if k != "rank_shape_rows"}


def decode_mesh_alone() -> dict:
    """Phase 17 on its own, with the build and its own unmeshed engine runs:
    ``python3 -c "import chip_smoke as cs; cs.decode_mesh_alone()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("build", per_source=kernels.build())
    result = decode_mesh_phase(smi_name_power())
    emit("decode_mesh", **decode_mesh_summary(result))
    return result


def memory_fit_alone() -> dict:
    """The memory calibration of phase 16 with the points the activation
    model's factors were fitted to (MEMORY_FIT_BATCHES), measured here:
    ``python3 -c "import chip_smoke as cs; cs.memory_fit_alone()"``."""
    emit("build", per_source=kernels.build())
    root = Path(tempfile.mkdtemp(prefix="progen-smoke-memory-"))
    try:
        mem = memory_calibration(None, root, fit=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("memory_plan", nvidia_smi=smi_name_power(), **mem)
    require_memory(mem)
    return mem


def trainer_mesh_alone() -> dict:
    """Phase 16 on its own, with the build and its own unmeshed runs:
    ``python3 -c "import chip_smoke as cs; cs.trainer_mesh_alone()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("build", per_source=kernels.build())
    result = trainer_mesh_phase(smi_name_power())
    emit("trainer_mesh", **trainer_mesh_summary(result))
    return result


# -- phase 18: the multi-process fleet ----------------------------------------

FLEET_NEW_TOKENS = 64  # the fleet's cap on phase 7's requests (64-192 there)
FLEET_REQUESTS = 6  # the bf16 fleet's requests: phase 7's first (12 before phase 19)
FLEET_F32_REQUESTS = 3  # the f32 fleet's (12 before phase 19)
FLEET_RUNS = (("f32", False, None, False), ("bf16_q8_warmed", True, "weights+pages", True))
FLEET_TIMEOUT_S = 300.0


def fleet_spec(bf16: bool, quantize: str | None, aot: bool) -> dict:
    """The fleet's worker spec: ProGen-small at full width and depth, the
    port's seeded init (seed 0), paged with 8 slots, chunk 32, page 16 and
    the in-process ``engine_disagg_paged`` phase's ``prefill_batch`` (the
    default, 8) and ``handoff_depth`` (2); every worker on ``cuda:0``."""
    return make_spec(SMALL, mixed_precision=bf16, init_seed=SEED, device="cuda",
                     engine=dict(num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                                 max_len=SMALL.seq_len, paged=True,
                                 page_size=ENGINE_PAGE, quantize=quantize),
                     aot_warmup=aot)


def fleet_reference(spec: dict, requests: list[dict]) -> dict:
    """Tokens by uid of the in-process disaggregated engine that
    ``build_engine_from_spec`` makes of ``spec`` (eager)."""
    engine = build_engine_from_spec(spec)
    for r in requests:
        engine.submit(Request(**r))
    done = engine.run_until_idle(max_chunks=400)
    require(all(c.ok for c in done) and len(done) == len(requests),
            "the in-process reference did not answer every request")
    out = {c.uid: c.tokens.tolist() for c in done}
    engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def worker_exits(log_dir: Path) -> dict:
    """Each worker's exit line (``serve/worker.py``), by ``role:index``."""
    out = {}
    for log in sorted(log_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            if line.startswith('{"worker_exit"'):
                rec = json.loads(line)
                out[rec["worker_exit"]] = rec
    return out


def fleet_counts(launches: dict) -> dict:
    """A worker's exit-line launches under the smoke's counter names, with
    the paged gate mix's launches by route."""
    short = lambda module, attr: f"{module.__name__.rsplit('.', 1)[1]}.{attr}"
    out = {name: launches[short(module, attr)] for name, (module, attr) in COUNTERS.items()}
    routes = {}
    for name, (module, attr) in ROUTE_COUNTERS.items():
        prefix = short(module, attr) + "."
        routes[name] = {k[len(prefix):]: n for k, n in launches.items() if k.startswith(prefix)}
    return out, routes


def worker_launch_checks(label: str, exits: dict, workers: dict, bf16: bool,
                         quantize, depth: int = SMALL.depth) -> tuple[dict, dict]:
    """Each worker's exit-line launches held to its formula: a prefill
    worker K1-fwd ``depth`` and K2-fwd 2 times a handle it made (f32 on
    ``wmma``/``fma``, bf16 on ``wgmma``), a decode replica (or each member
    of a replica group, at its rank's width) K3 or K3-q8 twice a decode
    step, all on ``bulk``; nothing else anywhere.  ``workers``: each
    worker's last stats frame.  Returns the launches and K3's routes summed
    over the workers, and each worker's launches."""
    mix = "paged_gate_mix_q8" if quantize == "weights+pages" else "paged_gate_mix"
    fwd_route = ("wgmma", "wgmma") if bf16 else ("wmma", "fma")
    gmlp = SMALL.global_mlp_depth
    total = dict.fromkeys(COUNTERS, 0)
    by_route = dict.fromkeys(cuda_paged_gate_mix.route_launches, 0)
    each = {}
    for w, rec in sorted(exits.items()):
        got, routes = fleet_counts(rec["launches"])
        st = workers[w]
        if w.startswith("prefill"):
            frames = st["robust"]["handoff"]["puts"]
            want = {**dict.fromkeys(COUNTERS, 0), "local_attention_fwd": depth * frames,
                    "sgu_fwd": gmlp * frames}
            for name, route in zip(("local_attention_fwd", "sgu_fwd"), fwd_route):
                require(routes[name].get(route) == got[name] > 0,
                        f"{label} {w}: {name} by route {routes[name]}, want all on {route}")
        else:
            steps = st["chunks_run"] * ENGINE_CHUNK
            want = {**dict.fromkeys(COUNTERS, 0), mix: gmlp * steps}
            require(routes["paged_gate_mix"].get("bulk") == got[mix] > 0,
                    f"{label} {w}: K3 by route {routes['paged_gate_mix']}, want all on bulk")
            require(st["stage_seconds"]["prefill_s"] == 0.0,
                    f"{label} {w}: a replica ran a prefill: {st['stage_seconds']}")
        require(got == want, f"{label} {w}: launches {got}, want {want}")
        each[w] = {k: v for k, v in got.items() if v}
        for k, v in got.items():
            total[k] += v
        for r, n in routes["paged_gate_mix"].items():
            by_route[r] += n
    total["paged_gate_mix_by_route"] = by_route
    return total, each


def fleet_run(label: str, bf16: bool, quantize, aot: bool, requests: list[dict],
              root: Path, keep: bool = False) -> tuple:
    """One prefill worker and one decode replica answer ``requests``, held
    to the in-process engine of the same spec (eager), which runs on a
    thread of this process while the workers start; the workers' kernels
    are read from their exit lines.  ``keep``: the fleet lives on for
    phase 19, which reads the exit lines and holds the launches when it
    shuts the fleet down; the result then carries ``cluster``, ``log_dir``
    and the reference tokens ``want``."""
    spec = fleet_spec(bf16, quantize, aot)
    log_dir = root / label
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        reference = pool.submit(fleet_reference, fleet_spec(bf16, quantize, False), requests)
        t0 = time.perf_counter()
        try:
            cluster = ServeCluster(spec, log_dir=str(log_dir),
                                   spawn_timeout=FLEET_TIMEOUT_S)
        finally:
            want = reference.result()
    hello_s = time.perf_counter() - t0
    handle_bytes = []
    relay = cluster._on_handle

    def counted(peer, header, frame):
        handle_bytes.append(len(frame))
        return relay(peer, header, frame)

    cluster._on_handle = counted
    try:
        t_ready = time.perf_counter()
        cluster.wait_ready(FLEET_TIMEOUT_S)
        ready_s = time.perf_counter() - t_ready
        t1 = time.perf_counter()
        for r in requests:
            cluster.submit(Request(**r))
        done = cluster.drain(timeout=FLEET_TIMEOUT_S)
        serve_s = time.perf_counter() - t1
        stats = cluster.stats()
    finally:
        if not keep:
            stats = cluster.shutdown()
    cluster._on_handle = relay
    require(sorted(c.uid for c in done) == list(range(len(requests)))
            and all(c.ok for c in done),
            f"{label}: statuses {[(c.uid, c.status) for c in done]}")
    got = {c.uid: c.tokens.tolist() for c in done}
    share = token_match(got, want)
    identical = share == 1.0 and got == want
    dstats = stats["workers"]["decode:0"]
    frames = dstats["robust"]["handoff"]["puts"]
    steps = dstats["chunks_run"] * ENGINE_CHUNK
    tt = stats["transport_total"]
    require(tt["crc_failures"] == 0 and tt["desyncs"] == 0, f"{label}: transport {tt}")
    pstats = stats["workers"]["prefill:0"]
    generated = sum(len(v) for v in got.values())
    ttft = [c.ttft for c in done if c.ttft is not None]
    result = {
        "precision": "bf16 compute" if bf16 else "f32", "quantize": quantize,
        "aot_warmup": aot, "requests": len(requests),
        "token_match_vs_in_process": share, "identical": identical,
        "serve_s": serve_s, "generated_tokens": generated,
        "tokens_per_s": generated / serve_s,
        "ttft_s_median": float(np.median(ttft)) if ttft else None,
        "latency_s_median": float(np.median([c.latency for c in done])),
        "handle_frames": frames, "handle_bytes": sum(handle_bytes),
        "handle_bytes_per_request": sum(handle_bytes) / len(requests),
        "frames_total": tt["frames_out"], "bytes_total": tt["bytes_out"],
        "ser_s_per_frame": pstats["transport"]["ser_s"] / max(frames, 1),
        "de_s_per_frame": dstats["transport"]["de_s"] / max(frames, 1),
        "decode_steps": steps,
    }
    if keep:
        # spawn to hello, then the wait for both ready frames (the builds
        # and warm-ups, in parallel); the exit lines come with phase 19
        result["startup_s"] = hello_s + ready_s
        return result, None, {"cluster": cluster, "log_dir": log_dir, "want": want}
    exits = worker_exits(log_dir)
    require(set(exits) == {"prefill:0", "decode:0"},
            f"{label}: worker exit lines {sorted(exits)}; logs in {log_dir}")
    counts, each = worker_launch_checks(label, exits, stats["workers"], bf16, quantize)
    # spawn to hello (or to the reference's end, if later), then each
    # worker's own build (and warm-up), the two in parallel
    result.update({
        "startup_s": hello_s + max(exits[w]["build_s"] for w in exits),
        "worker_build_s": {w: exits[w]["build_s"] for w in exits},
        "warmup": {w: exits[w]["warmup"] for w in exits},
        "peak_bytes": {w: exits[w]["peak_bytes"] for w in exits},
        "stage_seconds": {w: stats["workers"][w]["stage_seconds"] for w in exits},
        "launches": each})
    return result, counts, None


def serve_fleet(smi: str, keep: bool = True) -> tuple[dict, dict, dict | None]:
    """The multi-process fleet at ProGen-small (full width and depth, the
    seeded init): one prefill worker and one decode replica, both processes
    on ``cuda:0``, answer phase 7's first requests cut to 64 new tokens
    (FLEET_F32_REQUESTS and FLEET_REQUESTS of them).  f32: tokens identical to the in-process disaggregated
    paged engine's built by ``build_engine_from_spec`` from the same spec;
    bf16 compute with int8 weights and 8-bit pages, every worker warmed by
    ``aot_warmup``: at least 0.98 of that engine's tokens (the router may
    batch prefills otherwise than the in-process engine, and another batch
    size may change a bf16 product's bits).  Each worker's
    kernels from its exit line: K1-fwd and K2-fwd in the prefill worker
    only (12 and 2 a program), K3 or K3-q8 in the replica only (2 a decode
    step, on ``bulk``).  With ``keep`` the bf16 fleet lives on for phase 19
    (returned third), which holds its workers' launches.  Returns the
    phase's fields, the launches of the runs held here, and the kept
    fleet."""
    requests = capped(engine_requests(SMALL), FLEET_NEW_TOKENS)
    gc.collect()
    torch.cuda.empty_cache()  # the workers' memory is their own processes'
    root = Path(tempfile.mkdtemp(prefix="progen-smoke-fleet-"))
    runs, launches, kept = {}, {}, None
    try:
        for label, bf16, quantize, aot in FLEET_RUNS:
            last = label == FLEET_RUNS[-1][0]
            n = FLEET_REQUESTS if bf16 else FLEET_F32_REQUESTS
            runs[label], counts, kept = fleet_run(label, bf16, quantize, aot, requests[:n],
                                                  root, keep=keep and last)
            for k, v in (counts or {}).items():
                launches[k] = (v if k not in launches else
                               ({r: launches[k][r] + n for r, n in v.items()}
                                if isinstance(v, dict) else launches[k] + v))
            emit("serve_fleet_run", run=label, nvidia_smi=smi, **runs[label])
    finally:
        if kept is None:
            shutil.rmtree(root, ignore_errors=True)
    require(runs["f32"]["identical"], "serve_fleet: the f32 fleet's tokens differ "
            "from the in-process engine's")
    share = runs["bf16_q8_warmed"]["token_match_vs_in_process"]
    require(share >= ENGINE_TOKEN_MATCH,
            f"serve_fleet: {share} of the in-process bf16 8-bit tokens, "
            f"want >= {ENGINE_TOKEN_MATCH}")
    result = {"config": "small", "nvidia_smi": smi, "min_token_match": ENGINE_TOKEN_MATCH,
              **{label: {k: runs[label].get(k) for k in (
                  "token_match_vs_in_process", "identical", "startup_s", "tokens_per_s",
                  "ttft_s_median", "handle_frames", "handle_bytes_per_request",
                  "ser_s_per_frame", "de_s_per_frame", "peak_bytes")}
                 for label in runs}}
    if kept is not None:
        kept.update(root=root, requests=requests)
    return result, launches, kept


ELASTIC_FIRST = 6       # phase 19's requests submitted before the swap (the rest after)
ELASTIC_SWAP_AFTER = 4  # completions before phase 19's swap
ELASTIC_UID = 100       # phase 19's uids: phase 7's plus this (beside phase 18's)


class ForcedScaleDown(BurnRatePolicy):
    """A policy that asks to scale both stages down on every tick: the
    control plane's victim picker still decides whether anything can go."""

    def decide(self, inputs):
        return [ScaleDecision("scale_down", role, "forced", 0.0, 0.0)
                for role in ("prefill", "decode")]


def serve_elastic(smi: str, kept: dict) -> tuple[dict, dict]:
    """Phase 19: the elastic control plane on phase 18's bf16 fleet (int8
    weights, 8-bit pages, warmed), handed on alive.  Phase 7's 12 requests
    cut to 64 new tokens (uids + 100): the first 6 submitted, and after
    the 4th completion ``ControlPlane.swap_weights`` rolls the fleet to
    generation 1 (the same spec with ``init_seed`` + 1: a new decode
    replica warm and routable, the prefill worker replaced, the old
    replica retired once its requests finished); the other 6 are submitted
    after it, then one ``tick`` with a forced scale-down.  No request is
    shed or dropped, every completion carries the generation that primed
    it, each generation's tokens at least 0.98 of the in-process engine's
    on its weights (generation 0: phase 18's reference; generation 1: an
    engine on the new weights, run while the new workers warm).  Every
    worker's launches from its exit line, phase 18's bf16 runs included:
    the formula of phase 18.  Returns the phase's fields and launches."""
    cluster, log_dir = kept["cluster"], kept["log_dir"]
    reqs = [{**r, "uid": ELASTIC_UID + r["uid"]} for r in kept["requests"]]
    want0 = {ELASTIC_UID + u: v for u, v in kept["want"].items()
             if u < ELASTIC_FIRST}
    spec1 = {**cluster.spec, "init_seed": SEED + 1}
    control = ControlPlane(cluster, BurnRatePolicy(
        min_prefill=1, max_prefill=2, min_replicas=1, max_replicas=2), slo_specs=())
    dispatches: dict = {}
    dispatch = cluster._dispatch

    def counted(uid, now):
        dispatches[uid] = dispatches.get(uid, 0) + 1
        return dispatch(uid, now)

    cluster._dispatch = counted
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            t0 = time.perf_counter()
            for r in reqs[:ELASTIC_FIRST]:
                cluster.submit(Request(**r))
            done = []
            while len(done) < ELASTIC_SWAP_AFTER:
                require(time.perf_counter() - t0 < FLEET_TIMEOUT_S,
                        f"serve_elastic: {len(done)} completions before the swap")
                # (phase 18's completions are still to collect: not these)
                done += [c for c in cluster.poll(0.1) if c.uid >= ELASTIC_UID]
            # the generation-1 reference runs while the new workers warm
            reference = pool.submit(fleet_reference, {**fleet_spec(True, "weights+pages", False),
                                                      "init_seed": SEED + 1},
                                    reqs[ELASTIC_FIRST:])
            t_swap = time.perf_counter()
            gen = control.swap_weights(spec1, timeout=FLEET_TIMEOUT_S)
            swap_s = time.perf_counter() - t_swap
            for r in reqs[ELASTIC_FIRST:]:
                cluster.submit(Request(**r))
            sizes = (cluster.prefill_procs, cluster.replicas)
            control.policy = ForcedScaleDown(min_prefill=1, min_replicas=1)
            tick = control.tick()
            done = [c for c in cluster.drain(timeout=FLEET_TIMEOUT_S) if c.uid >= ELASTIC_UID]
            want1 = reference.result()
            serve_s = time.perf_counter() - t0
            controlz = control.controlz()
    finally:
        cluster._dispatch = dispatch
        stats = cluster.shutdown()
        exits = worker_exits(log_dir)
        shutil.rmtree(kept["root"], ignore_errors=True)
    require(set(exits) == {"prefill:0", "decode:0", "prefill:1", "decode:1"},
            f"serve_elastic: worker exit lines {sorted(exits)}")
    require(sorted(c.uid for c in done) == [r["uid"] for r in reqs]
            and all(c.ok for c in done),
            f"serve_elastic: statuses {[(c.uid, c.status) for c in done]}")
    gens = {c.uid: c.generation for c in done}
    require(gen == 1 and all(gens[r["uid"]] == int(i >= ELASTIC_FIRST)
                             for i, r in enumerate(reqs)),
            f"serve_elastic: generations {gens}")
    got = {c.uid: c.tokens.tolist() for c in done}
    got0 = {u: got[u] for u in want0}
    got1 = {u: got[u] for u in want1}
    share0, share1 = token_match(got0, want0), token_match(got1, want1)
    require(share0 >= ENGINE_TOKEN_MATCH and share1 >= ENGINE_TOKEN_MATCH,
            f"serve_elastic: generation 0 {share0}, generation 1 {share1} of the "
            f"in-process tokens, want >= {ENGINE_TOKEN_MATCH}")
    require(tick == [] and (cluster.prefill_procs, cluster.replicas) == sizes == (1, 1),
            f"serve_elastic: the forced scale-down retired {tick} from a fleet of "
            f"{sizes}: the sole instance of a stage must stay")
    tt = stats["transport_total"]
    require(tt["crc_failures"] == 0 and tt["desyncs"] == 0, f"serve_elastic: transport {tt}")
    launches, each = worker_launch_checks("serve_elastic", exits, stats["workers"], True,
                                          "weights+pages")
    events = {e["event"]: e for e in controlz["journal"]}
    rolls = [e for e in controlz["journal"] if e["event"] == "swap_roll"]
    begin = events["swap_begin"]["at"]
    generated = sum(len(v) for v in got.values())
    result = {
        "config": "small", "nvidia_smi": smi, "precision": "bf16 compute",
        "quantize": "weights+pages", "requests": len(reqs), "generation": gen,
        "min_token_match": ENGINE_TOKEN_MATCH,
        "token_match_generation_0": share0, "identical_generation_0": got0 == want0,
        "token_match_generation_1": share1, "identical_generation_1": got1 == want1,
        "generations": {str(u): g for u, g in sorted(gens.items())},
        "sheds": sum(not c.ok for c in done),
        "replays": sum(n - 1 for n in dispatches.values()),
        "swap_s": swap_s,
        "swap_steps_s": {f"{e['role']}_routable" if e["role"] == "decode" else "prefill_rolled":
                         e["at"] - begin for e in rolls}
                        | {"old_retired": events["swap_done"]["duration_s"]},
        "forced_scale_down": {"journaled": tick, "fleet": list(sizes)},
        "controlz_journal_entries": len(controlz["journal"]),
        "controlz_events": [e["event"] for e in controlz["journal"]],
        "serve_s": serve_s, "tokens_per_s": generated / serve_s,
        "peak_bytes": {w: exits[w]["peak_bytes"] for w in exits},
        "worker_build_s": {w: exits[w]["build_s"] for w in exits},
        "launches": each,
    }
    return result, launches


GROUP_SIZE = 2          # phase 20's decode replica: a group of this many processes
GROUP_REQUESTS = 8      # phase 7's first requests, cut to GROUP_NEW_TOKENS
GROUP_NEW_TOKENS = 32
GROUP_DEPTH = 6         # phase 20's ProGen-small layers (of 12; the time needs it)


def serve_tp_group(smi: str) -> tuple[dict, dict]:
    """Phase 20: a tensor-parallel replica group.  ProGen-small at full
    width (GROUP_DEPTH layers, the seeded init), f32, eager, paged, 8
    slots, chunk 32, page 16: one prefill worker and one decode replica
    made of GROUP_SIZE processes on ``cuda:0`` meeting over gloo (NCCL
    refuses two ranks on one card), each holding its half of the heads and
    gate channels; phase 7's first 8 requests cut to 32 new tokens.  Held:
    at least 0.98 of the in-process disaggregated engine's tokens on the
    same spec (the identical share printed: the ``tp`` split changes the
    order of sums), every slab frame the replicated leaves plus half the
    split ones, no CRC failure, desync or ``bad_frame``, and the launches:
    the prefill worker's K1-fwd and K2-fwd per handle, each member's K3
    twice a decode step on ``bulk`` at its rank's width (d 1024).  Printed:
    the members' start-up, tokens/s, median time to first token, peak
    memory per process."""
    cfg = dataclasses.replace(SMALL, depth=GROUP_DEPTH)
    spec = make_spec(cfg, mixed_precision=False, init_seed=SEED, device="cuda",
                     engine=dict(num_slots=ENGINE_SLOTS, chunk_size=ENGINE_CHUNK,
                                 max_len=cfg.seq_len, paged=True, page_size=ENGINE_PAGE))
    requests = capped(engine_requests(SMALL)[:GROUP_REQUESTS], GROUP_NEW_TOKENS)
    root = Path(tempfile.mkdtemp(prefix="progen-smoke-group-"))
    slabs, bad_frames = [], []
    split = cluster_module._split_group_frame

    def header_of(frame) -> tuple[dict, int]:
        """A frame's header and payload length, from its prefix (the relay
        has checked both CRCs)."""
        hlen, plen, _, _ = parse_prefix(frame[:FRAME_PREFIX_LEN])
        return json.loads(frame[FRAME_PREFIX_LEN:FRAME_PREFIX_LEN + hlen]), plen

    def measured(frame, group_size):
        out = split(frame, group_size)
        whole = {path: nbytes for path, _, _, _, nbytes in header_of(frame)[0]["manifest"]}
        cut = header_of(out[0])[0]["slab"]["split"]
        slabs.append({"frame": len(frame),
                      "split_bytes": sum(whole[p] for p in cut),
                      "replicated_bytes": sum(n for p, n in whole.items() if p not in cut),
                      "slab_payloads": [header_of(f)[1] for f in out]})
        return out

    gc.collect()
    torch.cuda.empty_cache()
    try:
        with mock.patch.object(cluster_module, "_split_group_frame", measured), \
                concurrent.futures.ThreadPoolExecutor(1) as pool:
            reference = pool.submit(fleet_reference, spec, requests)
            t0 = time.perf_counter()
            try:
                cluster = ServeCluster(spec, tp_group=GROUP_SIZE, log_dir=str(root),
                                       spawn_timeout=FLEET_TIMEOUT_S)
            finally:
                want = reference.result()
            handle = cluster._handle_event

            def watched(ev):
                if ev[0] != "dead" and ev[2].get("type") == "bad_frame":
                    bad_frames.append(ev[2])
                return handle(ev)

            cluster._handle_event = watched
            try:
                cluster.wait_ready(FLEET_TIMEOUT_S)
                startup_s = time.perf_counter() - t0
                t1 = time.perf_counter()
                for r in requests:
                    cluster.submit(Request(**r))
                done = cluster.drain(timeout=FLEET_TIMEOUT_S)
                serve_s = time.perf_counter() - t1
            finally:
                stats = cluster.shutdown()
        exits = worker_exits(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    members = ["decode:0"] + [f"dshard{k}:0" for k in range(1, GROUP_SIZE)]
    require(set(exits) == {"prefill:0", *members},
            f"serve_tp_group: worker exit lines {sorted(exits)}")
    require(sorted(c.uid for c in done) == list(range(len(requests)))
            and all(c.ok for c in done),
            f"serve_tp_group: statuses {[(c.uid, c.status) for c in done]}")
    got = {c.uid: c.tokens.tolist() for c in done}
    share = token_match(got, want)
    require(share >= ENGINE_TOKEN_MATCH,
            f"serve_tp_group: {share} of the in-process tokens, want >= {ENGINE_TOKEN_MATCH}")
    tt = stats["transport_total"]
    require(tt["crc_failures"] == 0 and tt["desyncs"] == 0 and not bad_frames,
            f"serve_tp_group: transport {tt}, bad frames {bad_frames}")
    require(slabs and all(s["slab_payloads"] == [s["replicated_bytes"]
                                                 + s["split_bytes"] // GROUP_SIZE] * GROUP_SIZE
                          for s in slabs),
            f"serve_tp_group: slab payloads {slabs}")
    steps = {w: stats["workers"][w]["chunks_run"] for w in members}
    require(len(set(steps.values())) == 1, f"serve_tp_group: members' chunks {steps}")
    launches, each = worker_launch_checks("serve_tp_group", exits, stats["workers"], False,
                                          None, depth=cfg.depth)
    generated = sum(len(v) for v in got.values())
    ttft = [c.ttft for c in done if c.ttft is not None]
    result = {
        "config": "small", "depth": cfg.depth, "nvidia_smi": smi, "precision": "f32",
        "group_size": GROUP_SIZE, "backend": "gloo", "requests": len(requests),
        "new_tokens": GROUP_NEW_TOKENS, "min_token_match": ENGINE_TOKEN_MATCH,
        "token_match_vs_in_process": share, "identical": got == want,
        "startup_s": startup_s,
        "worker_build_s": {w: exits[w]["build_s"] for w in exits},
        "serve_s": serve_s, "generated_tokens": generated,
        "tokens_per_s": generated / serve_s,
        "ttft_s_median": float(np.median(ttft)) if ttft else None,
        "handle_frames": len(slabs), "frame_bytes": [s["frame"] for s in slabs],
        "slab_payload_bytes": [s["slab_payloads"][0] for s in slabs],
        "split_bytes": [s["split_bytes"] for s in slabs],
        "replicated_bytes": [s["replicated_bytes"] for s in slabs],
        "de_s_per_frame": {w: stats["workers"][w]["transport"]["de_s"] / max(len(slabs), 1)
                           for w in members},
        "decode_steps": {w: n * ENGINE_CHUNK for w, n in steps.items()},
        "peak_bytes": {w: exits[w]["peak_bytes"] for w in exits},
        "launches": each,
    }
    return result, launches


def serve_fleet_alone() -> dict:
    """Phase 18 on its own, with the build:
    ``python3 -c "import chip_smoke as cs; cs.serve_fleet_alone()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("build", per_source=kernels.build())
    result, _, _ = serve_fleet(smi_name_power(), keep=False)
    emit("serve_fleet", **result)
    return result


def serve_elastic_alone() -> dict:
    """Phases 18 and 19 on their own (19 continues 18's bf16 fleet), with
    the build: ``python3 -c "import chip_smoke as cs; cs.serve_elastic_alone()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("build", per_source=kernels.build())
    smi = smi_name_power()
    fleet, _, kept = serve_fleet(smi)
    emit("serve_fleet", **fleet)
    result, _ = serve_elastic(smi, kept)
    emit("serve_elastic", **result)
    return result


def serve_tp_group_alone() -> dict:
    """Phase 20 on its own, with the build:
    ``python3 -c "import chip_smoke as cs; cs.serve_tp_group_alone()"``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("build", per_source=kernels.build())
    result, _ = serve_tp_group(smi_name_power())
    emit("serve_tp_group", **result)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_name_power()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.stdout.strip().splitlines()[-1],
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = kernels.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=built)

    rows = check_kernels() + check_backward_kernels() + check_paged_kernels()

    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED).eval()
    served = serve(model)
    emit("main_path", config="small", params=sum(p.numel() for p in model.parameters()),
         **{k: v for k, v in served.items() if k != "tokens"})
    emit("prefill_vs_plain", **check_prefill_against_plain(model))
    reference = ProGen(SMALL, make_policy(False), device="cuda", seed=SEED).eval()
    emit("prefill_vs_plain", **check_prefill_against_plain(reference))
    emit("decode_vs_forward", **check_decode_against_forward(reference))
    emit("bf16_decode_vs_f32", **check_bf16_decode_against_f32(model, reference))

    requests = engine_requests(SMALL)
    engine_launches = {}
    runs = {}  # uninterrupted engine runs the lifecycle phase replays against
    dense, engine_launches["engine_dense"], _ = run_engine("engine_dense", model, requests)
    full, engine_launches["engine_paged"], engine = run_engine(
        "engine_paged", model, requests, paged=True)
    require(engine.prefix_hits > 0, "the prefix cache found nothing to share")
    q8, engine_launches["engine_paged_q8"], engine = run_engine(
        "engine_paged_q8", model, requests, paged=True, quantize="weights+pages")
    require(engine.prefix_hits > 0, "the prefix cache found nothing to share (q8)")
    engine_launches.update(engine_modes(model, requests, dense, full, q8, runs))
    tight, engine_launches["engine_tight_pool"], engine = run_engine(
        "engine_tight_pool", model, requests, paged=True, num_pages=ENGINE_TIGHT_PAGES)
    require(engine.pause_events > 0 and engine.evictions > 0,
            f"the tight pool did not pause and evict: {engine.pause_events} pauses, "
            f"{engine.evictions} evictions")
    share = token_match(tight, full)
    emit("engine_tight_vs_full", token_match=share, min_token_match=ENGINE_TOKEN_MATCH)
    require(share >= ENGINE_TOKEN_MATCH, "pauses and evictions changed the tokens")
    del engine
    emit("engine_vs_plain", **check_engine_steps_against_plain(model, None))
    emit("engine_vs_plain", **check_engine_steps_against_plain(model, "weights+pages"))
    emit("engine_vs_plain", **check_engine_steps_against_plain(reference, None))
    emit("engine_paged_vs_dense", **check_paged_engine_against_dense(reference))
    engine_launches.update(engine_workloads(model, reference, runs))
    del reference
    gc.collect()
    eager = {"engine_dense": dense, "engine_paged": full, "engine_paged_q8": q8,
             "engine_spec_paged": runs["engine_spec_paged"][0],
             "engine_disagg_paged": runs["engine_disagg_paged"][0]}
    engine_launches.update(engine_graphs(model, requests, eager, runs.pop("engine_workloads")))
    del eager
    gc.collect()
    del model
    gc.collect()
    engine_launches.update(engine_lifecycle(lifecycle_model(), requests))
    gc.collect()
    fleet, engine_launches["serve_fleet"], kept = serve_fleet(smi)
    emit("serve_fleet", **fleet)
    elastic, engine_launches["serve_elastic"] = serve_elastic(smi, kept)
    emit("serve_elastic", **elastic)
    del kept
    group, engine_launches["serve_tp_group"] = serve_tp_group(smi)
    emit("serve_tp_group", **group)
    gc.collect()

    model = ProGen(SMALL, make_policy(True), device="cuda", seed=SEED)
    trained = train(model)
    emit("train", config="small", dtype="bf16 compute, f32 params", **trained)
    del model
    emit("train_vs_plain", **check_train_against_plain())
    gc.collect()
    lora = lora_train(trained["step_ms_median"])
    gc.collect()
    emit("lora_train_vs_plain", **check_train_against_plain(lora=True))
    gc.collect()
    trainer_small = dataclasses.replace(SMALL, depth=TRAINER_DEPTH)
    trainer = trainer_phase(trainer_small)
    require_trainer_launches(trainer, trainer_small)
    emit("trainer", config="small", dtype="bf16 compute, f32 params", nvidia_smi=smi,
         **{k: v for k, v in trainer.items() if k != "per_step_launches"},
         launches_per_step=trainer["per_step_launches"][0],
         steps_with_these_launches=len(trainer["per_step_launches"]))
    gc.collect()
    superstep = trainer_superstep()
    gc.collect()
    halo_kernel_rows, parallel = parallel_phase(smi)
    emit("parallel", config="small", **parallel_summary(parallel))
    gc.collect()
    mesh = trainer_mesh_phase(smi, unmeshed={False: parallel["unmeshed"],
                                             True: parallel["unmeshed_bf16"]},
                              remat=superstep["remat"])
    emit("trainer_mesh", **trainer_mesh_summary(mesh))
    gc.collect()
    decode = decode_mesh_phase(smi, unmeshed_engine={"dense": dense, "paged": full,
                                                     "paged_q8": q8})
    emit("decode_mesh", **decode_mesh_summary(decode))

    for row in rows:
        by_path = {"serve": served["launches"][row["name"]],
                   "train": trained["launches"][row["name"]],
                   "trainer": trainer["launches"][row["name"]],
                   "trainer_superstep": superstep["launches"][row["name"]],
                   "lora_train": lora["launches"][row["name"]],
                   "parallel": parallel["launches"][row["name"]],
                   "trainer_mesh": mesh["launches"][row["name"]],
                   "decode_mesh": decode["launches"][row["name"]],
                   **{phase: counts[row["name"]]
                      for phase, counts in engine_launches.items()}}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["name"].startswith("paged_gate_mix"):  # the engine's, by route
            row["launches_by_route"] = {
                route: sum(counts["paged_gate_mix_by_route"][route]
                           for counts in engine_launches.values() if counts[row["name"]])
                for route in cuda_paged_gate_mix.route_launches}
    for row in halo_kernel_rows:
        counter = row["name"].removesuffix(HALO_ROW_SUFFIX[torch.float32])
        bf16 = counter == row["name"]
        row["launches_by_path"]["trainer_mesh"] = (
            mesh["launches_by_precision"]["bf16" if bf16 else "f32"][counter])
        if bf16:  # the meshed decode's prefills: K1 through its halo entry, bf16
            row["launches_by_path"]["decode_mesh"] = decode["launches"][counter]
        row["launches"] = sum(row["launches_by_path"].values())
    rows += halo_kernel_rows + decode["rank_shape_rows"]
    print(json.dumps({"kernels": rows}), flush=True)
    emit("trainer_summary", nvidia_smi=smi, **{k: trainer[k] for k in (
        "step_ms_median", "tokens_per_s", "mfu", "host_batch_ms", "data_wait_ms_median",
        "feed", "resume_open", "checkpoint_bytes", "restore_state_s", "restore_params_s",
        "peak_bytes", "resumed_losses_equal", "resumed_params_equal",
        "restored_logits_equal")},
         parallel={label: {k: parallel[label][k] for k in (
             "step_ms_median", "tokens_per_s", "peak_above_start_bytes", "loss_rel_err")}
             for label, _, _ in MESHED_RUNS},
         **{label: {k: parallel[label][k] for k in ("step_ms_median", "tokens_per_s",
                                                    "peak_above_start_bytes")}
            for label in ("unmeshed", "unmeshed_bf16")})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
