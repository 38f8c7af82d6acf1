"""Tensor-parallel decode replica groups (``ServeCluster(tp_group=G)``): a
decode replica as ``G`` worker processes meeting in a private
``torch.distributed`` group (gloo on the CPU), each handle relayed as ``G``
slab frames.  The JAX package gates its groups through
``benchmarks/bench_mesh.py --smoke`` only; this module is the port's gate:

* the slab rule (``slab_axis``) and the slab frames
  (``split_handle_frame``) equal the JAX package's, byte for byte, on JAX
  frames of six engine modes (dense, paged, 8-bit pages, speculative,
  infill, LoRA);
* each rank's state rebuilt from its slab (``deserialize_handle_sharded``,
  two gloo ranks of ``tests/_torch_parallel_worker.py``, a ``slabs`` job)
  equals its part of JAX's ``deserialize_handle`` arrays: a k/v ring's
  heads, a gate row's channels, every other leaf whole; a slab corrupt on
  one rank makes every rank drop it;
* REAL fleets of port workers on the CPU (JAX's ``init_seed=7`` weights)
  with one prefill worker and a group of two decode members give the JAX
  single-process engine's tokens, dense and paged; a killed follower reaps
  its group, which respawns on a fresh port and replays the same tokens; a
  corrupt slab makes the group's vote drop the batch, which replays; and
  ``add_worker("decode")`` spawns a whole group, routable after its
  barrier."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.decode import handoff as jax_handoff
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.parallel import unbox
from progen_tpu.workloads import lora as jax_lora
from progen_tpu_torch.decode.handoff import (
    rank_axis,
    slab_axis,
    split_handle_frame,
    unpack_frame,
)
from progen_tpu_torch.resilience.supervise import StageSupervisor
from progen_tpu_torch.serve import cluster as cluster_mod
from progen_tpu_torch.serve.cluster import ServeCluster
from tests.test_torch_handoff_wire import MODES, _mode_requests
from tests.test_torch_serve_multiproc import (  # noqa: F401  (the fixture)
    ENGINE_KW,
    JAX_CFG,
    _requests,
    _run_reference,
    _spec,
    checkpoint,
)

pytestmark = pytest.mark.multiproc

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GROUP = 2


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX engine's prefill frames in each mode (f32, its init of seed
    7): ``{mode: [frame, ...]}``."""
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    params = unbox(jax.jit(model.init)(jax.random.key(7),
                                       jnp.zeros((1, JAX_CFG.seq_len), jnp.int32)))
    bank = jax_lora.random_lora_bank(JAX_CFG, num_tenants=3, rank=2, seed=3, scale=0.5)
    out = {}
    for mode, kw in MODES.items():
        kw = {**ENGINE_KW, **kw, **({"lora_bank": bank} if mode == "lora" else {})}
        eng = JaxServingEngine(JAX_CFG, params, policy=jax_policy(False),
                               disagg=True, **kw)
        for r in _mode_requests(mode):
            eng.submit(JaxRequest(**r))
        out[mode] = []
        while eng.pending:
            out[mode].append(jax_handoff.serialize_handle(eng.run_prefill_round()))
    return out


# ------------------------------------------------------------ slab frames


@pytest.mark.parametrize("mode", sorted(MODES))
def test_slab_axis_agrees_with_jax_on_every_leaf(jax_frames, mode):
    for frame in jax_frames[mode]:
        header, _ = jax_handoff.unpack_frame(frame)
        for path, _, shape, _, _ in header["manifest"]:
            for g in (2, 3, 4):
                assert slab_axis(path, shape, g) == jax_handoff.slab_axis(path, shape, g)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_slab_frames_are_jax_bytes(jax_frames, mode):
    """The port's split of a JAX frame is JAX's split byte for byte, each
    slab frame with its own CRC, readable by both packages."""
    for frame in jax_frames[mode]:
        header, payload = jax_handoff.unpack_frame(frame)
        mine = split_handle_frame(header, payload, GROUP)
        theirs = jax_handoff.split_handle_frame(header, payload, GROUP)
        assert mine == theirs
        for shard, slab in enumerate(mine):
            h, _ = unpack_frame(slab)
            assert h["slab"]["shard"] == shard and h["slab"]["group_size"] == GROUP
            assert h["reqs"] == header["reqs"] and h["p_pad"] == header["p_pad"]


def _jax_arrays(frame, header, payload) -> dict:
    """JAX's ``deserialize_handle`` arrays of ``frame`` by leaf path; for an
    infill frame, which JAX's reader refuses (it passes a request's mask no
    vocabulary), the leaves as that reader views them before it does."""
    if not any(d.get("logit_mask") for d in header["reqs"]):
        h = jax_handoff.deserialize_handle(frame)
        return {p: np.asarray(a) for p, a in jax_handoff._flatten_state(h.state)}
    view = memoryview(payload).cast("B")
    return {path: np.frombuffer(view[off:off + nbytes],
                                dtype=jax_handoff._np_dtype(dtype)).reshape(shape)
            for path, dtype, shape, off, nbytes in header["manifest"]}


@pytest.fixture(scope="module")
def slab_world(jax_frames, tmp_path_factory):
    """Two gloo ranks read their slabs of every JAX frame (a ``slabs``
    job); the results, and JAX's ``deserialize_handle`` arrays."""
    tmp = tmp_path_factory.mktemp("slab_world")
    job, want = {}, {}
    for mode, frames in jax_frames.items():
        for i, frame in enumerate(frames):
            header, payload = jax_handoff.unpack_frame(frame)
            for shard, slab in enumerate(split_handle_frame(header, payload, GROUP)):
                job[f"slab/{mode}/{i}/{shard}"] = np.frombuffer(slab, np.uint8)
            want[f"{mode}/{i}"] = _jax_arrays(frame, header, payload)
    np.savez(tmp / "job.npz", **job)
    run = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
         str(tmp / "job.npz"), str(tmp / "out.npz"), str(GROUP), str(tmp / "store"),
         "slabs"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
    return dict(np.load(tmp / "out.npz")), want


@pytest.mark.parametrize("mode", sorted(MODES))
def test_each_rank_rebuilds_its_part_of_jax_arrays(slab_world, mode):
    """Rank ``r``'s leaves are JAX's ``deserialize_handle`` arrays cut as its
    engine holds them: its heads of each k/v ring, its channels of each gate
    row, the rest whole; the port's dtypes hold the same values."""
    got, want = slab_world
    frames = sorted(k for k in want if k.startswith(f"{mode}/"))
    assert frames
    for name in frames:
        for rank in range(GROUP):
            for path, whole in want[name].items():
                mine = got[f"{name}/{rank}/{path}"]
                ax = rank_axis(path)
                if ax is not None:
                    ax %= whole.ndim
                    width = whole.shape[ax] // GROUP
                    whole = np.take(whole, range(rank * width, (rank + 1) * width), ax)
                assert mine.shape == whole.shape, (name, path)
                if whole.dtype.kind in "iub":
                    np.testing.assert_array_equal(mine.astype(np.int64),
                                                  whole.astype(np.int64), err_msg=path)
                else:
                    np.testing.assert_array_equal(mine, whole.astype(np.float32),
                                                  err_msg=path)


def test_a_slab_corrupt_on_one_rank_is_dropped_by_every_rank(slab_world):
    got, _ = slab_world
    assert [bool(got[f"corrupt/{r}"]) for r in range(GROUP)] == [True] * GROUP


# ------------------------------------------------------------ real groups


def _drain(cluster, reqs) -> dict:
    for r in reqs:
        cluster.submit(r)
    done = cluster.drain(timeout=300.0)
    assert all(c.ok for c in done), [(c.uid, c.status) for c in done]
    return {c.uid: [int(t) for t in c.tokens] for c in done}


@pytest.mark.parametrize("variant", ["dense", "paged"])
def test_group_fleet_gives_jax_tokens(checkpoint, variant, tmp_path):
    """One prefill worker and a decode replica of two members on gloo: the
    JAX single-process engine's tokens, greedy and sampled; only the leader
    reports completions, and both members decode every step."""
    reference = _run_reference(variant)
    cluster = ServeCluster(_spec(checkpoint, variant), tp_group=GROUP,
                           log_dir=str(tmp_path))
    try:
        assert {("decode", 0), ("dshard1", 0)} <= set(cluster._peers)
        assert cluster.router.replica_alive == {0}
        got = _drain(cluster, _requests(4))
    finally:
        stats = cluster.shutdown()
    assert got == reference
    assert stats["topology"]["tp_group"] == GROUP
    for member in ("decode:0", "dshard1:0"):
        st = stats["workers"][member]
        assert st["group_size"] == GROUP and st["stage_seconds"]["decode_chunk_s"] > 0
        assert st["stage_seconds"]["prefill_s"] == 0.0
    assert stats["workers"]["decode:0"]["group_rank"] == 0
    assert stats["workers"]["dshard1:0"]["group_rank"] == 1
    tt = stats["transport_total"]
    assert tt["crc_failures"] == 0 and tt["desyncs"] == 0


def test_a_killed_follower_respawns_its_group_and_replays(checkpoint, tmp_path):
    """SIGKILL the follower mid-run: the driver reaps the leader too, fails
    the ONE replica over, respawns both members under one supervision entry
    on a fresh port, and every request completes with the JAX tokens."""
    reference = _run_reference(n=6)
    cluster = ServeCluster(_spec(checkpoint), tp_group=GROUP,
                           supervisor=StageSupervisor(max_restarts=2),
                           log_dir=str(tmp_path))
    try:
        first = cluster._procs[("decode", 0)]
        for r in _requests(6):
            cluster.submit(r)
        while not any(cluster.router.outstanding.values()):
            cluster.poll(0.05)
        cluster.kill_worker("dshard1", 0)
        done = cluster.drain(timeout=300.0)
        respawned = cluster._procs[("decode", 0)] is not first
    finally:
        stats = cluster.shutdown()
    assert len(done) == 6 and all(c.ok for c in done)
    assert {c.uid: [int(t) for t in c.tokens] for c in done} == reference
    assert respawned  # the leader died with its follower and came back
    assert stats["supervision"]["restarts"] == {"decode:0": 1}
    assert cluster._incarnations[("decode", 0)] == 2
    assert cluster._incarnations[("dshard1", 0)] == 2


def test_a_corrupt_slab_is_dropped_by_the_group_and_replays(checkpoint, tmp_path,
                                                            monkeypatch):
    """The first handle's slab for member 1 arrives corrupt: member 1's CRC
    fails, the group's vote drops the batch on both members, the leader
    reports ``bad_frame``, and the requests replay to the JAX tokens."""
    split = cluster_mod._split_group_frame
    hits = []

    def corrupt_once(frame, group_size):
        slabs = split(frame, group_size)
        if not hits:
            hits.append(True)
            bad = bytearray(slabs[1])
            bad[-1] ^= 0xFF
            slabs[1] = bytes(bad)
        return slabs

    monkeypatch.setattr(cluster_mod, "_split_group_frame", corrupt_once)
    reference = _run_reference()
    cluster = ServeCluster(_spec(checkpoint), tp_group=GROUP, log_dir=str(tmp_path))
    try:
        got = _drain(cluster, _requests(4))
    finally:
        stats = cluster.shutdown()
    assert hits and got == reference
    assert stats["workers"]["dshard1:0"]["transport"]["crc_failures"] == 1
    assert stats["workers"]["decode:0"]["transport"]["crc_failures"] == 0


def test_add_worker_spawns_a_whole_group(checkpoint, tmp_path):
    """``add_worker("decode")`` on a grouped fleet spawns G members at a
    fresh index, routable once the leader is ready (after the group's
    barrier); retiring the original group leaves the new one serving the
    JAX tokens."""
    reference = _run_reference()
    cluster = ServeCluster(_spec(checkpoint), tp_group=GROUP, log_dir=str(tmp_path))
    try:
        idx = cluster.add_worker("decode")
        assert idx == 1
        assert {("decode", 1), ("dshard1", 1)} <= set(cluster._procs)
        assert cluster._worker_gen[("dshard1", 1)] == 0
        cluster.wait_routable("decode", 1, timeout=300.0)
        assert cluster.replicas == 2
        cluster.retire_worker("decode", 0)
        assert cluster.replicas == 1 and cluster.router.replica_alive == {1}
        got = _drain(cluster, _requests(4))
    finally:
        stats = cluster.shutdown()
    assert got == reference
    # warm before routable: each new member captured its grid before ready
    for member in ("decode_1", "dshard1_1"):
        exit_line = [json.loads(line) for line in
                     (tmp_path / f"{member}.log").read_text().splitlines()
                     if line.startswith('{"worker_exit"')][-1]
        assert exit_line["warmup"]["programs"] > 0 and exit_line["group_size"] == GROUP
    assert stats["topology"]["replicas"] == 1
