"""The port's memory planner (``progen_tpu_torch/train/memory.py``) against
the JAX package's (``progen_tpu/train/memory.py``) and against the port's own
tensors, on the CPU:

* ``count_params`` for the six configs equals JAX's and the port model's own
  parameter count (the model built on ``torch.device("meta")`` without its
  init: XL has 8.56 B parameters);
* ``check_fits`` passes and fails with its suggestions against an 80 GB
  card, warns without blocking on a kind it was not calibrated on, and
  ``fsdp`` and ``tp`` shrink the plan (``tests/test_memory.py``'s cases
  with no TPU generation in them); the staged superbatches are JAX's bytes
  (``tests/test_superstep.py:233``);
* the serving plan and ``equal_budget_pages`` equal JAX's field for field
  over dense, paged, 8-bit pages, speculative, disaggregated and a LoRA
  bank (the JAX users are ``tests/test_paged.py`` and
  ``tests/test_quant.py``), and each field equals the bytes of the port
  engine's own state built on the CPU in those modes;
* the activation model against the tensors a tiny model's forward leaves
  for the backward, under each remat policy, in f32 and in bf16 compute,
  meshed and not: the bytes of every storage made during the forward that
  is still alive after it (parameters and the logits excluded), with the
  kernels' plain versions run as opaque calls as the kernels are on the
  card.  Tolerance: none, the bytes are equal.  For no remat also the
  storages that ``torch.autograd.graph.saved_tensors_hooks`` sees (a remat
  policy's checkpoint keeps its tensors from an outer hook);
* the Trainer's gate: it raises with the breakdown, before the model is
  built, under a budget patched small; ``PROGEN_SKIP_MEMORY_CHECK=1`` skips
  it; there is no gate on the CPU.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

from progen_tpu.models.configs import CONFIGS as JAX_CONFIGS
from progen_tpu.train import memory as jax_memory
from progen_tpu_torch.core.mesh import MeshConfig, initialize_distributed, make_mesh
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.data.tfrecord import shard_filename, write_tfrecord
from progen_tpu_torch.decode.engine import ServingEngine
from progen_tpu_torch.models.configs import CONFIGS, draft_config_for
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.ops import cuda_attention, cuda_sgu
from progen_tpu_torch.train import memory
from progen_tpu_torch.train import trainer as trainer_mod
from progen_tpu_torch.train.step import make_train_functions
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.workloads.lora import adapter_bank_bytes, random_lora_bank

torch.set_num_threads(1)

H100 = 80 * 10**9
KIND = "NVIDIA H100 80GB HBM3"


# -- count_params ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_count_params_matches_jax_and_the_port_model(name, monkeypatch):
    cfg = CONFIGS[name]
    monkeypatch.setattr(ProGen, "init_weights", lambda self, seed: None)
    model = ProGen(cfg, make_policy(False), device="meta")
    assert memory.count_params(cfg) == jax_memory.count_params(JAX_CONFIGS[name])
    assert memory.count_params(cfg) == sum(p.numel() for p in model.parameters())


# -- check_fits ----------------------------------------------------------------


def test_check_fits_passes_and_fails_correctly():
    ok = memory.plan(CONFIGS["small"], batch_size=8)
    assert memory.check_fits(ok, H100) is None

    oom = memory.plan(CONFIGS["base"], batch_size=64, remat=True, remat_policy="dots")
    msg = memory.check_fits(oom, H100)
    assert msg is not None and "remat_policy attn" in msg and "--batch_size" in msg
    assert "activations kept for the backward" in msg and "PROGEN_SKIP_MEMORY_CHECK" in msg

    none = memory.plan(CONFIGS["small"], batch_size=96)
    assert "--remat" in memory.check_fits(none, H100)

    # the state alone over budget -> suggests fsdp sharding
    huge = memory.plan(CONFIGS["xl"], batch_size=1, remat=True)
    msg = memory.check_fits(huge, H100)
    assert msg is not None and "fsdp=" in msg

    # a snapshot that tips it over -> suggests no background checkpoint
    base = memory.plan(CONFIGS["small"], batch_size=56)
    snap = memory.plan(CONFIGS["small"], batch_size=56, checkpoint_snapshot=True)
    if base.total_bytes <= H100 * 0.98 < snap.total_bytes:
        assert "--no_background_checkpoint" in memory.check_fits(snap, H100)

    assert memory.check_fits(oom, None) is None  # unknown memory -> no gate


def test_check_fits_uncalibrated_kind_warns_not_blocks():
    oom = memory.plan(CONFIGS["base"], batch_size=64, remat=True, remat_policy="dots")
    with pytest.warns(RuntimeWarning, match="calibrated only on"):
        assert memory.check_fits(oom, H100, device_kind="NVIDIA A100-SXM4-80GB") is None
    msg = memory.check_fits(oom, H100, device_kind=KIND)
    assert msg is not None and KIND in msg
    ok = memory.plan(CONFIGS["small"], batch_size=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert memory.check_fits(ok, H100, device_kind="NVIDIA A100-SXM4-80GB") is None


def test_fsdp_and_tp_shrink_the_plan():
    cfg = CONFIGS["xl"]
    single = memory.plan(cfg, batch_size=8, remat=True, remat_policy="dots")
    sharded = memory.plan(cfg, batch_size=8, mesh_shape={"data": 1, "fsdp": 16, "tensor": 8},
                          strategies=("fsdp", "tp"), remat=True, remat_policy="dots")
    assert sharded.state_bytes * 100 <= single.state_bytes  # 128x spread
    assert sharded.total_bytes < single.total_bytes / 8
    assert sharded.detail["axis_shards"]["weights"] == {"fsdp": 16, "tensor": 8}


def test_the_plan_has_one_implementation():
    with pytest.raises(ValueError, match="attn_impl='xla'"):
        memory.plan(CONFIGS["small"], batch_size=8, attn_impl="xla")
    with pytest.raises(ValueError, match="sgu_impl='pallas'"):
        memory.plan(CONFIGS["small"], batch_size=8, sgu_impl="pallas")


def test_memory_plan_accounts_staged_superbatches():
    cfg = CONFIGS["default"]
    base = memory.plan(cfg, batch_size=8, grad_accum_every=2)
    fused = memory.plan(cfg, batch_size=8, grad_accum_every=2, superstep_k=8)
    assert base.superbatch_bytes == 0
    # 2 buffers x K x accum x B x (L+1) x 4 bytes, unsharded mesh
    assert fused.superbatch_bytes == 2 * 8 * 2 * 8 * (cfg.seq_len + 1) * 4
    assert fused.total_bytes == base.total_bytes + fused.superbatch_bytes
    assert "staged superbatches" in fused.report()
    assert fused.detail["superstep_k"] == 8
    sharded = memory.plan(cfg, batch_size=8, grad_accum_every=2, superstep_k=8,
                          mesh_shape={"data": 2, "fsdp": 2}, strategies=("dp",))
    assert sharded.superbatch_bytes == fused.superbatch_bytes // 4
    want = jax_memory.plan(JAX_CONFIGS["default"], batch_size=8, grad_accum_every=2,
                           superstep_k=8)
    assert fused.superbatch_bytes == want.superbatch_bytes


@pytest.mark.parametrize("name", ["default", "small", "xl"])
@pytest.mark.parametrize("kw", [dict(), dict(grad_accum_every=4, checkpoint_snapshot=True),
                                dict(mesh_shape={"data": 2, "fsdp": 4, "tensor": 2},
                                     strategies=("fsdp", "tp"))])
def test_the_count_terms_are_jaxs(name, kw):
    """Params, moments, accumulator and snapshot: JAX's bytes."""
    got = memory.plan(CONFIGS[name], batch_size=8, **kw)
    want = jax_memory.plan(JAX_CONFIGS[name], batch_size=8, **kw)
    for field in ("params_bytes", "moments_bytes", "accumulator_bytes", "snapshot_bytes",
                  "num_params", "state_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.logits_bytes == want.logits_bytes
    assert got.detail["tokens_per_chip"] == want.detail["tokens_per_chip"]


# -- the serving plan --------------------------------------------------------

SERVE = ProGenConfig(num_tokens=256, dim=32, seq_len=64, depth=3, window_size=16,
                     global_mlp_depth=2, heads=2, dim_head=16, ff_mult=2)
JAX_SERVE = type(JAX_CONFIGS["default"])(**dataclasses.asdict(SERVE))
DRAFT = draft_config_for(SERVE)
MODES = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=8),
    "paged_q8": dict(paged=True, page_size=8, quantize="weights+pages"),
    "spec": dict(spec=True, draft_config=DRAFT),
    "disagg": dict(paged=True, page_size=8, disagg=True, handoff_depth=2),
    "lora": dict(paged=True, page_size=8, lora=(4, 8)),
}


def _plan_kw(mode: dict, engine=None) -> dict:
    kw = dict(num_slots=3, max_len=48, mixed_precision=False,
              paged=mode.get("paged", False), page_size=mode.get("page_size", 16),
              disagg=mode.get("disagg", False), handoff_depth=mode.get("handoff_depth", 2))
    if engine is not None and kw["paged"]:
        kw["num_pages"] = engine._pool.num_pages
    if mode.get("quantize"):
        kw["gate_dtype"] = "int8"
    if "lora" in mode:
        kw["lora_tenants"], kw["lora_rank"] = mode["lora"]
    return kw


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_plan_is_jaxs_field_for_field(mode):
    kw = _plan_kw(MODES[mode])
    draft = MODES[mode].get("draft_config")
    got = memory.serving_plan(SERVE, draft_cfg=draft, **kw)
    jax_draft = None if draft is None else type(JAX_SERVE)(**dataclasses.asdict(draft))
    want = jax_memory.serving_plan(JAX_SERVE, draft_cfg=jax_draft, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_bytes == want.total_bytes
    assert got.pageable_bytes == want.pageable_bytes


@pytest.mark.parametrize("gate_dtype", ["bf16", "int8"])
def test_equal_budget_pages_is_jaxs(gate_dtype):
    for name in ("default", "small"):
        kw = dict(dense_slots=4, max_len=CONFIGS[name].seq_len, page_size=8,
                  gate_dtype=gate_dtype)
        assert (memory.equal_budget_pages(CONFIGS[name], **kw)
                == jax_memory.equal_budget_pages(JAX_CONFIGS[name], **kw))
    assert memory.weight_hbm_bytes(CONFIGS["small"], quantize=True) == \
        jax_memory.weight_hbm_bytes(JAX_CONFIGS["small"], quantize=True)
    dense = memory.serving_plan(SERVE, num_slots=2, max_len=16)
    pages = memory.equal_budget_pages(SERVE, dense_slots=2, max_len=16, page_size=4)
    paged = memory.serving_plan(SERVE, num_slots=8, max_len=16, paged=True, page_size=4,
                                num_pages=pages)
    assert paged.pool_bytes == dense.pageable_bytes  # tests/test_paged.py:348
    with pytest.raises(ValueError):
        memory.serving_plan(SERVE, num_slots=4, gate_dtype="int8")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_plan_is_the_engines_state(mode):
    """Each field of the plan against the port engine's own state built on
    the CPU (f32): rings, carries, gate slabs or the pool (with its int8
    scales), the host page table, the logit mask, the draft's caches, the
    bank.  The token ids are int32, as JAX holds them, at the plan's 4 bytes
    a position.  The handoff queue is empty at build: its
    field is the plan's worst case, JAX's formula."""
    spec = dict(MODES[mode])
    lora = spec.pop("lora", None)
    model = ProGen(SERVE, make_policy(False), device="cpu", seed=0).eval()
    if lora is not None:
        spec["lora_bank"] = random_lora_bank(SERVE, *lora, device="cpu")
    engine = ServingEngine(model, num_slots=3, chunk_size=4, max_len=48, **spec)
    plan = memory.serving_plan(SERVE, draft_cfg=spec.get("draft_config"),
                               **_plan_kw(MODES[mode], engine))
    st, caches, slots = engine.state, engine.state["caches"], 3
    assert _nbytes(*caches["k"], *caches["v"]) == slots * plan.ring_bytes_per_slot
    assert _nbytes(*caches["attn_prev"], *caches["ff_prev"]) == \
        slots * plan.carry_bytes_per_slot
    assert _nbytes(*caches.get("sgu_gate", {}).values()) == slots * plan.gate_bytes_per_slot
    pool = [*caches.get("sgu_pool", {}).values(), *caches.get("sgu_pool_scale", {}).values()]
    assert _nbytes(*pool) == plan.pool_bytes
    assert st["lmask"].numel() * st["lmask"].element_size() == \
        slots * plan.lmask_bytes_per_slot
    assert st["seq"].numel() * st["seq"].element_size() == slots * plan.seq_bytes_per_slot
    assert st["seq"].dtype == torch.int32
    if plan.table_bytes:
        assert engine._page_table.nbytes == plan.table_bytes
    draft = st.get("draft_caches")
    assert _nbytes(*([] if draft is None else tree_flatten(draft)[0])) == \
        slots * plan.draft_bytes_per_slot
    bank = tree_flatten(engine._bank or {})[0]
    assert _nbytes(*bank) == plan.adapter_bytes
    if lora is not None:
        assert plan.adapter_bytes == adapter_bank_bytes(SERVE, *lora)
    if spec.get("disagg"):
        per_row = (plan.ring_bytes_per_slot + plan.carry_bytes_per_slot
                   + plan.seq_bytes_per_slot + plan.lmask_bytes_per_slot
                   + 48 * memory.gate_row_bytes(SERVE, False) + 40)
        assert plan.handoff_bytes == 2 * slots * per_row
    engine.close()


# -- the activation model ----------------------------------------------------

TINY = ProGenConfig(num_tokens=256, dim=64, seq_len=64, depth=2, window_size=16,
                    global_mlp_depth=1, heads=2, dim_head=16)
BATCH = 2


class _Made(TorchDispatchMode):
    """Every storage an op makes (a view of an input's is not made), with a
    weak reference to it."""

    def __init__(self):
        super().__init__()
        self.made = []

    def note(self, out, inputs=()):
        seen = {t.untyped_storage().data_ptr() for t in tree_flatten(inputs)[0]
                if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen:
                st = t.untyped_storage()
                self.made.append((st.data_ptr(), StorageWeakRef(st), st.nbytes()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.note(out, (args, kwargs))
        return out


def _live_after_forward(model, tokens, monkeypatch) -> int:
    """Bytes of the storages made by ``model(tokens)`` still alive after it,
    its parameters and the logits excepted.  The kernels' plain versions run
    outside the mode (opaque, as the kernels' launches are on the card: a
    selective checkpoint sees no op inside them), their outputs noted."""
    mode = _Made()

    def opaque(fn):
        def run(*args, **kwargs):
            with _disable_current_modes():
                out = fn(*args, **kwargs)
            mode.note(out, (args, kwargs))
            return out
        return run

    monkeypatch.setattr(cuda_attention, "plain_fwd", opaque(cuda_attention.plain_fwd))
    monkeypatch.setattr(cuda_sgu.plain, "gated_mix", opaque(cuda_sgu.plain.gated_mix))
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    from progen_tpu_torch.parallel.sharding import local
    params |= {local(p).untyped_storage().data_ptr() for p in model.parameters()}
    with mode:
        logits = model(tokens)
    monkeypatch.undo()
    out = logits.untyped_storage().data_ptr()
    alive = {ptr: n for ptr, ref, n in mode.made
             if not ref.expired() and ptr not in params and ptr != out}
    return sum(alive.values())


@pytest.mark.parametrize("policy", ["none", "full", "dots", "attn"])
@pytest.mark.parametrize("mixed", [True, False], ids=["bf16", "f32"])
def test_the_activation_model_is_the_forwards_live_tensors(policy, mixed, monkeypatch):
    model = ProGen(TINY, make_policy(mixed), device="cpu", seed=0,
                   remat=policy != "none", remat_policy=policy if policy != "none" else "full")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, TINY.seq_len)))
    got = _live_after_forward(model, tokens, monkeypatch)
    want = memory.forward_saved_bytes(TINY, tokens=BATCH * TINY.seq_len, policy=policy,
                                      mixed_precision=mixed)
    assert got == want


def test_the_activation_model_counts_the_meshed_halo(monkeypatch):
    """On a world-of-one mesh K1 also keeps its (zero) halo."""
    initialize_distributed("cpu")
    try:
        model = ProGen(TINY, make_policy(True), device="cpu", seed=0)
        make_train_functions(model, make_optimizer(), mesh=make_mesh(MeshConfig(), "cpu"),
                             strategies=("dp",))
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (BATCH, TINY.seq_len)))
        got = _live_after_forward(model, tokens, monkeypatch)
    finally:
        dist.destroy_process_group()
    assert got == memory.forward_saved_bytes(TINY, tokens=BATCH * TINY.seq_len,
                                             meshed=True)
    assert got > memory.forward_saved_bytes(TINY, tokens=BATCH * TINY.seq_len)


def test_saved_tensor_hooks_see_the_no_remat_set():
    """Without remat every live tensor is one autograd saved: the storages
    the hooks see are the model's bytes within 1% (the f32 lse of K1's plain
    version is a view the hooks see apart)."""
    model = ProGen(TINY, make_policy(True), device="cpu", seed=0)
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params:
            seen[st.data_ptr()] = st.nbytes()
        return t

    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (BATCH, TINY.seq_len)))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits = model(tokens)
    seen.pop(tokens.untyped_storage().data_ptr(), None)
    want = memory.forward_saved_bytes(TINY, tokens=BATCH * TINY.seq_len)
    assert logits.untyped_storage().data_ptr() not in seen
    assert sum(seen.values()) == pytest.approx(want, rel=1e-2)


def test_the_plan_scales_the_saved_set_by_its_efficiency():
    cfg = CONFIGS["small"]
    for policy in ("none", "full", "dots", "attn"):
        p = memory.plan(cfg, batch_size=8, remat=policy != "none",
                        remat_policy=policy if policy != "none" else "full")
        assert p.detail["remat"] == policy
        assert p.total_bytes == (p.state_bytes + p.grad_bytes + p.activation_bytes
                                 + p.cast_bytes + p.logits_bytes)
    big = memory.plan(cfg, batch_size=40)
    small = memory.plan(cfg, batch_size=8)
    assert big.activation_bytes == pytest.approx(5 * small.activation_bytes, rel=1e-3)


# -- the Trainer's gate --------------------------------------------------------

GATE_CFG = ProGenConfig(num_tokens=256, dim=16, seq_len=16, depth=2, window_size=8,
                        global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("memdata")
    rng = np.random.default_rng(0)
    mk = lambda: bytes(rng.integers(65, 90, rng.integers(4, 20), dtype=np.uint8))
    write_tfrecord(d / shard_filename(0, 8, "train"), [mk() for _ in range(8)])
    write_tfrecord(d / shard_filename(0, 2, "valid"), [mk() for _ in range(2)])
    return str(d)


def _gate_trainer(data_dir, ckpt):
    return trainer_mod.Trainer(GATE_CFG, trainer_mod.TrainerConfig(
        batch_size=2, grad_accum_every=1, max_steps=1, mixed_precision=False),
        data_dir, str(ckpt), device="cpu")


def test_the_trainer_gate_raises_before_building_the_model(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "device_hbm_bytes", lambda device: 1 << 10)
    built = []
    monkeypatch.setattr(trainer_mod, "ProGen", lambda *a, **k: built.append(1))
    with pytest.raises(ValueError) as e:
        _gate_trainer(data_dir, tmp_path / "ck")
    msg = str(e.value)
    assert "predicted per-card memory" in msg and "params (f32)" in msg and "try:" in msg
    assert built == []


def test_skip_memory_check_skips_the_gate(data_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_mod, "device_hbm_bytes", lambda device: 1 << 10)
    monkeypatch.setenv("PROGEN_SKIP_MEMORY_CHECK", "1")
    t = _gate_trainer(data_dir, tmp_path / "ck")
    try:
        assert t.memory_plan is None
    finally:
        t.close()


def test_no_gate_on_the_cpu(data_dir, tmp_path):
    assert memory.device_hbm_bytes(torch.device("cpu")) is None
    t = _gate_trainer(data_dir, tmp_path / "ck")
    try:
        assert t.memory_plan is not None
        assert t.memory_plan.num_params == memory.count_params(GATE_CFG)
    finally:
        t.close()
