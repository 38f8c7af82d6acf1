"""The port's mesh and rule tables (``progen_tpu_torch/core/mesh.py``,
``progen_tpu_torch/parallel/sharding.py``) against the JAX package's, in
this process: ``MeshConfig.parse``/``resolve``, ``auto_factorize``,
``process_batch_shards``, ``logical_rules`` and ``validate_tp_divisibility``
on the cases of ``tests/test_mesh_sharding.py:20-50,143-226``; every
parameter's mesh axes under each strategy mix against flax's
``logical_to_mesh_axes`` over the JAX model's own logical specs; and, in a
process group of one, ``make_mesh``/``single_device_mesh`` and the checks
of the strategies against the mesh."""

import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from progen_tpu.core import mesh as jax_mesh
from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxProGenConfig
from progen_tpu.parallel import sharding as jax_sharding
from progen_tpu_torch.compat.convert import _torch_name
from progen_tpu_torch.core import mesh
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.parallel import sharding

torch.set_num_threads(1)

CFG = dict(num_tokens=64, dim=16, seq_len=32, depth=2, window_size=8,
           global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)


@pytest.mark.parametrize("config,n", [
    ({}, 8), ({"data": -1, "tensor": 2}, 8), ({"data": 2, "fsdp": 2, "tensor": 2, "seq": 1}, 8),
    ({"data": 3}, 8), ({"data": -1, "fsdp": -1}, 8), ({"data": 2, "fsdp": 2, "tensor": 2, "seq": 2}, 8),
    ({"data": 1, "fsdp": -1}, 4), ({"seq": 2}, 6),
])
def test_mesh_config_resolve_matches_jax(config, n):
    def outcome(cls):
        try:
            return cls(**config).resolve(n)
        except ValueError as e:
            return ("raises", str(e))
    assert outcome(mesh.MeshConfig) == outcome(jax_mesh.MeshConfig)


@pytest.mark.parametrize("spec", ["-1,1,1,1", "2,2,1,2", "1,-1,1,1", "1,1,1", "a,1,1,1",
                                  "1,2,3,4,5"])
def test_mesh_config_parse_matches_jax(spec):
    def outcome(cls):
        try:
            return tuple(vars(cls.parse(spec)).values())
        except ValueError as e:
            return ("raises", str(e))
    assert outcome(mesh.MeshConfig) == outcome(jax_mesh.MeshConfig)


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16, 12])
@pytest.mark.parametrize("flags", [{}, {"use_sp": False},
                                   {"use_sp": False, "use_tp": False, "use_fsdp": False}])
def test_auto_factorize_matches_jax(n, flags):
    got = mesh.auto_factorize(n, **flags)
    assert tuple(vars(got).values()) == tuple(vars(jax_mesh.auto_factorize(n, **flags)).values())
    with pytest.raises(ValueError):
        mesh.auto_factorize(0)


def _layouts():
    # (grid shape, process of each grid index): tensor-spanning, data x
    # tensor, straddling, one process per device (dp and dp x sp)
    return {
        "tensor_spanning": ((2, 1, 2, 1), lambda idx: idx[2]),
        "data_by_tensor": ((2, 1, 2, 1), lambda idx: idx[0] * 2 + idx[2]),
        "straddling": ((2, 1, 2, 1), lambda idx: 0 if idx[2] == 0 else 1 + idx[0]),
        "dp4": ((4, 1, 1, 1), lambda idx: idx[0]),
        "dp2_sp2": ((2, 1, 1, 2), lambda idx: idx[0] * 2 + idx[3]),
        "fsdp2_sp2": ((1, 2, 1, 2), lambda idx: idx[1] * 2 + idx[3]),
    }


@pytest.mark.parametrize("layout", list(_layouts()))
def test_process_batch_shards_matches_jax(layout, monkeypatch):
    shape, process_of = _layouts()[layout]
    grid = np.empty(shape, dtype=int)
    devs = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        grid[idx] = process_of(idx)
        devs[idx] = types.SimpleNamespace(process_index=process_of(idx))
    for me in sorted(set(grid.flat)):
        monkeypatch.setattr(jax, "process_index", lambda me=me: me)
        try:
            want = jax_mesh.process_batch_shards(types.SimpleNamespace(devices=devs))
        except ValueError as e:
            with pytest.raises(ValueError, match="inconsistently"):
                mesh.process_batch_shards(grid, me)
            assert "inconsistently" in str(e)
            continue
        assert mesh.process_batch_shards(grid, me) == want


STRATEGY_MIXES = [("dp",), ("fsdp",), ("sp",), ("fsdp", "tp"), ("fsdp", "sp"),
                  ("sp", "fsdp"), ("dp", "sp"), ("dp", "fsdp", "tp", "sp")]


@pytest.mark.parametrize("strategies", STRATEGY_MIXES)
def test_logical_rules_match_jax(strategies):
    assert sharding.logical_rules(strategies) == jax_sharding.logical_rules(strategies)
    assert sharding.RULE_SETS == jax_sharding.RULE_SETS


@pytest.mark.parametrize("strategies", STRATEGY_MIXES)
def test_every_parameters_mesh_axes_match_flax(strategies):
    """The port's table of logical axes, resolved by the rules, puts each
    parameter's dims on the mesh axes flax puts the JAX model's on (a flax
    kernel's dims transposed)."""
    model = JaxProGen(config=JaxProGenConfig(**CFG), policy=jax_policy(False))
    specs = jax_sharding.param_logical_specs(model, jnp.zeros((2, CFG["seq_len"]), jnp.int32))
    rules = jax_sharding.logical_rules(strategies)
    flat = jax.tree_util.tree_flatten_with_path(
        specs["params"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    names = {n for n, _ in ProGen(ProGenConfig(**CFG), device="cpu").named_parameters()}
    seen = set()
    for path, spec in flat:
        name, transposed = _torch_name(tuple(p.key for p in path))
        axes = nn.logical_to_mesh_axes(spec, rules)
        want = {}
        for dim, axis in enumerate(axes):
            if axis is not None:
                want[1 - dim if transposed else dim] = axis
        assert sharding.mesh_axes_of(name, strategies) == want, (name, spec)
        seen.add(name)
    assert seen == names


@pytest.mark.parametrize("size,strategies", [(3, ("tp",)), (2, ("tp",)), (3, ("fsdp",)),
                                             (1, ("tp",)), (4, ("tp",))])
def test_validate_tp_divisibility_matches_jax(size, strategies):
    def outcome(fn, cfg):
        try:
            fn(cfg, size, strategies=strategies)
            return None
        except ValueError as e:
            return str(e)
    assert (outcome(sharding.validate_tp_divisibility, ProGenConfig(**CFG))
            == outcome(jax_sharding.validate_tp_divisibility, JaxProGenConfig(**CFG)))


@pytest.fixture
def world_of_one():
    mesh.initialize_distributed("cpu")
    yield
    dist.destroy_process_group()


def test_meshes_in_a_world_of_one(world_of_one):
    m = mesh.make_mesh(mesh.MeshConfig(), "cpu")
    assert m.mesh_dim_names == mesh.MESH_AXES
    assert mesh.mesh_sizes(m) == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    assert mesh.mesh_sizes(mesh.single_device_mesh("cpu")) == mesh.mesh_sizes(m)
    assert mesh.process_batch_shards(m) == (1, 0)
    assert sharding.param_placements("embed.weight", m, ("fsdp",))[1] == sharding.Shard(1)
    assert sharding.param_placements("embed.weight", m, ("dp",)) == sharding.replicated(m)
    # a tensor axis is ported: it needs its ranks, and 'tp' with it
    with pytest.raises(ValueError, match="needs 2 devices"):
        mesh.make_mesh(mesh.MeshConfig(data=1, tensor=2), "cpu")
    assert sharding.check_strategies(("dp", "tp"), m) == ("dp", "tp")
    assert sharding.param_placements("attn.0.to_qkv.weight", m, ("tp",))[2] == sharding.Shard(0)
    assert sharding.param_placements("ff.0.proj_out.weight", m, ("tp",))[2] == sharding.Shard(1)
    with pytest.raises(ValueError, match="unknown strategies"):
        sharding.check_strategies(("zero",), m)


@pytest.mark.parametrize("strategies", [("dp", "tp", "sp"), ("fsdp", "tp"), ("tp",),
                                        ("dp", "sp")])
def test_a_world_of_one_takes_the_unmeshed_step(world_of_one, strategies):
    """On a mesh of one rank every strategy mix, ``tp`` with a tensor axis
    of 1 and ``sp`` with a seq axis of 1 included (the SGU's weights then a
    DTensor of one shard), takes the unmeshed f32 step: the loss and every
    updated parameter at 1e-6."""
    from progen_tpu_torch.core.precision import make_policy
    from progen_tpu_torch.parallel.sharding import full_tensor
    from progen_tpu_torch.train.optimizer import make_optimizer
    from progen_tpu_torch.train.step import make_train_functions

    torch.set_num_threads(1)
    cfg = ProGenConfig(**CFG)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        1, 60, (2, cfg.seq_len + 1)))
    got, want = [], []
    for out, m in ((want, None), (got, mesh.make_mesh(mesh.MeshConfig(), "cpu"))):
        model = ProGen(cfg, make_policy(False), device="cpu", seed=0)
        fns = make_train_functions(model, make_optimizer(1e-3), mesh=m,
                                   strategies=strategies if m is not None else ("dp",))
        state, metrics = fns.train_step(fns.init_state(), batch)
        pieces = model.parallel_plan.pieces if m is not None else (lambda name: 1)
        out.append(float(metrics["loss"]))
        out.append({n: full_tensor(p.detach(), pieces(n)) for n, p in state.params.items()})
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    for name, value in want[1].items():
        torch.testing.assert_close(got[1][name], value, rtol=1e-6, atol=1e-6)
