"""The reference's Haiku checkpoint pickles into the port's store (ported
from progen_tpu/compat/reference.py).

The reference stores pickled packages ``{next_seq_index, params,
optim_state, model_config, run_id}`` with Haiku-named parameters.
:func:`reference_key_map`, :func:`convert_reference_params` and the checks
in them are copied from the JAX package: every Haiku parameter maps onto a
flax path (no transposes: Haiku ``Linear.w`` and flax ``Dense.kernel`` are
both ``(in, out)``), and ``compat/convert.params_from_flax`` carries the
flax tree onto the port's state dict.  :func:`expected_param_shapes` is
written out from the config here (the JAX package traces its model's
init), and a test pins the two to each other.

:func:`convert_reference_checkpoint` writes step 0 of the port's
``checkpoint/store.py``: the converted parameters, FRESH Adam moments (the
reference's optimizer state, an old-optax ``apply_every`` chain, is not
portable), and the pickle's ``next_seq_index`` and ``run_id``; a step 0
already in the store is replaced.  The Trainer then resumes at the cursor
and ``sample`` decodes from it.

A pickle runs code when it is loaded: convert only files you trust (the
reference's own checkpoints).
"""

from __future__ import annotations

import pickle
from typing import Any, Mapping

import numpy as np

from progen_tpu_torch.checkpoint.store import CheckpointStore
from progen_tpu_torch.compat.convert import params_from_flax
from progen_tpu_torch.models.progen import ProGenConfig
from progen_tpu_torch.train.optimizer import make_optimizer
from progen_tpu_torch.train.step import TrainState

_REF_ROOT = "pro_gen_base"


def reference_key_map(config) -> dict[tuple[str, str], tuple[str, ...]]:
    """``(haiku_module, haiku_param) -> flax path`` for every parameter of
    ``config`` (a ProGenConfig)."""
    m: dict[tuple[str, str], tuple[str, ...]] = {
        (f"{_REF_ROOT}/~/embed", "embeddings"): ("embed", "embedding"),
        (f"{_REF_ROOT}/~/layer_norm", "scale"): ("norm_out", "scale"),
        (f"{_REF_ROOT}/~/linear", "w"): ("to_logits", "kernel"),
        (f"{_REF_ROOT}/~/linear", "b"): ("to_logits", "bias"),
    }
    for i in range(config.depth):
        a = f"{_REF_ROOT}/~/attn{i}/~"
        f = f"{_REF_ROOT}/~/ff{i}/~"
        m[(f"{a}/layer_norm", "scale")] = (f"attn{i}", "norm", "scale")
        m[(f"{a}/linear", "w")] = (f"attn{i}", "to_qkv", "kernel")
        m[(f"{a}/linear_1", "w")] = (f"attn{i}", "to_out", "kernel")
        m[(f"{a}/linear_1", "b")] = (f"attn{i}", "to_out", "bias")
        m[(f"{f}/layer_norm", "scale")] = (f"ff{i}", "norm", "scale")
        m[(f"{f}/linear", "w")] = (f"ff{i}", "proj_in", "kernel")
        m[(f"{f}/linear", "b")] = (f"ff{i}", "proj_in", "bias")
        m[(f"{f}/linear_1", "w")] = (f"ff{i}", "proj_out", "kernel")
        m[(f"{f}/linear_1", "b")] = (f"ff{i}", "proj_out", "bias")
        if config.layer_uses_gmlp(i):
            sgu = f"{_REF_ROOT}/~/ff{i}/~/sgu"
            m[(sgu, "spatial_weights")] = (f"ff{i}", "sgu", "spatial_weights")
            m[(sgu, "spatial_biases")] = (f"ff{i}", "sgu", "spatial_biases")
            m[(f"{sgu}/~/layer_norm", "scale")] = (f"ff{i}", "sgu", "norm", "scale")
            m[(f"{sgu}/~/linear", "w")] = (f"ff{i}", "sgu", "proj_out", "kernel")
            m[(f"{sgu}/~/linear", "b")] = (f"ff{i}", "sgu", "proj_out", "bias")
    return m


def expected_param_shapes(config) -> dict[tuple[str, ...], tuple[int, ...]]:
    """``flax path -> shape`` for every parameter of ``config``."""
    c = config
    inner = c.heads * c.dim_head
    shapes: dict[tuple[str, ...], tuple[int, ...]] = {
        ("embed", "embedding"): (c.num_tokens, c.dim),
        ("norm_out", "scale"): (c.dim,),
        ("to_logits", "kernel"): (c.dim, c.num_tokens),
        ("to_logits", "bias"): (c.num_tokens,),
    }
    for i in range(c.depth):
        gmlp = c.layer_uses_gmlp(i)
        # GLU and the SGU each take two halves of the hidden width
        hidden = c.dim * c.ff_mult * (2 if c.ff_glu and not gmlp else 1)
        width = hidden // 2 if (c.ff_glu or gmlp) else hidden
        shapes.update({
            (f"attn{i}", "norm", "scale"): (c.dim,),
            (f"attn{i}", "to_qkv", "kernel"): (c.dim, 3 * inner),
            (f"attn{i}", "to_out", "kernel"): (inner, c.dim),
            (f"attn{i}", "to_out", "bias"): (c.dim,),
            (f"ff{i}", "norm", "scale"): (c.dim,),
            (f"ff{i}", "proj_in", "kernel"): (c.dim, hidden),
            (f"ff{i}", "proj_in", "bias"): (hidden,),
            (f"ff{i}", "proj_out", "kernel"): (width, c.dim),
            (f"ff{i}", "proj_out", "bias"): (c.dim,),
        })
        if gmlp:
            half = hidden // 2
            shapes.update({
                (f"ff{i}", "sgu", "spatial_weights"): (c.seq_len, c.seq_len),
                (f"ff{i}", "sgu", "spatial_biases"): (c.seq_len, 1),
                (f"ff{i}", "sgu", "norm", "scale"): (half,),
                (f"ff{i}", "sgu", "proj_out", "kernel"): (half, half),
                (f"ff{i}", "sgu", "proj_out", "bias"): (half,),
            })
    return shapes


def convert_reference_params(ref_params: Mapping[str, Mapping[str, Any]],
                             config) -> dict:
    """Haiku two-level param dict -> nested flax ``params`` tree (f32).

    Raises on any missing, unexpected or WRONG-SHAPED reference parameter,
    so a partial or corrupt conversion cannot happen (a pickle whose
    weights disagree with its embedded model_config fails here, not later
    at restore)."""
    key_map = reference_key_map(config)
    flat_ref = {
        (mod, name): np.asarray(v, dtype=np.float32)
        for mod, sub in ref_params.items()
        for name, v in sub.items()
    }
    missing = set(key_map) - set(flat_ref)
    extra = set(flat_ref) - set(key_map)
    if missing or extra:
        raise ValueError(
            "reference params do not match the config's parameter set:\n"
            f"  missing from pickle: {sorted(missing)}\n"
            f"  unexpected in pickle: {sorted(extra)}")

    expected = expected_param_shapes(config)
    bad = [(ref_key, flat_ref[ref_key].shape, expected[path])
           for ref_key, path in key_map.items()
           if tuple(flat_ref[ref_key].shape) != expected[path]]
    if bad:
        lines = "\n".join(f"  {mod} | {name}: pickle {got}, config wants {want}"
                          for (mod, name), got, want in sorted(bad))
        raise ValueError("reference param shapes disagree with the embedded "
                         f"model_config (corrupt or truncated pickle?):\n{lines}")

    out: dict = {}
    for ref_key, path in key_map.items():
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = flat_ref[ref_key]
    return out


def convert_reference_checkpoint(pkl_path: str, checkpoint_path: str, *,
                                 grad_accum_every: int = 4) -> dict:
    """Convert a reference ``ckpt_{time}.pkl`` into step 0 of the port's
    store at ``checkpoint_path``; returns the written metadata.

    The moments start at zero, laid out for ``grad_accum_every`` (the
    accumulation the store is resumed with: an accumulator is stored when
    it is above 1).  Training resumes at the pickle's ``next_seq_index``."""
    with open(pkl_path, "rb") as fh:
        package = pickle.load(fh)

    config = ProGenConfig.from_dict(package["model_config"])
    params = params_from_flax(convert_reference_params(package["params"], config))
    opt_state = make_optimizer(grad_accum_every=grad_accum_every).init(params)
    state = TrainState(step=0, params=params, opt_state=opt_state)
    next_seq_index = int(package.get("next_seq_index", 0))
    # overwrite: converting an updated pickle into the same store must
    # replace step 0, not keep the stale weights
    CheckpointStore(checkpoint_path).save(
        0, state, next_seq_index=next_seq_index, model_config=config.to_dict(),
        run_id=package.get("run_id"), overwrite=True)
    return {"model_config": config.to_dict(), "next_seq_index": next_seq_index,
            "run_id": package.get("run_id"),
            "num_params": sum(t.numel() for t in params.values())}
