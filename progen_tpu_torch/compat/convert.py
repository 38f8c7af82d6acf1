"""Carry weights between the JAX package's flax parameters and the port.

A flax parameter tree (nested dicts, keyed ``embed/embedding``,
``attn{i}/{norm/scale, to_qkv/kernel, to_out/{kernel,bias}}``,
``ff{i}/{norm/scale, proj_in/..., proj_out/..., sgu/{norm/scale,
spatial_weights, spatial_biases, proj_out/...}}``, ``norm_out/scale``,
``to_logits/{kernel,bias}``) maps one leaf to one tensor of
``ProGen.state_dict()``: ``attn{i}``/``ff{i}`` become ``attn.{i}``/
``ff.{i}``, ``kernel`` becomes ``weight`` TRANSPOSED (flax kernels are
``(in, out)``, ``nn.Linear`` weights ``(out, in)``) and ``embedding``
becomes ``weight``.  Everything else keeps its name and layout.

A QUANTIZED tree (``{"params": int8 leaves, "qscale": scales}``, what
``ops/quant.py:quantize_params`` returns on either side) maps the same way
onto a ``ProGen(weights="int8")`` state dict: ``kernel_scale`` becomes
``weight_scale`` and ``spatial_weights_scale`` keeps its name.

A LoRA bank (``{layer: {site: {"a": (T, din, r), "b": (T, r, dout)}}}``)
has the same layout on both sides: :func:`bank_from_numpy` only re-types
it.  The JAX ``LoRAProGen``'s parameters (a ``"base"`` subtree beside
``{layer}_{site}_a``/``_b`` factors) map onto the port's ``LoRAProGen``
by :func:`lora_params_from_flax`: the base through
:func:`params_from_flax` under the ``base.`` prefix, the factors as they
are (their layout is ``(d_in, r)`` / ``(r, d_out)`` on both sides).

``save_npz``/``load_npz`` store the flat flax keys (``"attn0/to_qkv/kernel"``)
in flax layout with numpy alone, so either framework can write the file.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_BLOCK = re.compile(r"^(attn|ff)(\d+)$")


def _flatten(tree: dict, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, dict):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _torch_name(path: tuple) -> tuple[str, bool]:
    """Flax path -> (state_dict key, whether the value is transposed)."""
    parts = []
    for part in path[:-1]:
        m = _BLOCK.match(part)
        parts.extend((m.group(1), m.group(2)) if m else (part,))
    leaf = path[-1]
    if leaf == "kernel":
        return ".".join(parts + ["weight"]), True
    if leaf == "kernel_scale":
        return ".".join(parts + ["weight_scale"]), False
    if leaf == "embedding":
        return ".".join(parts + ["weight"]), False
    return ".".join(parts + [leaf]), False


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """The flax parameter tree (with or without its ``"params"`` level) as a
    ``ProGen`` state dict of CPU tensors in the leaves' own dtypes.  With a
    ``"qscale"`` level beside ``"params"`` (a quantized tree) the scales
    join the state dict of a ``ProGen(weights="int8")``."""
    scales = tree.get("qscale", {}) if "params" in tree else {}
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    state = {}
    for path, value in {**_flatten(tree), **_flatten(scales)}.items():
        name, transpose = _torch_name(path)
        value = np.ascontiguousarray(value.T if transpose else value)
        state[name] = torch.from_numpy(value.copy())
    return state


def bank_from_numpy(bank: dict, device="cpu") -> dict[str, dict]:
    """A LoRA bank of array-likes (numpy or JAX arrays) as the port's bank
    of f32 tensors on ``device``."""
    return {layer: {name: {k: torch.from_numpy(np.array(v, np.float32)).to(device)
                           for k, v in site.items()}
                    for name, site in sites.items()}
            for layer, sites in bank.items()}


def lora_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """The JAX ``LoRAProGen``'s parameter tree (with or without its
    ``"params"`` level) as the port's ``LoRAProGen`` state dict of CPU
    tensors."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    state = {f"base.{k}": v for k, v in params_from_flax(tree["base"]).items()}
    for name, value in tree.items():
        if name != "base":
            state[name] = torch.from_numpy(np.array(value))
    return state


def params_to_flax(state: dict[str, torch.Tensor]) -> dict:
    """A ``ProGen`` state dict as the flax parameter tree (inner level, no
    ``"params"`` key) of numpy arrays: the inverse of
    :func:`params_from_flax`."""
    tree: dict = {}
    for name, value in state.items():
        path = re.sub(r"^(attn|ff)\.(\d+)\.", r"\1\2.", name).split(".")
        arr = value.detach().cpu().numpy()
        if path[-1] == "weight":
            if path == ["embed", "weight"]:
                path[-1] = "embedding"
            else:
                path[-1] = "kernel"
                arr = arr.T
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def grads_to_flax(model: torch.nn.Module) -> dict:
    """``model``'s parameter gradients as the flax tree
    :func:`params_to_flax` makes of its parameters (an absent gradient is
    zeros)."""
    return params_to_flax({
        name: p.grad if p.grad is not None else torch.zeros_like(p)
        for name, p in model.named_parameters()})


def save_npz(path, model: torch.nn.Module) -> None:
    """Write ``model``'s parameters as flat flax keys in flax layout."""
    flat = _flatten(params_to_flax(model.state_dict()))
    np.savez(path, **{"/".join(k): v for k, v in flat.items()})


def load_npz(path, model: torch.nn.Module) -> None:
    """Load flat flax keys (as :func:`save_npz` writes) into ``model``."""
    with np.load(path) as data:
        tree: dict = {}
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    model.load_state_dict(params_from_flax(tree))
