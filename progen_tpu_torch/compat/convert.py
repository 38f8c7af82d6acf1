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
    if leaf == "embedding":
        return ".".join(parts + ["weight"]), False
    return ".".join(parts + [leaf]), False


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """The flax parameter tree (with or without its ``"params"`` level) as a
    ``ProGen`` state dict of f32-or-param-dtype CPU tensors."""
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    state = {}
    for path, value in _flatten(tree).items():
        name, transpose = _torch_name(path)
        value = np.ascontiguousarray(value.T if transpose else value)
        state[name] = torch.from_numpy(value.copy())
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
