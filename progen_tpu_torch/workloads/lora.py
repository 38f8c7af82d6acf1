"""Multi-tenant LoRA adapter banks for serving (ported from
progen_tpu/workloads/lora.py).

An adapter SITE is one dense projection in the model: the fused q/k/v
projection and the attention output projection of every layer, plus the
SGU channel projection of every gMLP layer.  A serving BANK stacks the
low-rank factors of ``T`` tenants per site, as f32 tensors::

    bank[f"attn{i}"]["qkv"] = {"a": (T, dim, r),   "b": (T, r, 3*inner)}
    bank[f"attn{i}"]["out"] = {"a": (T, inner, r), "b": (T, r, dim)}
    bank[f"ff{i}"]["sgu"]   = {"a": (T, half, r),  "b": (T, r, half)}

Tenant 0 is the BASE model: its factor rows are all-zero by construction
and the model applies the delta through an output-side ``where`` guard
(``models/progen.apply_lora``), so a tenant-0 row is bit-identical to
running without adapters at all.  At decode time each batch row gathers
its own tenant's factors (``models/progen.lora_delta``): one step serves
every tenant in the batch.

Any LoRA alpha/scale is folded into ``b`` when the bank is built
(:func:`bank_from_trained`); serving never sees a scale knob.

The shape rules (:func:`lora_sites`, :func:`validate_lora_bank`,
:func:`adapter_bank_bytes`) are the JAX module's.  The random initialisers
draw from a ``torch.Generator`` seeded with ``seed``, so their values
differ from ``jax.random``'s; a JAX bank carries across through
``compat/convert.py:bank_from_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.models.progen import ProGenConfig


def lora_sites(config: ProGenConfig) -> dict[str, dict[str, tuple[int, int]]]:
    """``{layer: {site: (d_in, d_out)}}`` for every adapter site."""
    inner = config.heads * config.dim_head
    sites: dict[str, dict[str, tuple[int, int]]] = {}
    for i in range(config.depth):
        sites[f"attn{i}"] = {
            "qkv": (config.dim, 3 * inner),
            "out": (inner, config.dim),
        }
    for i in range(config.depth):
        if config.layer_uses_gmlp(i):
            # gMLP layers run non-GLU, so hidden = dim * ff_mult and the
            # SGU channel projection maps half -> half
            half = (config.dim * config.ff_mult) // 2
            sites[f"ff{i}"] = {"sgu": (half, half)}
    return sites


def init_lora_bank(config: ProGenConfig, num_tenants: int, rank: int,
                   seed: int = 0, device=None) -> dict:
    """Fresh serving bank on ``device`` (default ``cuda``): ``a`` rows
    normal with std ``d_in ** -0.5`` per tenant, ``b`` rows zero (standard
    LoRA init: every tenant starts as an exact no-op), tenant 0 all-zero.
    Drawn on the CPU from ``seed``, site by site in sorted order."""
    if num_tenants < 1:
        raise ValueError("num_tenants must be >= 1 (tenant 0 is the base)")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    bank: dict = {}
    for layer, s in sorted(lora_sites(config).items()):
        bank[layer] = {}
        for name, (din, dout) in sorted(s.items()):
            a = torch.randn(num_tenants, din, rank, generator=gen) * (din ** -0.5)
            a[0] = 0.0
            bank[layer][name] = {
                "a": a.to(device),
                "b": torch.zeros(num_tenants, rank, dout, device=device),
            }
    return bank


def random_lora_bank(config: ProGenConfig, num_tenants: int, rank: int,
                     seed: int = 0, scale: float = 1e-2, device=None) -> dict:
    """A bank whose non-base tenants produce NONZERO deltas (both factors
    random, ``b`` normal times ``scale`` from ``seed + 1``): test fixtures
    and load need tenants that visibly diverge from the base model.  Tenant
    0 stays all-zero."""
    bank = init_lora_bank(config, num_tenants, rank, seed=seed, device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    for layer in sorted(bank):
        for name in sorted(bank[layer]):
            site = bank[layer][name]
            b = torch.randn(site["b"].shape, generator=gen) * scale
            b[0] = 0.0
            site["b"] = b.to(site["b"].device)
    return bank


def bank_num_tenants(bank: dict) -> int:
    for layer in bank.values():
        for site in layer.values():
            return int(site["a"].shape[0])
    raise ValueError("empty adapter bank")


def validate_lora_bank(config: ProGenConfig, bank: dict) -> int:
    """Shape-check a bank against the model's sites; returns ``T``."""
    sites = lora_sites(config)
    if set(bank) != set(sites):
        raise ValueError(
            f"bank layers {sorted(bank)} != model sites {sorted(sites)}")
    t = bank_num_tenants(bank)
    r = None
    for layer, s in sites.items():
        if set(bank[layer]) != set(s):
            raise ValueError(
                f"bank[{layer!r}] sites {sorted(bank[layer])} != "
                f"{sorted(s)}")
        for name, (din, dout) in s.items():
            a = bank[layer][name]["a"]
            b = bank[layer][name]["b"]
            if r is None:
                r = a.shape[-1]
            want_a = (t, din, r)
            want_b = (t, r, dout)
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(
                    f"bank[{layer!r}][{name!r}] shapes a={tuple(a.shape)} "
                    f"b={tuple(b.shape)}, want a={want_a} b={want_b}")
    return t


def bank_from_trained(config: ProGenConfig, rank: int, trained: list,
                      scale: float = 1.0) -> dict:
    """Build a serving bank from per-tenant TRAINED adapter trees.

    ``trained[t]`` holds tenant ``t + 1``'s factors as
    ``{layer: {site: {"a": (din, r), "b": (r, dout)}}}`` (what
    ``train/lora.py``'s ``extract_adapters`` returns).  Tenant 0 is the
    all-zero base row; ``scale`` (e.g. alpha / rank) is folded into ``b``
    so serving needs no scale knob.  The bank lies on the factors' device.
    """
    sites = lora_sites(config)
    num_tenants = len(trained) + 1
    bank: dict = {}
    for layer, s in sorted(sites.items()):
        bank[layer] = {}
        for name, (din, dout) in sorted(s.items()):
            factors = [tree[layer][name] for tree in trained]
            dev = torch.as_tensor(factors[0]["a"]).device if factors else None
            f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
            a_rows = [torch.zeros(din, rank, device=dev)]
            b_rows = [torch.zeros(rank, dout, device=dev)]
            for site in factors:
                a_rows.append(f32(site["a"]))
                b_rows.append(f32(site["b"]) * scale)
            bank[layer][name] = {"a": torch.stack(a_rows),
                                 "b": torch.stack(b_rows)}
    validate_lora_bank(config, bank)
    assert bank_num_tenants(bank) == num_tenants
    return bank


def adapter_bank_bytes(config: ProGenConfig, num_tenants: int, rank: int,
                       bytes_per_el: int = 4) -> int:
    """Device footprint of a serving bank (f32 by default): the memory
    plan's adapter line item."""
    total = 0
    for s in lora_sites(config).values():
        for din, dout in s.values():
            total += num_tenants * rank * (din + dout) * bytes_per_el
    return total


def tenant_ids(bank: dict) -> np.ndarray:
    """The usable non-base tenant ids for a bank: ``1..T-1``."""
    return np.arange(1, bank_num_tenants(bank))


def cast_bank(bank: dict, dtype: torch.dtype, device) -> dict:
    """The bank's factors in ``dtype`` on ``device``: what the serving
    engine holds, cast once (the model casts gathered factors to the
    activations' dtype, which then is a no-op; casting before the gather
    gives the same bits)."""
    return {layer: {name: {k: v.to(device=device, dtype=dtype)
                           for k, v in site.items()}
                    for name, site in sites.items()}
            for layer, sites in bank.items()}
