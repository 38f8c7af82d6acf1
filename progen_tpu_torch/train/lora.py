"""Frozen-base LoRA fine-tuning through the port's train step (ported from
progen_tpu/train/lora.py).

A tenant's adapter is trained as a thin wrapper (:class:`LoRAProGen`) around
the unchanged :class:`~progen_tpu_torch.models.progen.ProGen`: the wrapper
holds one ``(d_in, rank)`` / ``(rank, d_out)`` factor pair per serving site
(``workloads/lora.lora_sites``) and feeds them through the SAME
``apply_lora`` path the decode step uses, as a two-tenant stacked bank whose
row 0 is zero and whose row 1 holds the live factors.  Training therefore
runs exactly the serving math.

Freezing is an optimizer property, not a ``requires_grad`` switch: the
whole model is differentiated (so the base's gradients, the SGU's spatial
weights' included, are computed and thrown away, as JAX's
``multi_transform(adamw, set_to_zero)`` does, and the step's ``grad_norm``
is over the whole tree), and :func:`make_lora_optimizer` never writes a base
parameter, so the base stays BIT-identical across any number of steps.
The optimizer has no clip.  Every factor is 2-D, so the optimizer's usual
rule (decay where ``ndim > 1``) decays every one, as optax's adamw with no
mask does (by 0 unless ``weight_decay`` is given).

Serving hand-off: :func:`extract_adapters` pulls the trained factor tree out
of the wrapper's parameters; ``workloads/lora.bank_from_trained`` stacks one
such tree per tenant into the engine's serving bank.

The superstep (``train_multi_step``, ``train/step.py``) runs the same way:
on the card one captured optimizer step, replayed; the frozen base is read
by the graph (the forward and the discarded gradients) and never written,
and it has no moments, so the graph's writes are the factors', their
moments' and the accumulator's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import Policy, make_policy
from progen_tpu_torch.models.progen import ProGen, ProGenConfig
from progen_tpu_torch.train.optimizer import Optimizer, Params
from progen_tpu_torch.train.step import TrainFunctions, make_train_functions
from progen_tpu_torch.workloads.lora import lora_sites

ADAPTER_LABEL = "adapters"
FROZEN_LABEL = "frozen"
# flax's truncated-normal correction: the std of N(0, 1) cut at +-2
_TRUNC_STD = 0.87962566103423978


class LoRAProGen(nn.Module):
    """ProGen with trainable low-rank adapters and a frozen base.

    The base model is the submodule ``base`` (its parameters are
    ``base.*``, a ``ProGen`` state dict under that prefix: see
    :func:`init_from_base`).  Each adapter site holds two parameters
    ``{layer}_{site}_a`` ``(d_in, rank)`` (lecun-normal, truncated at 2
    std) and ``{layer}_{site}_b`` ``(rank, d_out)`` (zeros), so step 0 is
    the base model exactly.

    The forward stacks ``[zeros, factors]`` into a 2-tenant bank and runs
    every row as tenant 1.  ``device=None`` means ``cuda``.
    """

    def __init__(self, config: ProGenConfig, rank: int, policy: Policy | None = None,
                 device=None, seed: int = 0):
        super().__init__()
        self.config = config
        self.rank = rank
        self.policy = policy or make_policy()
        dev = resolve_device(device)
        self.base = ProGen(config, self.policy, device=dev, seed=seed)
        self.sites = [(layer, name, din, dout)
                      for layer, s in sorted(lora_sites(config).items())
                      for name, (din, dout) in sorted(s.items())]
        dt = self.policy.param_dtype
        for layer, name, din, dout in self.sites:
            self.register_parameter(f"{layer}_{name}_a", nn.Parameter(
                torch.empty(din, rank, dtype=dt, device=dev)))
            self.register_parameter(f"{layer}_{name}_b", nn.Parameter(
                torch.zeros(rank, dout, dtype=dt, device=dev)))
        self._init_adapters(seed)

    @property
    def device(self) -> torch.device:
        return self.base.device

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Draw the base's parameters and the adapters from ``seed``."""
        self.base.init_weights(seed)
        self._init_adapters(seed)

    @torch.no_grad()
    def _init_adapters(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed + 1)
        for layer, name, din, _ in self.sites:
            std = math.sqrt(1.0 / din) / _TRUNC_STD
            w = torch.empty(din, self.rank)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
            getattr(self, f"{layer}_{name}_a").copy_(w)
            getattr(self, f"{layer}_{name}_b").zero_()

    def adapters(self) -> dict:
        """The two-tenant bank of the live factors (row 0 zero)."""
        bank: dict = {}
        for layer, name, _, _ in self.sites:
            a = getattr(self, f"{layer}_{name}_a")
            b = getattr(self, f"{layer}_{name}_b")
            bank.setdefault(layer, {})[name] = {
                "a": torch.stack([torch.zeros_like(a), a]),
                "b": torch.stack([torch.zeros_like(b), b])}
        return bank

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tenant = torch.ones(tokens.shape[0], dtype=torch.long, device=tokens.device)
        return self.base(tokens, adapters=self.adapters(), tenant=tenant)


def lora_param_labels(params: Params) -> dict[str, str]:
    """:data:`FROZEN_LABEL` for every ``base.*`` parameter,
    :data:`ADAPTER_LABEL` for every factor."""
    return {k: FROZEN_LABEL if k.startswith("base.") else ADAPTER_LABEL
            for k in params}


def make_lora_optimizer(learning_rate=1e-3, *, grad_accum_every: int = 1,
                        b1: float = 0.9, b2: float = 0.999,
                        weight_decay: float = 0.0) -> Optimizer:
    """Adapter-only optimizer: AdamW on the factors (all 2-D, so every one
    decayed, by ``weight_decay``), the base never written, no clip; accumulating
    over ``grad_accum_every`` micro-batches as ``optax.MultiSteps`` does."""
    return Optimizer(learning_rate, weight_decay=weight_decay, max_grad_norm=None,
                     grad_accum_every=grad_accum_every, b1=b1, b2=b2,
                     frozen=lambda name: name.startswith("base."))


def lora_train_functions(model: LoRAProGen, learning_rate=1e-3,
                         grad_accum_every: int = 1,
                         weight_decay: float = 0.0) -> TrainFunctions:
    """The standard :func:`make_train_functions` bundle with the frozen-base
    optimizer."""
    tx = make_lora_optimizer(learning_rate, grad_accum_every=grad_accum_every,
                             weight_decay=weight_decay)
    return make_train_functions(model, tx)


@torch.no_grad()
def init_from_base(params: Params, base_params: dict) -> Params:
    """Copy pretrained ProGen parameters (a ``ProGen`` state dict, e.g. a
    serving checkpoint) into the wrapper's ``base.*`` entries of ``params``
    (a ``TrainState.params`` or ``dict(model.named_parameters())``), in
    place and cast to each entry's dtype; returns ``params``."""
    base = {k[len("base."):]: p for k, p in params.items() if k.startswith("base.")}
    if not base:
        raise ValueError("params has no 'base.' entries: not LoRAProGen params")
    if set(base) != set(base_params):
        raise ValueError(f"base parameters differ: missing "
                         f"{sorted(set(base) - set(base_params))}, unexpected "
                         f"{sorted(set(base_params) - set(base))}")
    for name, p in base.items():
        new = torch.as_tensor(base_params[name])
        if tuple(new.shape) != tuple(p.shape):
            raise ValueError(f"base.{name}: shape {tuple(new.shape)}, "
                             f"want {tuple(p.shape)}")
        p.copy_(new.to(p.dtype))
    return params


def extract_adapters(params: Params, config: ProGenConfig) -> dict:
    """Trained factor tree ``{layer: {site: {"a": (din, r), "b": (r, dout)}}}``
    of f32 copies: the per-tenant element ``workloads/lora.bank_from_trained``
    stacks into a serving bank."""
    out: dict = {}
    for layer, s in sorted(lora_sites(config).items()):
        out[layer] = {}
        for name in sorted(s):
            out[layer][name] = {
                k: params[f"{layer}_{name}_{k}"].detach().float().clone()
                for k in ("a", "b")}
    return out
