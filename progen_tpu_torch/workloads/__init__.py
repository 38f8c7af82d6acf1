"""Served workloads beyond left-to-right generation (ported from
progen_tpu/workloads/).

Three request classes ride the engine and the trainer:

* **constrained span-infilling** (:mod:`.infill`): :class:`ScaffoldSpec`
  compiles a scaffold template (frozen positions, per-position allowed
  alphabets) into the per-request ``(G, V)`` logit mask the engine applies
  at every sampling site;
* **embeddings** (:func:`progen_tpu_torch.decode.prefill.make_embedder`,
  re-exported here): one prefill-shaped forward, mean-pooled final hidden
  states, no decode slot taken;
* **multi-tenant batched LoRA** (:mod:`.lora`): stacked per-tenant
  low-rank adapter banks gathered per row inside the decode step, trained
  with ``train/lora.py``.

``WORKLOADS`` names the request classes.
"""

from progen_tpu_torch.decode.prefill import make_embedder
from progen_tpu_torch.workloads.infill import (
    ScaffoldSpec,
    mask_from_wire,
    mask_to_wire,
)
from progen_tpu_torch.workloads.lora import (
    adapter_bank_bytes,
    bank_from_trained,
    bank_num_tenants,
    init_lora_bank,
    lora_sites,
    random_lora_bank,
    tenant_ids,
    validate_lora_bank,
)

WORKLOADS = ("generate", "infill", "embed", "lora")

__all__ = [
    "WORKLOADS",
    "ScaffoldSpec",
    "adapter_bank_bytes",
    "bank_from_trained",
    "bank_num_tenants",
    "init_lora_bank",
    "lora_sites",
    "make_embedder",
    "mask_from_wire",
    "mask_to_wire",
    "random_lora_bank",
    "tenant_ids",
    "validate_lora_bank",
]
