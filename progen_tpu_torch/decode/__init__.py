from progen_tpu_torch.decode.handoff import Handle, HandoffQueue
from progen_tpu_torch.decode.incremental import ProGenDecodeStep, init_caches
from progen_tpu_torch.decode.prefill import (
    harvest_caches,
    make_prefiller,
    pad_prime_length,
    scatter_gate_rows,
)
from progen_tpu_torch.decode.sampler import (
    ChunkedSampler,
    apply_logit_mask,
    gumbel_topk_sample,
    make_chunked_sampler,
    make_sampler,
    teacher_forced_logits,
    truncate_after_eos,
)
from progen_tpu_torch.decode.spec import (
    check_draft_config,
    spec_acceptance,
    spec_round,
)

__all__ = [
    "ChunkedSampler",
    "Handle",
    "HandoffQueue",
    "ProGenDecodeStep",
    "apply_logit_mask",
    "check_draft_config",
    "gumbel_topk_sample",
    "harvest_caches",
    "init_caches",
    "make_chunked_sampler",
    "make_prefiller",
    "make_sampler",
    "pad_prime_length",
    "scatter_gate_rows",
    "spec_acceptance",
    "spec_round",
    "teacher_forced_logits",
    "truncate_after_eos",
]
