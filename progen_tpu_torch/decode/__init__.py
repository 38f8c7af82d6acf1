from progen_tpu_torch.decode.incremental import ProGenDecodeStep, init_caches
from progen_tpu_torch.decode.prefill import (
    harvest_caches,
    make_prefiller,
    pad_prime_length,
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

__all__ = [
    "ChunkedSampler",
    "ProGenDecodeStep",
    "apply_logit_mask",
    "gumbel_topk_sample",
    "harvest_caches",
    "init_caches",
    "make_chunked_sampler",
    "make_prefiller",
    "make_sampler",
    "pad_prime_length",
    "teacher_forced_logits",
    "truncate_after_eos",
]
