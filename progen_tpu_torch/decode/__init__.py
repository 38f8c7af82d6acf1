from progen_tpu_torch.decode.engine import (
    FAILED_FAULT,
    SHED_DEADLINE,
    SHED_QUEUE_FULL,
    STATUS_OK,
    Completion,
    Request,
    ServingEngine,
    run_with_restarts,
)
from progen_tpu_torch.decode.handoff import Handle, HandoffQueue
from progen_tpu_torch.decode.incremental import (
    ProGenDecodeStep,
    ProGenPagedDecodeStep,
    init_caches,
    init_gate_pool,
)
from progen_tpu_torch.decode.prefill import (
    harvest_caches,
    harvest_gate_pages,
    make_embedder,
    make_prefiller,
    pad_prime_length,
    prime_buckets,
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
    "Completion",
    "FAILED_FAULT",
    "Handle",
    "HandoffQueue",
    "ProGenDecodeStep",
    "ProGenPagedDecodeStep",
    "Request",
    "SHED_DEADLINE",
    "SHED_QUEUE_FULL",
    "STATUS_OK",
    "ServingEngine",
    "apply_logit_mask",
    "check_draft_config",
    "gumbel_topk_sample",
    "harvest_caches",
    "harvest_gate_pages",
    "init_caches",
    "init_gate_pool",
    "make_chunked_sampler",
    "make_embedder",
    "make_prefiller",
    "make_sampler",
    "pad_prime_length",
    "prime_buckets",
    "run_with_restarts",
    "scatter_gate_rows",
    "spec_acceptance",
    "spec_round",
    "teacher_forced_logits",
    "truncate_after_eos",
]
