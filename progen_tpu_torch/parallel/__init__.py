"""Parallelism across processes on ``torch.distributed`` (ported from
progen_tpu/parallel): the rule tables and placements
(:mod:`~progen_tpu_torch.parallel.sharding`) and the sequence-parallel
halo and gather (:mod:`~progen_tpu_torch.parallel.context`)."""

from progen_tpu_torch.parallel.sharding import (
    RULE_SETS,
    batch_sharding,
    logical_rules,
    parallelize,
    replicated,
)

__all__ = [
    "RULE_SETS",
    "batch_sharding",
    "logical_rules",
    "parallelize",
    "replicated",
]
