"""Robustness counters for the serving tier.

One small host-side dataclass shared by the engine, the benchmarks and
the tests: every shed, contained fault and kernel-fallback activation is
counted HERE, so a chaos run's record (``benchmarks/chaos.jsonl``) and a
test's assertions read the same numbers the engine acted on.  Counters
are plain ints mutated between device dispatches — no locks needed, the
engine is single-threaded by construction.

Copied from progen_tpu/observe/robustness.py.  The port has no degraded
path for its paged kernel, so ``fallback_activations`` stays in the dict
and reads 0.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RobustnessCounters:
    """Serving-engine robustness tallies.

    ``sheds_queue_full``/``sheds_deadline``: requests turned away as
    typed completions (never raised).  ``failed_faults``: requests shed
    because a non-transient fault fired on their path.
    ``faults_contained``: transient faults absorbed by an in-place retry
    of the failed phase.  ``fallback_activations``: kept for the record's
    shape; the port never degrades its paged kernel, so it reads 0.  ``preemptions``:
    in-flight requests cancelled for a higher priority class and
    re-queued for bit-exact replay (docs/SERVING.md §10).
    """

    sheds_queue_full: int = 0
    sheds_deadline: int = 0
    failed_faults: int = 0
    faults_contained: int = 0
    fallback_activations: int = 0
    preemptions: int = 0

    def as_dict(self) -> dict[str, int]:
        return dataclasses.asdict(self)

    @property
    def sheds(self) -> int:
        return (self.sheds_queue_full + self.sheds_deadline
                + self.failed_faults)
