"""Stage supervision for the multi-process serving runtime.

The serving cluster (``progen_tpu/serve/``, docs/SERVING.md §7) runs
prefill workers and decode replicas as child processes.  When one dies
(EOF on its socket, stale heartbeat, or a poisoned frame stream), the
router asks the :class:`StageSupervisor` whether to restart it.  The
supervisor is pure host-side policy — a bounded restart budget per
stage instance — so the decision is auditable and a crash-looping
worker can't burn the cluster forever: past the budget the router sheds
the affected requests as typed ``FAILED_FAULT`` completions instead
(load shedding produces a COMPLETION, never an exception — the same
contract as the in-process engine).

Copied from progen_tpu/resilience/supervise.py (standard library only);
the port keeps its own copy because it imports nothing of the JAX
package.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class StageEvent:
    """One supervision decision, kept for the stats record."""

    role: str
    index: int
    granted: bool
    reason: str
    at: float


class StageSupervisor:
    """Bounded per-stage-instance restart budget.

    ``max_restarts`` is per ``(role, index)`` — one flapping prefill
    worker exhausting its budget does not consume the replicas'.
    ``min_interval_s`` rejects restarts that come faster than a real
    process could have done useful work (crash-loop detection).
    """

    def __init__(self, max_restarts: int = 1, min_interval_s: float = 0.0):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        self.max_restarts = max_restarts
        self.min_interval_s = min_interval_s
        self._counts: dict[tuple[str, int], int] = {}
        self._last: dict[tuple[str, int], float] = {}
        self.events: list[StageEvent] = []

    def request_restart(self, role: str, index: int,
                        reason: str = "") -> bool:
        """True iff the stage instance may be respawned; each grant
        consumes one unit of that instance's budget."""
        key = (role, index)
        now = time.perf_counter()
        used = self._counts.get(key, 0)
        if used >= self.max_restarts:
            granted, why = False, f"budget exhausted ({used})"
        elif now - self._last.get(key, -1e18) < self.min_interval_s:
            granted, why = False, "crash-looping (under min_interval_s)"
        else:
            granted, why = True, reason or "granted"
            self._counts[key] = used + 1
            self._last[key] = now
        self.events.append(StageEvent(role, index, granted, why, now))
        return granted

    def restarts_used(self, role: str, index: int) -> int:
        return self._counts.get((role, index), 0)

    # The control plane (serve/control.py) grows and shrinks the fleet:
    # a freshly scaled-up instance gets a FULL budget simply by being a
    # new (role, index) — indices are never reused — and a retired
    # instance is forgotten so its history can't be charged to a future
    # worker, nor linger in the stats of a long-lived cluster.

    def forget(self, role: str, index: int) -> None:
        """Drop all supervision state for a retired stage instance."""
        key = (role, index)
        self._counts.pop(key, None)
        self._last.pop(key, None)
        self.events.append(StageEvent(role, index, True, "retired",
                                      time.perf_counter()))

    def stats(self) -> dict:
        return {
            "max_restarts": self.max_restarts,
            "restarts": {f"{r}:{i}": n
                         for (r, i), n in sorted(self._counts.items())},
            "denied": sum(1 for e in self.events if not e.granted),
        }
