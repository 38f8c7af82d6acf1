"""Scaling policy for the elastic serving control plane — pure,
deterministic decision logic with NO side effects.

The control plane (``serve/control.py``) samples live signals from the
cluster — SLO error-budget burn rates (``observe/slo.py``), per-stage
queue depths and outstanding decode tokens from the router, worker
``stage_seconds`` — packs them into a :class:`PolicyInputs`, and asks
the policy what to do.  The policy returns :class:`ScaleDecision`
objects; the control plane executes them through the cluster's elastic
verbs and journals both.

Everything here is host-side stdlib and **deterministic**: the same
sequence of ``PolicyInputs`` always yields the same decisions, because
time enters only through ``inputs.now`` (never a wall clock read) and
the policy keeps no hidden state beyond the last-action timestamps it
needs for cooldown.  That makes policy behaviour unit-testable with
synthetic clocks and replayable from the control journal.

:class:`BurnRatePolicy` is the default: scale **up** when any watched
SLO burns faster than ``up_burn`` (budget spent faster than the
objective allows) or a stage's queue backlog exceeds
``up_queue_per_worker``; scale **down** when every burn rate is below
``down_burn`` AND the stage is near idle.  Hysteresis comes from the
gap between the up and down thresholds plus a per-stage ``cooldown_s``
after ANY action on that stage (including swaps), so the fleet cannot
flap.  Bounds are hard: the policy never leaves
``[min_prefill, max_prefill] x [min_replicas, max_replicas]``.

Copied from progen_tpu/serve/policy.py (standard library only); the port
keeps its own copy because it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["PolicyInputs", "ScaleDecision", "BurnRatePolicy"]


@dataclasses.dataclass(frozen=True)
class PolicyInputs:
    """One sampled view of the cluster, as the policy sees it.

    ``burn_rates`` maps SLO spec name -> fastest-window burn rate
    (float, ``math.inf`` allowed; specs with no data are omitted).
    ``prefill_queue`` / ``replica_outstanding`` map worker index ->
    queued request count / un-acked decode sequences.  ``queued_uids``
    counts requests parked on the driver waiting for any prefill slot.
    ``stage_seconds`` maps stage name -> cumulative seconds (fleet
    totals from worker heartbeats), for policies that weigh relative
    stage cost.  ``queued_by_class`` maps priority class -> fleet-wide
    queued-at-prefill count (docs/SERVING.md §10) — journaled with
    every decision, and available to QoS-aware policies that scale on
    high-class backlog rather than total depth.  ``replica_cache`` maps
    replica index -> ``{"value", "sole_hot", "stale"}`` from the
    router's cache digest table (docs/SERVING.md §11): the control
    plane's scale-down victim selection consumes it (evict the
    coldest/most-duplicated cache, never the sole holder of a hot
    prefix), and it is journaled so every scale-down is attributable
    to the cache picture it saw.  ``tp_group`` is the member-process
    count of ONE decode replica (docs/SERVING.md §13) — the policy
    still counts replicas, but a decode decision moves ``tp_group``
    whole processes, so cost-aware policies can weigh it."""

    now: float
    prefill_workers: int
    decode_replicas: int
    burn_rates: dict
    prefill_queue: dict
    replica_outstanding: dict
    queued_uids: int = 0
    stage_seconds: dict = dataclasses.field(default_factory=dict)
    queued_by_class: dict = dataclasses.field(default_factory=dict)
    replica_cache: dict = dataclasses.field(default_factory=dict)
    tp_group: int = 1


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One action the policy wants taken.

    ``action`` is ``"scale_up"`` or ``"scale_down"``; ``role`` is
    ``"prefill"`` or ``"decode"``.  ``cause`` names the signal that
    tripped the threshold and ``observed``/``threshold`` record the
    comparison, so the control journal can show WHY every action
    happened without re-deriving it."""

    action: str
    role: str
    cause: str
    observed: float
    threshold: float


def _worst_burn(burn_rates: dict) -> float:
    """Fastest burn across specs; 0.0 when nothing has data yet."""
    worst = 0.0
    for v in burn_rates.values():
        if v is None:
            continue
        v = float(v)
        if v > worst:
            worst = v
    return worst


class BurnRatePolicy:
    """Threshold policy over burn rate and queue depth, with hysteresis.

    Per tick it emits at most one decision per role — elastic actions
    are deliberately incremental (one worker at a time) so each spawn's
    warmup cost and each retire's drain are observable before the next
    move.  ``cooldown_s`` starts at the *decision* (the control plane
    also calls :meth:`note_action` when IT acts, e.g. a rolling swap,
    so policy and plane share one cooldown clock)."""

    def __init__(self, *, min_prefill: int = 1, max_prefill: int = 4,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_burn: float = 2.0, down_burn: float = 0.5,
                 up_queue_per_worker: float = 4.0,
                 down_queue_per_worker: float = 0.5,
                 cooldown_s: float = 5.0):
        if min_prefill < 1 or min_replicas < 1:
            raise ValueError("min fleet sizes must be >= 1")
        if max_prefill < min_prefill or max_replicas < min_replicas:
            raise ValueError("max fleet size below min")
        if down_burn >= up_burn:
            raise ValueError(
                f"need down_burn < up_burn for hysteresis, got "
                f"{down_burn} >= {up_burn}")
        self.min_prefill = min_prefill
        self.max_prefill = max_prefill
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_burn = up_burn
        self.down_burn = down_burn
        self.up_queue_per_worker = up_queue_per_worker
        self.down_queue_per_worker = down_queue_per_worker
        self.cooldown_s = cooldown_s
        self._last_action: dict[str, float] = {}

    # ------------------------------------------------------------- decisions

    def note_action(self, role: str, now: float) -> None:
        """Start ``role``'s cooldown at ``now`` (the control plane calls
        this for actions it initiates itself, e.g. swap rolls)."""
        self._last_action[role] = now

    def _cooling(self, role: str, now: float) -> bool:
        return now - self._last_action.get(role, -math.inf) < self.cooldown_s

    def decide(self, inputs: PolicyInputs) -> list[ScaleDecision]:
        """At most one decision per role; deterministic in ``inputs``."""
        out = []
        worst = _worst_burn(inputs.burn_rates)

        # --- prefill: backlog = driver-parked uids + worker queues
        if not self._cooling("prefill", inputs.now):
            n = max(1, inputs.prefill_workers)
            backlog = (inputs.queued_uids
                       + sum(inputs.prefill_queue.values())) / n
            d = None
            if inputs.prefill_workers < self.max_prefill:
                if worst >= self.up_burn:
                    d = ScaleDecision("scale_up", "prefill", "burn_rate",
                                      worst, self.up_burn)
                elif backlog >= self.up_queue_per_worker:
                    d = ScaleDecision("scale_up", "prefill", "queue_depth",
                                      backlog, self.up_queue_per_worker)
            if (d is None and inputs.prefill_workers > self.min_prefill
                    and worst <= self.down_burn
                    and backlog <= self.down_queue_per_worker):
                d = ScaleDecision("scale_down", "prefill", "burn_rate",
                                  worst, self.down_burn)
            if d is not None:
                out.append(d)
                self.note_action("prefill", inputs.now)

        # --- decode: pressure = outstanding sequences per replica
        if not self._cooling("decode", inputs.now):
            n = max(1, inputs.decode_replicas)
            pressure = sum(inputs.replica_outstanding.values()) / n
            d = None
            if inputs.decode_replicas < self.max_replicas:
                if worst >= self.up_burn and pressure >= 1.0:
                    d = ScaleDecision("scale_up", "decode", "burn_rate",
                                      worst, self.up_burn)
                elif pressure >= self.up_queue_per_worker:
                    d = ScaleDecision("scale_up", "decode", "outstanding",
                                      pressure, self.up_queue_per_worker)
            if (d is None and inputs.decode_replicas > self.min_replicas
                    and worst <= self.down_burn
                    and pressure <= self.down_queue_per_worker):
                d = ScaleDecision("scale_down", "decode", "burn_rate",
                                  worst, self.down_burn)
            if d is not None:
                out.append(d)
                self.note_action("decode", inputs.now)

        return out

    def config(self) -> dict:
        """JSON-safe view for the /controlz journal."""
        return {
            "policy": type(self).__name__,
            "min_prefill": self.min_prefill,
            "max_prefill": self.max_prefill,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "up_burn": self.up_burn,
            "down_burn": self.down_burn,
            "up_queue_per_worker": self.up_queue_per_worker,
            "down_queue_per_worker": self.down_queue_per_worker,
            "cooldown_s": self.cooldown_s,
        }
