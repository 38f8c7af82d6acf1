"""Learning-rate schedules with warmup (ported from
progen_tpu/train/schedule.py, with optax's schedule formulas written out).

Schedules step once per OPTIMIZER step: under gradient accumulation the
optimizer's inner count advances once per effective batch, so
``warmup_steps`` and ``decay_steps`` count effective steps.
"""

from __future__ import annotations

import math
from typing import Callable

SCHEDULES = ("constant", "cosine", "linear")

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``: ``init`` to ``end`` over ``steps``, then
    ``end``; constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax ``cosine_decay_schedule`` with exponent 1."""

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax ``join_schedules``: ``second`` counts from the boundary."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(name: str, base_lr: float, *, warmup_steps: int = 0,
                     decay_steps: int | None = None,
                     min_lr_ratio: float = 0.1) -> float | Schedule:
    """Build a learning-rate schedule.

    * ``"constant"``: ``base_lr``, with an optional linear warmup from 0
      over ``warmup_steps``;
    * ``"cosine"``: linear warmup to ``base_lr``, then cosine decay to
      ``base_lr * min_lr_ratio`` at ``decay_steps``;
    * ``"linear"``: linear warmup, then linear decay to the same floor.

    ``decay_steps`` (total optimizer steps, warmup included) is required for
    cosine and linear.  The no-warmup constant case is a plain float.
    """
    if name not in SCHEDULES:
        raise ValueError(f"unknown lr schedule {name!r}; pick from {SCHEDULES}")
    if name == "constant":
        if warmup_steps <= 0:
            return base_lr
        return _linear(0.0, base_lr, warmup_steps)
    if decay_steps is None:
        raise ValueError(
            f"lr schedule {name!r} needs decay_steps (total optimizer steps); "
            "pass --schedule_steps or set max_steps")
    if decay_steps <= warmup_steps:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed "
                         f"warmup_steps ({warmup_steps})")
    end_value = base_lr * min_lr_ratio
    warmup = _linear(0.0, base_lr, warmup_steps)
    if name == "cosine":
        alpha = 0.0 if base_lr == 0.0 else end_value / base_lr
        decay = _cosine(base_lr, decay_steps - warmup_steps, alpha)
    else:
        decay = _linear(base_lr, end_value, decay_steps - warmup_steps)
    return _join(warmup, decay, warmup_steps)


def lr_at(schedule: float | Schedule, step: int) -> float:
    """The lr at an optimizer step."""
    return float(schedule(step)) if callable(schedule) else float(schedule)
