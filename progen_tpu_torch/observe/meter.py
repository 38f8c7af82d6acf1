"""Throughput metering and the profiler hook (ported from
progen_tpu/observe/meter.py).

:class:`ThroughputMeter` is copied without JAX; its per-chip rate divides
by ``chips``, the ranks that share the ticked tokens (one per card).  :func:`profile_trace`
records a ``torch.profiler`` trace (CPU and, on a card, CUDA activity) of
the enclosed steps and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


class ThroughputMeter:
    """Tokens/sec (global and per-chip) over a sliding window of SYNC
    points.

    Call ``tick(tokens)`` only at host-sync boundaries (after blocking on a
    fetched metric), passing the number of tokens processed SINCE THE
    PREVIOUS TICK.  Ticking per asynchronously launched step times the
    enqueue, not the execution.
    """

    def __init__(self, window: int = 50, chips: int = 1):
        self._window = window
        self._chips = chips
        self._anchor: float | None = None
        # (duration, tokens, steps) per sync interval — durations are
        # stored, not absolute times, so rebase() can cut hook time out of
        # the middle of the window; the deque's maxlen IS the window
        self._intervals: deque[tuple[float, int, int]] = deque(maxlen=window)

    def tick(self, tokens: int, steps: int = 0) -> None:
        """Close the current interval: ``tokens`` (and optionally ``steps``
        — optimizer steps, for the superstep loop where one sync covers K
        of them) processed since the previous tick."""
        now = time.perf_counter()
        if self._anchor is not None:
            self._intervals.append((now - self._anchor, tokens, steps))
        # the first-ever tick only opens the clock: its tokens include
        # compile time and are never rated
        self._anchor = now

    def rebase(self) -> None:
        """Restart the current interval's clock, excluding the time since
        the last tick.  Call after non-training work (validation, sampling,
        checkpoint writes): the meter reports TRAIN-step throughput — the
        BASELINE.md metric — not wall-clock including hooks."""
        self._anchor = time.perf_counter()

    @property
    def tokens_per_sec(self) -> float | None:
        if not self._intervals:
            return None
        dt = sum(d for d, _, _ in self._intervals)
        toks = sum(t for _, t, _ in self._intervals)
        return toks / dt if dt > 0 else None

    @property
    def steps_per_sec(self) -> float | None:
        """Optimizer steps/sec over the window; None until a tick has
        carried a step count (the per-step loop rates tokens only)."""
        if not self._intervals:
            return None
        dt = sum(d for d, _, _ in self._intervals)
        steps = sum(s for _, _, s in self._intervals)
        if dt <= 0 or steps == 0:
            return None
        return steps / dt

    @property
    def tokens_per_sec_per_chip(self) -> float | None:
        rate = self.tokens_per_sec
        return None if rate is None else rate / self._chips

    def snapshot(self) -> dict:
        """Flat dict of the current rates, for publishing into the metrics
        registry (``observe.metrics``) or a log record."""
        return {
            "tokens_per_sec": self.tokens_per_sec,
            "steps_per_sec": self.steps_per_sec,
            "tokens_per_sec_per_chip": self.tokens_per_sec_per_chip,
            "window": self._window,
            "intervals": len(self._intervals),
        }


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """``with profile_trace('traces'):`` records a ``torch.profiler``
    trace of the enclosed steps into ``logdir/trace.json`` (Chrome trace
    format); a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
