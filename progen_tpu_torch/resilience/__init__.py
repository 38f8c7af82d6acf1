"""Fault injection, the retry layer and the stall watchdog (ported from
progen_tpu/resilience)."""

from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import (
    RetryError,
    RetryPolicy,
    default_classifier,
    retriable,
    retry_call,
)
from progen_tpu_torch.resilience.watchdog import FlightRecorder, Watchdog

__all__ = ["faults", "FlightRecorder", "RetryError", "RetryPolicy", "Watchdog",
           "default_classifier", "retriable", "retry_call"]
