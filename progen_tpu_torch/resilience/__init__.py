"""Fault injection and the transient/fatal classifier behind the serving
engine's containment (ported from progen_tpu/resilience)."""

from progen_tpu_torch.resilience import faults
from progen_tpu_torch.resilience.retry import RetryError, default_classifier

__all__ = ["faults", "RetryError", "default_classifier"]
