from progen_tpu_torch.core.device import resolve_device
from progen_tpu_torch.core.precision import Policy, make_policy

__all__ = ["Policy", "make_policy", "resolve_device"]
