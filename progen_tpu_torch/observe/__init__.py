from progen_tpu_torch.observe.flops import (
    H100_PEAK_BF16_FLOPS,
    mfu,
    model_flops_per_token,
)
from progen_tpu_torch.observe.meter import ThroughputMeter, profile_trace
from progen_tpu_torch.observe.tracker import Tracker

__all__ = ["H100_PEAK_BF16_FLOPS", "ThroughputMeter", "Tracker", "mfu",
           "model_flops_per_token", "profile_trace"]
