from progen_tpu_torch.observe.flops import (
    H100_PEAK_BF16_FLOPS,
    mfu,
    model_flops_per_token,
)

__all__ = ["H100_PEAK_BF16_FLOPS", "mfu", "model_flops_per_token"]
