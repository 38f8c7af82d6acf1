from progen_tpu_torch.models.configs import CONFIGS
from progen_tpu_torch.models.progen import ProGen, ProGenConfig

__all__ = ["CONFIGS", "ProGen", "ProGenConfig"]
