from progen_tpu_torch.models.configs import CONFIGS, draft_config_for
from progen_tpu_torch.models.progen import ProGen, ProGenConfig

__all__ = ["CONFIGS", "ProGen", "ProGenConfig", "draft_config_for"]
