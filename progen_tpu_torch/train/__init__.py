from progen_tpu_torch.train.loss import batch_loss, cross_entropy, eos_from_pad_mask
from progen_tpu_torch.train.optimizer import Optimizer, OptState, make_optimizer
from progen_tpu_torch.train.schedule import SCHEDULES, lr_at, make_lr_schedule
from progen_tpu_torch.train.step import TrainFunctions, TrainState, make_train_functions

__all__ = [
    "OptState",
    "Optimizer",
    "SCHEDULES",
    "TrainFunctions",
    "TrainState",
    "batch_loss",
    "cross_entropy",
    "eos_from_pad_mask",
    "lr_at",
    "make_lr_schedule",
    "make_optimizer",
    "make_train_functions",
]
