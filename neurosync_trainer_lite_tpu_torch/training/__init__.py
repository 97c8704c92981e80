from neurosync_trainer_lite_tpu_torch.training.optim import (
    lr_factor,
    make_optimizer,
)
from neurosync_trainer_lite_tpu_torch.training.step import (
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
)
from neurosync_trainer_lite_tpu_torch.training.loop import train_model

__all__ = [
    "make_optimizer",
    "lr_factor",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "make_eval_step",
    "train_model",
]
