"""The port's training substrate: AdamW, the train step and checkpoints
(``src/repro/training/`` on PyTorch)."""
from .optimizer import AdamWState, adamw_init, adamw_update, cosine_lr
from .train import TrainState, make_train_step, train_state_init

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "TrainState", "make_train_step", "train_state_init"]
