"""The port's training substrate: AdamW, the train step and checkpoints
(``src/repro/training/`` on PyTorch), and the step captured as a CUDA
graph (``GraphedTrainStep``, the counterpart of ``jax.jit`` of it)."""
from .graphed import GraphedTrainStep
from .optimizer import AdamWState, adamw_init, adamw_update, cosine_lr
from .train import TrainState, make_train_step, train_state_init

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "GraphedTrainStep", "TrainState", "make_train_step",
           "train_state_init"]
