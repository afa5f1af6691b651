"""Training: the train step and the Trainer loop (the JAX package's ``train/``)."""

from .step import TrainCfg, make_train_step, state_shardings, value_and_grad
from .trainer import Trainer

__all__ = ["make_train_step", "value_and_grad", "state_shardings", "TrainCfg", "Trainer"]
