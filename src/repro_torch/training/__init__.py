from .train_step import TrainConfig, make_train_step, init_train_state
from . import grad_compression

__all__ = ["TrainConfig", "make_train_step", "init_train_state",
           "grad_compression"]
