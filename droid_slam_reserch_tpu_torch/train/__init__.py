"""Training: the unrolled DBA training step, losses, logging, checkpoints
(mirror of the JAX package's train/), on one device."""
from .checkpoint import load_ckpt, save_ckpt
from .config import TrainConfig
from .logger import Logger
from .step import init_train_state, make_train_step, make_train_step_dynamic

__all__ = [k for k in dir() if not k.startswith("_")]
