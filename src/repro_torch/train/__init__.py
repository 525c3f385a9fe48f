"""Training of the port: AdamW, synthetic data, checkpoints and the
trainer (the reference's ``train`` package, at SP degree 1)."""
from . import checkpoint
from .data import SyntheticStream
from .optimizer import AdamWConfig, AdamWState, adamw_update, init_adamw
from .trainer import Trainer, make_train_step

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "SyntheticStream",
    "Trainer",
    "adamw_update",
    "checkpoint",
    "init_adamw",
    "make_train_step",
]
