"""Training of the port: the multi-resolution STFT loss, the optimizer,
the Trainer and its loggers."""
from .logging import ConsoleLogger, CSVLogger
from .loss import multi_resolution_stft_loss, stft_loss
from .trainer import (
    Optimizer,
    TrainConfig,
    Trainer,
    clip_by_global_norm_,
    compute_loss,
    make_lr_schedule,
    step_generator,
    train_step,
)

__all__ = [
    "ConsoleLogger",
    "CSVLogger",
    "multi_resolution_stft_loss",
    "stft_loss",
    "Optimizer",
    "TrainConfig",
    "Trainer",
    "clip_by_global_norm_",
    "compute_loss",
    "make_lr_schedule",
    "step_generator",
    "train_step",
]
