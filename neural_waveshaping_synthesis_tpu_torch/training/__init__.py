"""Training of the port: the multi-resolution STFT loss, the optimizer,
the Trainer, its checkpoints and its loggers."""
from .logging import ConsoleLogger, CSVLogger, WandbLogger
from .loss import multi_resolution_stft_loss, stft_loss
from .trainer import (
    Optimizer,
    TrainConfig,
    Trainer,
    checkpoint_index,
    clip_by_global_norm_,
    compute_loss,
    make_lr_schedule,
    select_eval_checkpoint,
    step_generator,
    train_step,
)

__all__ = [
    "ConsoleLogger",
    "CSVLogger",
    "WandbLogger",
    "multi_resolution_stft_loss",
    "stft_loss",
    "Optimizer",
    "TrainConfig",
    "Trainer",
    "checkpoint_index",
    "clip_by_global_norm_",
    "compute_loss",
    "make_lr_schedule",
    "select_eval_checkpoint",
    "step_generator",
    "train_step",
]
