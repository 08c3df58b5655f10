"""Training: the two-phase DGDM trainer and its losses."""

from .trainer import DGDMTrainer, TrainerConfig, make_lr_schedule, make_optimizer

__all__ = ["DGDMTrainer", "TrainerConfig", "make_lr_schedule", "make_optimizer"]
