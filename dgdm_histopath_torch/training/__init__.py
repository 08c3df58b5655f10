"""Training: the two-phase DGDM trainer, its losses, checkpoints,
preemption handling and experiment logging."""

from .checkpoint import CheckpointManager, load_model_bundle, save_model_bundle
from .experiment_logging import TrainLogger, make_logger
from .preemption import PreemptionGuard, skip_batches
from .trainer import DGDMTrainer, TrainerConfig, make_lr_schedule, make_optimizer

__all__ = ["CheckpointManager", "DGDMTrainer", "PreemptionGuard", "TrainLogger",
           "TrainerConfig", "load_model_bundle", "make_logger", "make_lr_schedule",
           "make_optimizer", "save_model_bundle", "skip_batches"]
