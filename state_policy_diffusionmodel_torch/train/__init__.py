from . import checkpoints, loop
from .checkpoints import latest_checkpoint, load_hparams, load_run, load_stats
from .loop import (
    Optimizer, TrainConfig, Trainer, ema_update, make_eval_step,
    make_optimizer, make_train_step,
)
from .lr_schedule import ReduceLROnPlateau, should_early_stop

__all__ = ["checkpoints", "loop", "latest_checkpoint", "load_hparams",
           "load_run", "load_stats", "Optimizer", "TrainConfig", "Trainer",
           "ema_update", "make_eval_step", "make_optimizer",
           "make_train_step", "ReduceLROnPlateau", "should_early_stop"]
