from . import autoencoder, checkpoints, loop
from .autoencoder import train_autoencoder
from .checkpoints import latest_checkpoint, load_hparams, load_run, load_stats
from .loop import (
    Optimizer, TrainConfig, Trainer, ema_update, make_eval_step,
    make_optimizer, make_train_step,
)
from .lr_schedule import ReduceLROnPlateau, should_early_stop
from .sample_viz import make_sample_hook

__all__ = ["autoencoder", "train_autoencoder", "checkpoints", "loop",
           "latest_checkpoint", "load_hparams", "load_run", "load_stats", "Optimizer", "TrainConfig", "Trainer",
           "ema_update", "make_eval_step", "make_optimizer",
           "make_train_step", "ReduceLROnPlateau", "should_early_stop",
           "make_sample_hook"]
