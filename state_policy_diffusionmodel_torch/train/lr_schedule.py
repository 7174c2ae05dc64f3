"""ReduceLROnPlateau + lr-based early stopping.

A copy of `state_policy_diffusionmodel_tpu/train/lr_schedule.py`. The
reference couples `torch.optim.lr_scheduler.ReduceLROnPlateau(patience=5)`
on val_loss with a Lightning EarlyStopping callback watching the *learning
rate*: an idiosyncratic "stop once the plateau scheduler has decayed"
trick. Both are host-side state here; the trainer sets the lr on the
optimizer before every step.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ReduceLROnPlateau:
    """torch semantics: mode='min', threshold 1e-4 relative."""

    lr: float
    factor: float = 0.1
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = float("inf")
    num_bad: int = 0

    def update(self, metric: float) -> float:
        """Call once per validation; returns the (possibly decayed) lr."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr


def should_early_stop(lr: float, stopping_threshold: float = 1e-4) -> bool:
    """The reference's EarlyStopping(monitor='lr', stopping_threshold=1e-4).
    Lightning's monitor_op is a STRICT less-than, so the default initial lr
    of exactly 1e-4 does not stop training; only a plateau decay below it
    does. (Lightning also stops after patience=n_epochs//10 val checks
    without lr improvement: see Trainer.fit's wait counter.)"""
    return lr < stopping_threshold
