from . import rollout, suite
from .rollout import hold_actions, interpolate_actions, replay, replay_batch
from .suite import (
    EvalContext, action_consistency, compare_position_actions,
    position_accuracy, position_consistency, precision, robustness, smoke,
)

__all__ = [
    "rollout", "suite", "EvalContext", "interpolate_actions", "hold_actions",
    "replay", "replay_batch", "position_consistency", "position_accuracy",
    "precision", "action_consistency", "robustness",
    "compare_position_actions", "smoke",
]
