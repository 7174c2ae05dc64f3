from .pid import (
    PIDParams, PIDState, RingBuffer, pid_init, pid_params, pid_update,
    ring_init, ring_mean, ring_push,
)
from .drivers import (
    MODES, LaneFollowParams, LaneFollowState, center_follow, lane_follow,
    lane_follow_init, lane_follow_params, sinusoidal,
)

__all__ = [
    "PIDParams", "PIDState", "pid_params", "pid_init", "pid_update",
    "RingBuffer", "ring_init", "ring_push", "ring_mean",
    "MODES", "LaneFollowParams", "LaneFollowState", "lane_follow",
    "lane_follow_init", "lane_follow_params", "center_follow", "sinusoidal",
]
