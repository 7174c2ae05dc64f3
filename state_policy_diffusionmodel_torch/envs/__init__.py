from . import car_racing, vector
from .car_racing import (
    EnvState, StepInfo, StepResult, auto_reset, init, physics_step, reset,
    reset_car, step,
)

__all__ = [
    "car_racing", "vector", "EnvState", "StepInfo", "StepResult", "init",
    "reset", "step", "physics_step", "reset_car", "auto_reset",
]
