from . import constants
from .car import (
    CarState,
    apply_action,
    apply_brake,
    apply_gas,
    apply_steer,
    create,
    hull_com_velocity,
    load_pickled_states,
    restore_state,
    save_state,
    stack_states,
    step,
)

__all__ = [
    "constants", "CarState", "create", "step", "apply_action", "apply_gas",
    "apply_brake", "apply_steer", "save_state", "restore_state",
    "hull_com_velocity", "load_pickled_states", "stack_states",
]
