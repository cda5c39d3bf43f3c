from .config import GRAVITY, DroneConfig, DroneParams, make_drone_params
from .dynamics import (
    DynState,
    direction,
    extend_state,
    full_state,
    get_state,
    init_state,
    reset,
    step,
    velocity,
)

__all__ = [
    "GRAVITY",
    "DroneConfig",
    "DroneParams",
    "make_drone_params",
    "DynState",
    "init_state",
    "reset",
    "step",
    "get_state",
    "full_state",
    "extend_state",
    "velocity",
    "direction",
]
