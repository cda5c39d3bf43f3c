# Frozen copy of visfly_tpu_torch/dynamics/__init__.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
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
