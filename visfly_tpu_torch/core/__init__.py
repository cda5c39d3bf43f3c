from . import integrator, quaternion
from .types import ACTION_TYPE_ALIAS, ActionType, Bound, Normal, PID, Uniform

__all__ = [
    "quaternion",
    "integrator",
    "ActionType",
    "ACTION_TYPE_ALIAS",
    "Bound",
    "Uniform",
    "Normal",
    "PID",
]
