from . import integrator, quaternion
from .types import ACTION_TYPE_ALIAS, ActionType, Bound

__all__ = [
    "quaternion",
    "integrator",
    "ActionType",
    "ACTION_TYPE_ALIAS",
    "Bound",
]
