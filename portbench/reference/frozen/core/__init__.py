# Frozen copy of visfly_tpu_torch/core/__init__.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
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
