from .base import CollisionInfo, DroneGymEnv, EnvState, StepOutput
from .navigation import NavigationEnv, NavigationEnv2

__all__ = [
    "DroneGymEnv",
    "EnvState",
    "StepOutput",
    "CollisionInfo",
    "NavigationEnv",
    "NavigationEnv2",
]
