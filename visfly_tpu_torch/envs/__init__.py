from .base import CollisionInfo, DroneGymEnv, EnvState, StepOutput
from .hover import HoverEnv, HoverEnv2
from .landing import LandingAux, LandingEnv, LandingEnv2, image_center_of_mass
from .navigation import NavigationEnv, NavigationEnv2

__all__ = [
    "DroneGymEnv",
    "EnvState",
    "StepOutput",
    "CollisionInfo",
    "NavigationEnv",
    "NavigationEnv2",
    "HoverEnv",
    "HoverEnv2",
    "LandingAux",
    "LandingEnv",
    "LandingEnv2",
    "image_center_of_mass",
]
