from .base import CollisionInfo, DroneGymEnv, EnvState, StepOutput
from .catch import BallState, CatchEnv
from .controller import (BodyrateController, Controller, PositionController, ThrustController,
                         VelocityController)
from .dynamic import DynEnv
from .hover import HoverEnv, HoverEnv2
from .landing import LandingAux, LandingEnv, LandingEnv2, image_center_of_mass
from .multi import MultiDroneGymEnv, MultiNavigationEnv
from .navigation import NavigationEnv, NavigationEnv2
from .racing import RacingAux, RacingEnv, RacingEnv2
from .tracking import TrackEnv, TrackEnv2

ENV_ALIASES = {
    "hover": HoverEnv,
    "hover2": HoverEnv2,
    "navigation": NavigationEnv,
    "navigation2": NavigationEnv2,
    "racing": RacingEnv,
    "racing2": RacingEnv2,
    "tracking": TrackEnv,
    "tracking2": TrackEnv2,
    "landing": LandingEnv,
    "landing2": LandingEnv2,
    "catch": CatchEnv,
    "dynamic": DynEnv,
    "multi_navigation": MultiNavigationEnv,
}

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
    "RacingAux",
    "RacingEnv",
    "RacingEnv2",
    "TrackEnv",
    "TrackEnv2",
    "BallState",
    "CatchEnv",
    "DynEnv",
    "MultiDroneGymEnv",
    "MultiNavigationEnv",
    "Controller",
    "ThrustController",
    "BodyrateController",
    "VelocityController",
    "PositionController",
    "ENV_ALIASES",
]
