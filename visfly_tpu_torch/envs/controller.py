"""Controllers usable outside an env (counterpart of
``visfly_tpu/envs/controller.py``): a normalised command in [-1, 1]⁴ → the
per-rotor desired thrusts of one control mode."""
from __future__ import annotations

import dataclasses

from torch import Tensor

from ..core.types import ActionType
from ..dynamics import DroneConfig, DroneParams, DynState
from ..dynamics.dynamics import _de_normalize, _thrust_from_cmd


class Controller:
    action_type: ActionType = ActionType.BODYRATE

    def __init__(self, config: DroneConfig, params: DroneParams):
        if config.action_type != self.action_type:
            config = dataclasses.replace(config, action_type=self.action_type)
        self.config = config
        self.params = params

    def __call__(self, state: DynState, action: Tensor) -> Tensor:
        command = _de_normalize(self.config, self.params, action)
        return _thrust_from_cmd(self.config, self.params, state, command)


class ThrustController(Controller):
    action_type = ActionType.THRUST


class BodyrateController(Controller):
    action_type = ActionType.BODYRATE


class VelocityController(Controller):
    action_type = ActionType.VELOCITY


class PositionController(Controller):
    action_type = ActionType.POSITION
