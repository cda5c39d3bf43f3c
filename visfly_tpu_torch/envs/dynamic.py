"""Hover amid moving obstacles (counterpart of ``visfly_tpu/envs/dynamic.py``):
a hover reward at the origin, with dynamic objects from
``scene_kwargs["obj_settings"]``."""
from __future__ import annotations

from typing import Dict

from torch import Tensor

from ..core.math_utils import safe_norm
from ..dynamics import dynamics as dyn_mod
from .base import DroneGymEnv, EnvState


class DynEnv(DroneGymEnv):
    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        obs = {"state": self.state_obs(state)}
        if "depth" in sensor_obs:
            obs["depth"] = sensor_obs["depth"]
        return obs

    def get_reward(self, state: EnvState) -> Tensor:
        q_ref = state.dyn.q.new_tensor([1.0, 0.0, 0.0, 0.0])
        return (
            0.1
            + safe_norm(state.dyn.pos, dim=-1) * (-0.1 / 9)
            + safe_norm(state.dyn.q - q_ref, dim=-1) * -0.00001
            + safe_norm(dyn_mod.velocity(state.dyn), dim=-1) * -0.002
            + safe_norm(state.dyn.omega, dim=-1) * -0.002
        )
