"""Tracking a circular reference trajectory (counterpart of
``visfly_tpu/envs/tracking.py``). The waypoints are a function of the
dynamics clock ``t``, which a partial reset draws at random, so agents start
at random points of the circle."""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import Tensor

from ..core.math_utils import safe_norm
from ..dynamics import dynamics as dyn_mod
from .base import DroneGymEnv, EnvState


class TrackEnv(DroneGymEnv):
    """A circle of radius 2 about (2, 0, 1); the observation holds the next
    10 waypoints relative to the drone."""

    def __init__(self, *args, random_kwargs=None, max_episode_steps: int = 256, **kwargs):
        self.next_points_num = 10
        self.radius = 2.0
        self.waypoint_dt = 0.1
        self.radius_spd = 0.2 * math.pi
        random_kwargs = random_kwargs or {"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [2.0, 0.0, 1.0], "half": [0.2, 0.2, 0.2]}}]}}
        super().__init__(*args, random_kwargs=random_kwargs,
                         max_episode_steps=max_episode_steps, **kwargs)
        self.center = torch.tensor([2.0, 0.0, 1.0], device=self.device)
        self.success_radius = 0.5

    def waypoints(self, t: Tensor) -> Tensor:
        """(N, next_points_num, 3) samples of the circle from the clock on."""
        ts = t[:, None] + torch.arange(self.next_points_num, device=t.device) * self.waypoint_dt
        ang = self.radius_spd * ts
        return torch.stack([self.radius * torch.cos(ang) + self.center[0],
                            self.radius * torch.sin(ang) + self.center[1],
                            torch.zeros_like(ang) + self.center[2]], dim=-1)

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        s = self.state_obs(state)
        diff = (self.waypoints(state.dyn.t) - state.dyn.pos[:, None, :]).reshape(
            self.num_envs, -1)
        obs = {"state": torch.cat([diff / self.max_sense_radius, s[:, 3:7], s[:, 7:10] / 10.0,
                                   s[:, 10:13] / 10.0], dim=-1)}
        if "depth" in sensor_obs:
            obs["depth"] = torch.clamp(sensor_obs["depth"] / 10.0, max=1.0)
        return obs

    def get_reward(self, state: EnvState) -> Tensor:
        """Hover-style shaping toward the current waypoint."""
        target0 = self.waypoints(state.dyn.t)[:, 0, :]
        q_ref = state.dyn.q.new_tensor([1.0, 0.0, 0.0, 0.0])
        return (
            0.1
            + safe_norm(state.dyn.pos - target0, dim=-1) * (-0.1 / 9)
            + safe_norm(state.dyn.q - q_ref, dim=-1) * -0.00001
            + safe_norm(dyn_mod.velocity(state.dyn), dim=-1) * -0.002
            + safe_norm(state.dyn.omega, dim=-1) * -0.002
        )


class TrackEnv2(TrackEnv):
    """TrackEnv with a 64×64 depth camera."""

    def __init__(self, *args, sensor_kwargs=None, **kwargs):
        sensor_kwargs = [{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}]
        super().__init__(*args, sensor_kwargs=sensor_kwargs, **kwargs)
