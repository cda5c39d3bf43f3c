"""Hover task: stay at a fixed target point (counterpart of
``visfly_tpu/envs/hover.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from ..core.math_utils import safe_norm
from ..dynamics import dynamics as dyn_mod
from .base import DroneGymEnv, EnvState


class HoverEnv(DroneGymEnv):
    """State-only hover; success is always False, so episodes run to the
    timeout."""

    def __init__(self, *args, target: Optional[Tensor] = None, max_episode_steps: int = 256,
                 **kwargs):
        kwargs.setdefault("visual", False)
        super().__init__(*args, max_episode_steps=max_episode_steps, **kwargs)
        t = torch.as_tensor([1.0, 0.0, 1.5] if target is None else target, dtype=self.dtype,
                            device=self.device)
        self.target = t.reshape(1, -1).repeat(self.num_envs, 1)
        self.success_radius = 0.5

    def default_random_kwargs(self) -> dict:
        return {
            "state_generator": {
                "class": "Uniform",
                "kwargs": [{"position": {"mean": [1.0, 0.0, 1.5], "half": [1.0, 1.0, 0.5]}}],
            }
        }

    def get_reward(self, state: EnvState) -> Tensor:
        q_ref = state.dyn.q.new_tensor([1.0, 0.0, 0.0, 0.0])
        return (
            0.1
            + safe_norm(state.dyn.pos - self.target, dim=-1) * (-0.1 * 1.0 / 9)
            + safe_norm(state.dyn.q - q_ref, dim=-1) * -0.00001
            + safe_norm(dyn_mod.velocity(state.dyn), dim=-1) * -0.002
            + safe_norm(state.dyn.omega, dim=-1) * -0.002
        )


class HoverEnv2(HoverEnv):
    """Normalised relative-state observation with a 64×64 depth sensor."""

    def __init__(self, *args, sensor_kwargs=None, **kwargs):
        sensor_kwargs = [{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}]
        super().__init__(*args, sensor_kwargs=sensor_kwargs, **kwargs)

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        s = self.state_obs(state)
        pos, q, vel, omega = s[:, :3], s[:, 3:7], s[:, 7:10], s[:, 10:13]
        obs = {"state": torch.cat([(self.target - pos) / 10.0, q, vel / 10.0, omega / 10.0],
                                  dim=-1)}
        if "depth" in sensor_obs:
            obs["depth"] = torch.clamp(sensor_obs["depth"] / 10.0, max=1.0)
        return obs
