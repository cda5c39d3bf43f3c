"""Navigation task: fly to a target through (cluttered) space (counterpart
of ``visfly_tpu/envs/navigation.py``)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from ..core.math_utils import safe_norm
from ..dynamics import dynamics as dyn_mod
from .base import DroneGymEnv, EnvState


def get_along_vertical_vector(base: Tensor, obj: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Decompose ``obj`` into components along / perpendicular to ``base``.
    Returns (along, vertical_norm, base_norm)."""
    base_norm = safe_norm(base, dim=1, keepdim=True)
    base_normal = base / (base_norm + 1e-8)
    along = torch.sum(obj * base_normal, dim=1, keepdim=True)
    vertical = obj - base_normal * along
    return along.squeeze(-1), safe_norm(vertical, dim=1), base_norm.squeeze(-1)


class _TargetEnv(DroneGymEnv):
    """Shared target and success test of the navigation envs."""

    default_target = (9.0, 0.0, 1.0)

    def __init__(self, *args, target: Optional[Tensor] = None, max_episode_steps: int = 256,
                 **kwargs):
        super().__init__(*args, max_episode_steps=max_episode_steps, **kwargs)
        t = torch.as_tensor(self.default_target if target is None else target,
                            dtype=self.dtype, device=self.device)
        self.target = t.reshape(1, -1).repeat(self.num_envs, 1)
        self.success_radius = 0.5

    def get_success(self, state: EnvState) -> Tensor:
        return safe_norm(state.dyn.pos - self.target, dim=-1) <= self.success_radius


class NavigationEnv(_TargetEnv):
    """Depth + state + target navigation. ``indiv_reward=True`` returns the
    reward as its named terms, which the base env logs in
    ``info["extra_<term>"]``."""

    def __init__(self, *args, indiv_reward: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.indiv_reward = bool(indiv_reward)

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        obs = {"state": self.state_obs(state), "target": self.target}
        if "depth" in sensor_obs:
            obs["depth"] = sensor_obs["depth"]
        return obs

    def get_reward(self, state: EnvState):
        """Approach-velocity + view-cone + collision-potential shaping with a
        remaining-steps success bonus; a dict of the terms and their total
        under ``"reward"`` with ``indiv_reward``."""
        pos = state.dyn.pos
        vel = dyn_mod.velocity(state.dyn)
        omega = state.dyn.omega
        direction = dyn_mod.direction(state.dyn)
        to_target = self.target - pos
        dis = safe_norm(to_target, dim=-1)
        col_dis = state.collision.dis
        col_vec = state.collision.vector
        thrd_perce = math.pi / 18
        q_ref = state.dyn.q.new_tensor([1.0, 0.0, 0.0, 0.0])
        vel_norm = safe_norm(vel, dim=-1)

        approach = torch.clamp(torch.sum(vel * to_target, dim=-1) / (1e-6 + dis), max=10.0)
        view_cos = torch.clamp(torch.sum(direction * vel, dim=-1) / (1e-6 + vel_norm), -1.0, 1.0)
        view_pen = torch.clamp(torch.arccos(view_cos), min=thrd_perce) - thrd_perce
        col_closing = torch.clamp(torch.sum(col_vec * vel, dim=-1) / (1e-6 + col_dis), min=0.0)

        terms = {
            "approach": approach * 0.01,
            "view": view_pen * -0.01,
            "upright": safe_norm(state.dyn.q - q_ref, dim=-1) * -0.00001,
            "vel": vel_norm * -0.002,
            "omega": safe_norm(omega, dim=-1) * -0.002,
            "col_dis": 1.0 / (col_dis + 0.2) * -0.01,
            "col_closing": torch.clamp(1.0 - col_dis, min=0.0) * col_closing * -0.005,
            # success bonus scaled by the remaining steps
            "success": state.success * (self.max_episode_steps - state.step_count) * 0.1
            * (0.2 + 0.8 / (1.0 + vel_norm)),
        }
        total = sum(terms.values())
        if self.indiv_reward:
            return {"reward": total, **terms}
        return total


class NavigationEnv2(_TargetEnv):
    """Relative-state navigation with a collision-vector observation."""

    default_target = (14.0, 0.0, 1.0)

    def default_random_kwargs(self) -> dict:
        return {
            "state_generator": {
                "class": "Uniform",
                "kwargs": [{"position": {"mean": [9.0, 0.0, 1.5], "half": [8.0, 6.0, 1.0]}}],
            }
        }

    def get_failure(self, state: EnvState) -> Tensor:
        return state.collision.is_collision

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        s = self.state_obs(state)
        pos, q, vel, omega = s[:, :3], s[:, 3:7], s[:, 7:10], s[:, 10:13]
        obs = {
            "state": torch.cat([self.target - pos, q, vel, omega], dim=-1),
            "collision_vector": state.collision.vector,
        }
        if "depth" in sensor_obs:
            obs["depth"] = torch.clamp(sensor_obs["depth"] / 10.0, max=1.0)
        return obs

    def get_reward(self, state: EnvState) -> Tensor:
        """Target-approach speed + ω penalty + success bonus."""
        vel = dyn_mod.velocity(state.dyn)
        approach, away, _dis = get_along_vertical_vector(self.target - state.dyn.pos, vel)
        return ((approach - away) * 0.02 + safe_norm(state.dyn.omega, dim=-1) * -0.001
                + state.success * 1.0)

    def get_analytical_reward(self, state: EnvState) -> Tensor:
        """The differentiable reward the analytic policy gradient trains on:
        obstacle approach speed and distance, target approach speed, view
        cone, ω, collision and success."""
        vel = dyn_mod.velocity(state.dyn)
        direction = dyn_mod.direction(state.dyn)
        thrd_perce = math.pi / 18
        approach, away, _ = get_along_vertical_vector(self.target - state.dyn.pos, vel)
        obs_approach, _obs_away, col_dis = get_along_vertical_vector(state.collision.vector, vel)
        obstacle_spd_r = obs_approach * -0.1 * torch.clamp(1.0 - col_dis, min=0.0)
        obstacle_dis_r = 1.0 / (col_dis + 0.03) * -0.02
        target_spd_r = (approach - away) * 0.02
        vel_norm = safe_norm(vel, dim=-1)
        view_cos = torch.clamp(torch.sum(direction * vel, dim=-1) / (1e-6 + vel_norm), -1.0, 1.0)
        view_aware_r = torch.clamp(torch.arccos(view_cos) - thrd_perce, min=0.0) * -0.01
        return (obstacle_spd_r + target_spd_r + view_aware_r + obstacle_dis_r
                + safe_norm(state.dyn.omega, dim=-1) * -0.01
                + state.collision.is_collision * -2.0
                + state.success * 5.0)
