"""Landing task: land on a visual pad (counterpart of
``visfly_tpu/envs/landing.py``). ``LandingEnv`` looks down through a colour
camera and locates the pad by the centre of mass of the thresholded image;
``LandingEnv2`` is the state-only variant with exponential descent shaping.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import Tensor

from ..core.math_utils import safe_norm
from ..dynamics import dynamics as dyn_mod
from .base import DroneGymEnv, EnvState

_SPAWN = {"state_generator": {"class": "Uniform", "kwargs": [
    {"position": {"mean": [2.0, 0.0, 2.5], "half": [1.0, 1.0, 1.0]}}]}}


class LandingAux(NamedTuple):
    centers: Tensor  # (N, 2) pad centre in normalised image coordinates
    seen: Tensor  # (N,) bool: pad observed at least once this episode


def image_center_of_mass(mask: Tensor) -> Tensor:
    """Centre of mass of boolean images (N, H, W) → (N, 2) in pixel
    coordinates (row, col). An empty mask gives the sentinel −1e9, not NaN."""
    _, h, w = mask.shape
    m = mask.to(torch.float32)
    total = m.sum(dim=(1, 2))
    rows = torch.arange(h, dtype=torch.float32, device=mask.device)[None, :, None]
    cols = torch.arange(w, dtype=torch.float32, device=mask.device)[None, None, :]
    r = (m * rows).sum(dim=(1, 2)) / torch.clamp(total, min=1e-9)
    c = (m * cols).sum(dim=(1, 2)) / torch.clamp(total, min=1e-9)
    return torch.where(total[:, None] > 0, torch.stack([r, c], dim=-1), -1e9)


def _landed(pos: Tensor, vel: Tensor, target_xy: Tensor) -> Tensor:
    """Low altitude, within the pad, slow."""
    half = 0.3
    within = (torch.all(pos[:, :2] < target_xy + half, dim=-1)
              & torch.all(pos[:, :2] > target_xy - half, dim=-1))
    return (pos[:, 2] <= 0.2) & within & (safe_norm(vel, dim=-1) <= 0.3)


class LandingEnv(DroneGymEnv):
    """Down-facing colour camera; the pad is tracked by the centre of mass of
    the dark pixels, which the reward needs before the auto-reset."""

    needs_sensors_for_reward = True

    def __init__(self, *args, target: Optional[Tensor] = None, random_kwargs=None,
                 sensor_kwargs=None, scene_kwargs=None, max_episode_steps: int = 128,
                 **kwargs):
        sensor_kwargs = [{
            "sensor_type": "color",
            "uuid": "color",
            "resolution": [64, 64],
            # pitch +π/2 tilts the body-x forward axis to −z
            "orientation": [0.0, math.pi / 2, 0.0],
        }]
        scene_kwargs = dict(scene_kwargs or {})
        scene_kwargs.setdefault("path", "garage_landing")
        kwargs.setdefault("visual", True)
        super().__init__(*args, random_kwargs=random_kwargs or _SPAWN,
                         sensor_kwargs=sensor_kwargs, scene_kwargs=scene_kwargs,
                         max_episode_steps=max_episode_steps, **kwargs)
        self.target = torch.as_tensor([2.0, 0.0, 0.0] if target is None else target,
                                      dtype=self.dtype, device=self.device)
        self.success_radius = 0.5
        self.resolution = 64

    def init_aux(self) -> LandingAux:
        n = self.num_agent
        return LandingAux(centers=torch.zeros((n, 2), dtype=self.dtype, device=self.device),
                          seen=torch.zeros((n,), dtype=torch.bool, device=self.device))

    def reset_aux(self, state: EnvState, mask: Tensor) -> LandingAux:
        aux = state.aux
        return LandingAux(centers=torch.where(mask[:, None], 0.0, aux.centers),
                          seen=aux.seen & ~mask)

    def update_aux_from_sensors(self, state: EnvState, sensor_obs) -> EnvState:
        """Pad centre = centre of mass of the dark pixels; the previous centre
        stays when the pad leaves the view."""
        if "color" not in sensor_obs:
            return state
        two_value = sensor_obs["color"].to(torch.float32).mean(dim=1) < 70  # (N, H, W)
        com = image_center_of_mass(two_value) / self.resolution - 0.5
        valid = com[:, 0] > -1e6
        centers = torch.where(valid[:, None], com, state.aux.centers)
        return state._replace(aux=LandingAux(centers=centers, seen=state.aux.seen | valid))

    def get_failure(self, state: EnvState) -> Tensor:
        """The pad was never in view since the reset."""
        return ~state.aux.seen

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        obs = {"state": self.state_obs(state), "target": state.aux.centers}
        if "color" in sensor_obs:
            obs["color"] = sensor_obs["color"]
        return obs

    def get_success(self, state: EnvState) -> Tensor:
        return _landed(state.dyn.pos, dyn_mod.velocity(state.dyn), self.target[:2])

    def get_reward(self, state: EnvState) -> Tensor:
        """Centre tracking + descent shaping."""
        pos = state.dyn.pos
        vel_norm = safe_norm(dyn_mod.velocity(state.dyn), dim=-1)
        # the penalised orientation columns are (q_w, q_x), as in the reference
        ori_xy = safe_norm(state.dyn.q[:, 0:2], dim=-1)
        return (
            0.2 * torch.clamp(1.25 - safe_norm(state.aux.centers, dim=-1), max=1.0)
            + ori_xy * -0.2
            + 0.1 * torch.clamp(3.0 - pos[:, 2], 0.0, 3.0) / 3.0 * 2.0
            + -0.02 * vel_norm
            + -0.01 * safe_norm(state.dyn.omega, dim=-1)
            + 0.1 * 20 * state.success
            * (10 + (self.max_episode_steps - state.step_count))
            / (1 + 2 * vel_norm)
        )


class LandingEnv2(DroneGymEnv):
    """State-only landing with exponentially shaped descent and xy rewards."""

    def __init__(self, *args, target: Optional[Tensor] = None, random_kwargs=None,
                 max_episode_steps: int = 128, **kwargs):
        kwargs.setdefault("visual", False)
        super().__init__(*args, random_kwargs=random_kwargs or _SPAWN,
                         max_episode_steps=max_episode_steps, **kwargs)
        t = torch.as_tensor([2.0, 0.0, 2.5] if target is None else target, dtype=self.dtype,
                            device=self.device)
        self.target = t.reshape(1, -1).repeat(self.num_envs, 1)
        self.success_radius = 0.5

    def get_failure(self, state: EnvState) -> Tensor:
        return state.collision.is_collision

    def get_success(self, state: EnvState) -> Tensor:
        return _landed(state.dyn.pos, dyn_mod.velocity(state.dyn), self.target[:, :2])

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        s = self.state_obs(state)
        return {"state": torch.cat([(self.target - s[:, :3]) / self.max_sense_radius,
                                    s[:, 3:7], s[:, 7:10] / 10.0, s[:, 10:13] / 10.0], dim=-1)}

    def get_reward(self, state: EnvState) -> Tensor:
        """Exponential descent-rate + xy-approach shaping."""
        eta, rho = 1.2, 1.2
        pos = state.dyn.pos
        vel = dyn_mod.velocity(state.dyn)
        v_l = torch.clamp(pos[:, 2], 0.05, 1.0).detach()
        descent_v = -vel[:, 2]
        slow = descent_v <= v_l
        r_z = (~slow * (eta ** (-4 * descent_v / v_l + 5) - 1) / (eta - 1) * 0.1
               + slow * (eta ** (descent_v / v_l) - 1) / (eta - 1) * 0.1)
        d_s = (2.0 * torch.clamp(pos[:, 2], 0.05, 1.0)).detach()
        d_xy = safe_norm((self.target - pos)[:, :2], dim=-1)
        r_xy = (rho ** (1 - d_xy / d_s) - 1) / (rho - 1) * 0.1
        return state.success * 20.0 + state.failure * -0.1 + r_xy + r_z
