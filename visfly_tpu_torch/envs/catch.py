"""Catch a ball in free fall (counterpart of ``visfly_tpu/envs/catch.py``).
The ball is aux state, advanced ballistically by ``ball_dt`` a step."""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch import Tensor

from ..core.math_utils import safe_norm
from ..dynamics import dynamics as dyn_mod
from .base import DroneGymEnv, EnvState

G = (0.0, 0.0, -9.8)


class BallState(NamedTuple):
    pos: Tensor  # (N, 3)
    vel: Tensor  # (N, 3)
    grounded: Tensor  # (N,) bool: z < 0.1


class CatchEnv(DroneGymEnv):
    ball_dt = 0.2

    def __init__(self, *args, max_episode_steps: int = 256, **kwargs):
        kwargs.setdefault("visual", False)
        super().__init__(*args, max_episode_steps=max_episode_steps, **kwargs)
        self.catch_radius = 0.3

    def default_random_kwargs(self) -> dict:
        return {"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [1.0, 2.0, 1.0]}}]}}

    def _sample_ball(self, gen: torch.Generator):
        """The ball's spawn: x = 1, y ∈ ±2, z ∈ 1.5 ± 1; horizontal speed
        within ±1 a component."""
        def u():
            return 2 * self._rows_draw(torch.rand, gen, (3,), self.dtype) - 1

        pos = u() * torch.tensor([0.0, 2.0, 1.0], dtype=self.dtype, device=self.device) \
            + torch.tensor([1.0, 0.0, 1.5], dtype=self.dtype, device=self.device)
        vel = u() * torch.tensor([1.0, 1.0, 0.0], dtype=self.dtype, device=self.device)
        return pos, vel

    def init_aux(self) -> BallState:
        """Placeholder zeros: the reset that follows draws every ball."""
        n = self.num_agent
        zeros = torch.zeros((n, 3), dtype=self.dtype, device=self.device)
        return BallState(zeros, zeros, torch.zeros((n,), dtype=torch.bool, device=self.device))

    def reset_aux(self, state: EnvState, mask: Tensor) -> BallState:
        aux: BallState = state.aux
        pos, vel = self._sample_ball(state.gen)
        m = mask[:, None]
        return BallState(pos=torch.where(m, pos, aux.pos), vel=torch.where(m, vel, aux.vel),
                         grounded=aux.grounded & ~mask)

    def step_aux(self, aux: BallState, dyn) -> BallState:
        pos = aux.pos + aux.vel * self.ball_dt
        vel = aux.vel + aux.vel.new_tensor(G) * self.ball_dt
        return BallState(pos=pos, vel=vel, grounded=pos[:, 2] < 0.1)

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        ball: BallState = state.aux
        return {"state": self.state_obs(state),
                "ball": torch.cat([ball.pos - state.dyn.pos, ball.vel], dim=-1)}

    def get_success(self, state: EnvState) -> Tensor:
        return safe_norm(state.aux.pos - state.dyn.pos, dim=-1) <= self.catch_radius

    def get_failure(self, state: EnvState) -> Tensor:
        return state.aux.grounded

    def get_reward(self, state: EnvState) -> Tensor:
        to_ball = state.aux.pos - state.dyn.pos
        dis = safe_norm(to_ball, dim=-1)
        vel = dyn_mod.velocity(state.dyn)
        approach = torch.sum(vel * to_ball, dim=-1) / (1e-6 + dis)
        return (torch.clamp(approach, max=10.0) * 0.01
                + safe_norm(state.dyn.omega, dim=-1) * -0.002
                + state.success * 10.0)
