"""Racing through a cyclic sequence of four gates (counterpart of
``visfly_tpu/envs/racing.py``). Gate progression is aux state advanced in
``step_aux``."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import Tensor

from ..core.math_utils import safe_norm
from ..dynamics import DynState
from ..dynamics import dynamics as dyn_mod
from .base import DroneGymEnv, EnvState


class RacingAux(NamedTuple):
    next_target_i: Tensor  # (N,) int32 index of the next gate
    past_targets: Tensor  # (N,) int32 gates passed this episode
    is_pass_next: Tensor  # (N,) bool: passed a gate this step


DEFAULT_RACING_RANDOM = {
    "state_generator": {
        "class": "Union",
        "kwargs": [{"randomizers_kwargs": [
            {"class": "Uniform", "kwargs": {"position": {"mean": [2.0, 2.0, 1.0],
                                                         "half": [0.2, 0.2, 0.2]}}},
            {"class": "Uniform", "kwargs": {"position": {"mean": [6.0, 2.0, 1.5],
                                                         "half": [0.2, 0.2, 0.2]}}},
            {"class": "Uniform", "kwargs": {"position": {"mean": [6.0, -2.0, 1.5],
                                                         "half": [0.2, 0.2, 0.2]}}},
            {"class": "Uniform", "kwargs": {"position": {"mean": [2.0, 0.0, 1.0],
                                                         "half": [0.2, 0.2, 0.2]}}},
        ]}],
    }
}


class RacingEnv(DroneGymEnv):
    """Four cyclic gates; the first gate by the spawn's quadrant; a bonus of
    ``success_r`` for each gate passed."""

    def __init__(self, *args, random_kwargs: Optional[dict] = None,
                 max_episode_steps: int = 256, **kwargs):
        random_kwargs = DEFAULT_RACING_RANDOM if not random_kwargs else random_kwargs
        super().__init__(*args, random_kwargs=random_kwargs,
                         max_episode_steps=max_episode_steps, **kwargs)
        self.targets = torch.tensor([[4.0, 4.0, 1.0], [8.0, 0.0, 2.0], [5.0, -4.0, 1.0],
                                     [1.0, -1.0, 1.0]], dtype=self.dtype, device=self.device)
        self.next_target_num = 2
        self.success_radius = 0.3
        self.success_r = 20.0

    def init_aux(self) -> RacingAux:
        n = self.num_agent
        zeros = torch.zeros((n,), dtype=torch.int32, device=self.device)
        return RacingAux(next_target_i=zeros, past_targets=zeros,
                         is_pass_next=torch.zeros((n,), dtype=torch.bool, device=self.device))

    def _choose_target(self, pos: Tensor) -> Tensor:
        """The first gate, by the quadrant about (4, 0)."""
        rela = pos - pos.new_tensor([4.0, 0.0, 1.0])
        one = torch.ones_like(rela[:, 0], dtype=torch.int32)
        return torch.where(rela[:, 0] < 0,
                           torch.where(rela[:, 1] > 0, 0 * one, 3 * one),
                           torch.where(rela[:, 0] > 0, one, 2 * one))

    def reset_aux(self, state: EnvState, mask: Tensor) -> RacingAux:
        aux: RacingAux = state.aux
        return RacingAux(
            next_target_i=torch.where(mask, self._choose_target(state.dyn.pos),
                                      aux.next_target_i),
            past_targets=torch.where(mask, torch.zeros_like(aux.past_targets),
                                     aux.past_targets),
            is_pass_next=aux.is_pass_next & ~mask,
        )

    def step_aux(self, aux: RacingAux, dyn: DynState) -> RacingAux:
        """Gate passes and the cyclic advance."""
        gate_pos = self.targets[aux.next_target_i.long()]
        is_pass = safe_norm(dyn.pos - gate_pos, dim=-1) <= self.success_radius
        step = is_pass.to(torch.int32)
        return RacingAux(next_target_i=(aux.next_target_i + step) % len(self.targets),
                         past_targets=aux.past_targets + step, is_pass_next=is_pass)

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        return {"state": self.state_obs(state),
                "gate": state.aux.next_target_i[:, None].to(torch.int32)}

    def get_reward(self, state: EnvState) -> Tensor:
        aux: RacingAux = state.aux
        q_ref = state.dyn.q.new_tensor([1.0, 0.0, 0.0, 0.0])
        return (
            0.1
            + safe_norm(state.dyn.pos - self.targets[aux.next_target_i.long()], dim=-1)
            * (-0.1 / 9)
            + safe_norm(state.dyn.q - q_ref, dim=-1) * -0.00001
            + safe_norm(dyn_mod.velocity(state.dyn), dim=-1) * -0.002
            + safe_norm(state.dyn.omega, dim=-1) * -0.002
            + aux.is_pass_next * self.success_r
        )


class RacingEnv2(RacingEnv):
    """The next two gates' relative positions in the state observation."""

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        aux: RacingAux = state.aux
        s = self.state_obs(state)
        idx = (aux.next_target_i[:, None].long()
               + torch.arange(self.next_target_num, device=s.device)[None, :]) % len(self.targets)
        rel = (self.targets[idx] - state.dyn.pos[:, None, :]).reshape(self.num_envs, -1)
        state_vec = torch.cat([rel / self.max_sense_radius, s[:, 3:7], s[:, 7:10] / 10.0,
                               s[:, 10:13] / 10.0], dim=-1)
        return {"state": state_vec, "gate": aux.next_target_i[:, None].to(torch.int32)}
