"""APG: analytic policy gradient with a deterministic actor (counterpart of
``visfly_tpu/algos/apg.py``).

An update rolls the deterministic actor (the squashed mean) out for
``horizon`` steps through the differentiable env and takes the gradient of
``−mean(Σ r)``, where each agent's rewards stop counting after its first
done, then clips to the global norm and steps Adam (``AdamChain``). The
carried env state and observation are detached between updates. The actor
lives in ``trainer.actor`` and is updated in place.

Data parallel (``parallel.shard_train_state``): each rank rolls out its block
of agents, the gradients are averaged over the ranks before the clip (the
loss is a mean over equal blocks), and the metrics are the global ones.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..envs.base import DroneGymEnv, EnvState
from ..parallel.mesh import all_reduce_, all_reduce_grads_
from ..policies.networks import Actor
from .common import AdamChain, TrainerMixin


class APGState(NamedTuple):
    params: Any  # name → parameter tensor of trainer.actor (updated in place)
    opt_state: Any
    env_state: EnvState
    obs: Dict[str, Tensor]
    global_step: int


class APG(TrainerMixin):
    def __init__(
        self,
        env: DroneGymEnv,
        policy: str = "MultiInputPolicy",  # accepted for reference parity
        policy_kwargs: Optional[dict] = None,
        learning_rate: float = 1e-3,
        horizon: int = 32,
        max_grad_norm: float = 0.5,
        seed: int = 42,
        remat: bool = True,
        train: bool = True,
        comment: Optional[str] = None,
        save_path: Optional[str] = None,
    ):
        self.env = env
        if train:
            self._require_grad_env(env)
        self.H = int(horizon)
        self.max_grad_norm = float(max_grad_norm)
        self.learning_rate = learning_rate
        self.seed = seed
        self.remat = remat  # nothing to do: autograd never replays a forward
        self.comment = comment
        self.save_path = save_path
        self.policy_kwargs = dict(policy_kwargs or {})
        self.actor = None  # built from the first observation's shapes
        self.mesh = None  # a parallel.Mesh when data-parallel

    def set_mesh(self, mesh) -> None:
        """Average gradients and metrics over ``mesh``'s ranks from now on."""
        self.mesh = mesh

    def build(self, obs: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        """The actor for observations shaped like ``obs`` and its optimiser;
        parameters drawn on the CPU from ``generator`` (default: seeded with
        ``seed``)."""
        pk = self.policy_kwargs
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        shapes = {k: tuple(v.shape[1:]) for k, v in obs.items()}
        self.actor = Actor(shapes, action_dim=self.env.action_size, net_arch=pk.get("net_arch"),
                           latent_dim=tuple(pk.get("latent_dim", (256, 256))),
                           generator=generator).to(self.env.device)
        self.optimizer = AdamChain(self.actor.parameters(), self.learning_rate,
                                   self.max_grad_norm)
        return self.actor

    def _state(self, env_state, obs, global_step) -> APGState:
        return APGState(dict(self.actor.named_parameters()), self.optimizer, env_state, obs,
                        global_step)

    def init(self, gen: Optional[torch.Generator] = None) -> APGState:
        """Reset the env with ``gen`` (default: seeded with ``seed`` on the
        env's device) and build the actor."""
        if gen is None:
            gen = torch.Generator(device=self.env.device).manual_seed(self.seed)
        env_state, obs = self.env.reset(gen)
        self.build(obs)
        return self._state(env_state, obs, 0)

    def _loss(self, env_state: EnvState, obs: Dict[str, Tensor]):
        """The H-step rollout → (−mean return, (env_state, obs, rewards))."""
        n, dev = self.env.num_envs, self.env.device
        alive = torch.ones((n,), device=dev)
        total = torch.zeros((n,), device=dev)
        rewards = []
        for _ in range(self.H):
            action, _ = self.actor(obs, deterministic=True)
            env_state, out = self.env.step(env_state, torch.clamp(action, -1.0, 1.0))
            total = total + out.reward * alive
            alive = alive * (1.0 - out.done.to(total.dtype))
            rewards.append(out.reward.detach())
            obs = out.obs
        return -total.mean(), (env_state, obs, torch.stack(rewards))

    def update(self, st: APGState) -> Tuple[APGState, Dict[str, Tensor]]:
        self.optimizer.zero_grad()
        loss, (env_state, obs, rewards) = self._loss(st.env_state, st.obs)
        loss.backward()
        all_reduce_grads_(self.actor.parameters(), self.mesh, "mean")  # no-op without a mesh
        grad_norm = self.optimizer.step()
        means = all_reduce_(torch.stack([loss.detach(), rewards.mean()]), self.mesh, "mean")
        metrics = {"loss": means[0], "reward_mean": means[1], "grad_norm": grad_norm}
        return self._state(self.env.detach(env_state), {k: v.detach() for k, v in obs.items()},
                           st.global_step + self.H * self.env.global_rows[2]), metrics

    def learn(self, total_timesteps: int, state: Optional[APGState] = None,
              log_interval: int = 10) -> APGState:
        st = self.init() if state is None else state
        per = self.H * self.env.global_rows[2]
        n_updates = max(1, int(total_timesteps) // per)
        t0 = time.time()
        try:
            for i in range(n_updates):
                st, metrics = self.update(st)
                if log_interval and (i % log_interval == 0 or i == n_updates - 1):
                    m = {k: float(v) for k, v in metrics.items()}
                    fps = (i + 1) * per / max(time.time() - t0, 1e-9)
                    print(f"[APG] update {i + 1}/{n_updates} loss={m['loss']:.4f} "
                          f"r̄={m['reward_mean']:.4f} fps={fps:.0f}", flush=True)
        except KeyboardInterrupt:
            self.save_interrupt_cache(st, None)
        return st

    def predict(self, st: APGState, obs: Dict[str, Tensor]) -> Tensor:
        with torch.no_grad():
            action, _ = self.actor(obs, deterministic=True)
        return torch.clamp(action, -1.0, 1.0)
