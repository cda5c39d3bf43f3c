"""SHAC: short-horizon actor-critic on the differentiable simulator
(counterpart of ``visfly_tpu/algos/shac.py``).

An update rolls the stochastic actor out for ``horizon`` steps through the
differentiable env, takes the gradient of the discounted return bootstrapped
with the target critic, and steps the actor; then it regresses the twin
``QCritic`` on the rollout's TD(λ) targets for ``gradient_steps`` steps, each
followed by a Polyak step of the target critic.

Semantics kept from the JAX trainer:

* actor loss ``Σ −r·d``, plus ``−γ·d·min Q_target(s', π(s'))`` where the
  horizon ends or an agent is done without a terminal episode end; the
  discount resets on done: ``d ← d·γ·(1−done) + done``
* the bootstrap's action and observation carry no gradient, and neither does
  the target critic
* TD(λ) targets by the reference's Ai / Bi / λ recursion
  (``returns.compute_td_returns``)
* both optimisers clip to the global norm and step Adam (``AdamChain``)
* the carried env state and observation are detached between updates.

The networks live in ``trainer.actor``, ``trainer.critic`` and
``trainer.critic_target`` and are updated in place. ``update`` takes the
rollout's action noise as an optional argument, (2, H, N, A): the action's
noise and the bootstrap action's noise of each step.

Data parallel (``parallel.shard_train_state``): each rank rolls out its block
of agents with the whole batch's action noise sliced to it; the actor's
gradient is averaged over the ranks before the clip, and so is each critic
step's over the flattened H × N batch (equal blocks), so the critic, its
target and their optimisers stay equal on every rank; the TD(λ) targets are
per agent and stay local, and the metrics are the global ones.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..envs.base import DroneGymEnv, EnvState
from ..parallel.mesh import all_reduce_, all_reduce_grads_
from ..policies.networks import Actor, QCritic
from .common import AdamChain, TrainerMixin, frozen_copy, polyak_
from .returns import compute_td_returns


class SHACState(NamedTuple):
    actor_params: Any  # name → parameter tensor of trainer.actor (updated in place)
    actor_opt: Any
    critic_params: Any
    critic_opt: Any
    critic_target_params: Any
    env_state: EnvState
    obs: Dict[str, Tensor]
    gen: torch.Generator  # the action noise's generator
    global_step: int


class SHAC(TrainerMixin):
    def __init__(
        self,
        env: DroneGymEnv,
        policy: str = "MultiInputPolicy",  # accepted for reference parity
        policy_kwargs: Optional[dict] = None,
        learning_rate: float = 1e-3,
        horizon: int = 32,
        tau: float = 0.005,
        gamma: float = 0.99,
        gradient_steps: int = 5,
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
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.gradient_steps = int(gradient_steps)
        self.max_grad_norm = float(max_grad_norm)
        self.learning_rate = learning_rate
        self.seed = seed
        self.remat = remat  # nothing to do: autograd never replays a forward
        self.comment = comment
        self.save_path = save_path
        self.policy_kwargs = dict(policy_kwargs or {})
        self.actor = self.critic = self.critic_target = None  # built from the first obs
        self.mesh = None  # a parallel.Mesh when data-parallel

    def set_mesh(self, mesh) -> None:
        """Average gradients and metrics over ``mesh``'s ranks from now on."""
        self.mesh = mesh

    def build(self, obs: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        """Actor, twin critic and target critic for observations shaped like
        ``obs``, and their optimisers; parameters drawn on the CPU from
        ``generator`` (default: seeded with ``seed``), the actor's first."""
        pk = self.policy_kwargs
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        shapes = {k: tuple(v.shape[1:]) for k, v in obs.items()}
        latent = tuple(pk.get("latent_dim", (256, 256)))
        act = pk.get("activation", "relu")
        dev = self.env.device
        self.actor = Actor(shapes, action_dim=self.env.action_size, net_arch=pk.get("net_arch"),
                           latent_dim=latent, activation=act, generator=generator).to(dev)
        self.critic = QCritic(shapes, action_dim=self.env.action_size,
                              n_critics=pk.get("n_critics", 2), net_arch=pk.get("net_arch"),
                              latent_dim=latent, activation=act, generator=generator).to(dev)
        self.critic_target = frozen_copy(self.critic)
        self.actor_opt = AdamChain(self.actor.parameters(), self.learning_rate,
                                   self.max_grad_norm)
        self.critic_opt = AdamChain(self.critic.parameters(), self.learning_rate,
                                    self.max_grad_norm)

    def _state(self, env_state, obs, gen, global_step) -> SHACState:
        return SHACState(dict(self.actor.named_parameters()), self.actor_opt,
                         dict(self.critic.named_parameters()), self.critic_opt,
                         dict(self.critic_target.named_parameters()), env_state, obs, gen,
                         global_step)

    def init(self, gen: Optional[torch.Generator] = None) -> SHACState:
        """Reset the env with ``gen`` (default: seeded with ``seed`` on the
        env's device), build the networks, and seed the action noise's
        generator with ``seed + 1``."""
        dev = self.env.device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, obs = self.env.reset(gen)
        self.build(obs)
        return self._state(env_state, obs, torch.Generator(device=dev).manual_seed(self.seed + 1),
                           0)

    # -- rollout and actor loss ------------------------------------------------

    def _rollout(self, env_state: EnvState, obs: Dict[str, Tensor], gen,
                 noise: Optional[Tensor] = None):
        """The H-step rollout → (actor loss, (env_state, obs, tape)); the tape
        holds (obs, action, reward, done, episode done, bootstrap value,
        success) of each step, detached."""
        env = self.env
        n, dev = env.num_envs, env.device
        discount = torch.ones((n,), dtype=torch.float32, device=dev)
        loss = torch.zeros((n,), dtype=torch.float32, device=dev)
        tape = []
        # the whole batch's draws, sliced where the env is a rank's block
        def draw():
            return env._rows_draw(torch.randn, gen, (env.action_size,), torch.float32)

        for i in range(self.H):
            eps = draw() if noise is None else noise[0, i]
            action, _ = self.actor(obs, gen, noise=eps)
            action = torch.clamp(action, -1.0, 1.0)
            env_state, out = env.step(env_state, action)
            done = out.done
            episode_done = out.info["episode_done"]
            with torch.no_grad():
                next_obs = {k: v.detach() for k, v in out.obs.items()}
                eps_next = draw() if noise is None else noise[1, i]
                next_action, _ = self.actor(next_obs, gen, noise=eps_next)
                q = self.critic_target(next_obs, torch.clamp(next_action, -1.0, 1.0))
                next_values = q.min(dim=-1).values
            loss = loss - out.reward * discount
            # bootstrap where the horizon ends or an agent is done but not terminal
            dbnee = (done | (i == self.H - 1)) & ~episode_done
            loss = loss - next_values * discount * self.gamma * dbnee
            done_f = done.to(loss.dtype)
            discount = discount * self.gamma * (1.0 - done_f) + done_f
            tape.append(({k: v.detach() for k, v in obs.items()}, action.detach(),
                         out.reward.detach(), done, episode_done, next_values,
                         out.info["is_success"]))
            obs = out.obs
        b_obs = {k: torch.stack([t[0][k] for t in tape]) for k in tape[0][0]}
        tape = (b_obs, *(torch.stack([t[j] for t in tape]) for j in range(1, 7)))
        return loss.mean(), (env_state, obs, tape)

    def update(self, st: SHACState, noise: Optional[Tensor] = None
               ) -> Tuple[SHACState, Dict[str, Tensor]]:
        """One actor step through the rollout, then ``gradient_steps`` critic
        steps, each with a Polyak step of the target."""
        self.actor_opt.zero_grad()
        actor_loss, (env_state, obs, tape) = self._rollout(st.env_state, st.obs, st.gen, noise)
        actor_loss.backward()
        all_reduce_grads_(self.actor.parameters(), self.mesh, "mean")  # no-op without a mesh
        grad_norm = self.actor_opt.step()
        env_state = self.env.detach(env_state)
        obs = {k: v.detach() for k, v in obs.items()}

        b_obs, b_act, b_rew, b_done, b_epdone, b_val, b_succ = tape
        returns = compute_td_returns(b_rew, b_done, b_val, b_epdone, gamma=self.gamma)
        flat_obs = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in b_obs.items()}
        flat_act = b_act.reshape(-1, b_act.shape[-1])
        flat_ret = returns.reshape(-1)
        critic_loss = actor_loss.new_zeros(())
        for _ in range(self.gradient_steps):
            self.critic_opt.zero_grad()
            values = self.critic(flat_obs, flat_act).min(dim=-1).values
            critic_loss = torch.mean((flat_ret - values) ** 2)
            critic_loss.backward()
            all_reduce_grads_(self.critic.parameters(), self.mesh, "mean")
            self.critic_opt.step()
            polyak_(self.critic_target, self.critic, self.tau)

        means = all_reduce_(torch.stack([actor_loss.detach(), critic_loss.detach(), b_rew.mean(),
                                         b_succ.float().mean()]), self.mesh, "mean")
        metrics = {
            "actor_loss": means[0],
            "critic_loss": means[1],
            "reward_mean": means[2],
            "success_rate": means[3],
            "grad_norm": grad_norm,
        }
        return self._state(env_state, obs, st.gen,
                           st.global_step + self.H * self.env.global_rows[2]), metrics

    def learn(self, total_timesteps: int, state: Optional[SHACState] = None,
              log_interval: int = 10) -> SHACState:
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
                    print(f"[SHAC] update {i + 1}/{n_updates} a_loss={m['actor_loss']:.4f} "
                          f"c_loss={m['critic_loss']:.4f} r̄={m['reward_mean']:.4f} "
                          f"fps={fps:.0f}", flush=True)
        except KeyboardInterrupt:
            self.save_interrupt_cache(st, None)
        return st

    def predict(self, st: SHACState, obs: Dict[str, Tensor]) -> Tensor:
        with torch.no_grad():
            action, _ = self.actor(obs, deterministic=True)
        return torch.clamp(action, -1.0, 1.0)
