"""SAC: soft actor-critic, off-policy, with its replay buffer on the device
(counterpart of ``visfly_tpu/algos/sac.py``).

A call of ``step_and_train`` takes one env step of every agent with the
stochastic actor, stores the transitions, and, when asked to train, takes
``gradient_steps`` gradient steps, each on a fresh sample of ``batch_size``
rows: the twin critic on the soft Bellman target of the target critic, the
actor on ``α·log π − min Q`` through the just-updated critic, the temperature
``log α`` towards the target entropy −``action_size`` (``ent_coef="auto"``),
and a Polyak step of the target critic. Three Adam optimisers, no clip.

Semantics kept from the JAX trainer:

* a timeout is not terminal (``done & ~TimeLimit.truncated``), and a done row
  stores the pre-reset observation as its next observation, so the env is
  switched to ``terminal_obs_in_info`` (a second render a step on a visual
  env)
* ``gradient_steps=-1`` means one gradient step an agent, 0 collects only
* ``learn`` trains once ``learning_starts`` transitions are stored, every
  ``train_freq`` env steps.

The networks live in ``trainer.actor``, ``.critic``, ``.critic_target`` and
``.log_alpha`` and are updated in place. ``step_and_train`` takes the draws
as an optional dict, so that a test can feed both packages the same ones:
``"action"`` (N, A), and per gradient step ``"index"`` (G, batch),
``"next"`` and ``"pi"`` (G, batch, A), the noise of the target's and of the
actor loss's actions.

Data parallel (``parallel.shard_train_state``): each rank steps its block of
agents with the whole batch's action noise sliced to it and stores only its
agents' transitions, in a ring that keeps the one process's global positions
(``buffers.create(rows=...)``). Every rank draws the same global rows and
per-sample noise, computes each loss on the rows it holds, divided by the
global batch size, and the gradients are summed over the ranks before each
optimiser step; the metrics are the global ones.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..envs.base import DroneGymEnv, EnvState
from ..parallel.mesh import all_reduce_, all_reduce_grads_
from ..policies.networks import Actor, QCritic
from . import buffers
from .common import AdamChain, TrainerMixin, frozen_copy, polyak_


class SACState(NamedTuple):
    actor_params: Any  # name → parameter tensor of trainer.actor (updated in place)
    actor_opt: Any
    critic_params: Any
    critic_opt: Any
    critic_target_params: Any
    log_alpha: Tensor  # trainer.log_alpha
    alpha_opt: Any
    buffer: buffers.ReplayBuffer
    env_state: EnvState
    obs: Dict[str, Tensor]
    gen: torch.Generator  # action noise and sample indices
    global_step: int


class SAC(TrainerMixin):
    def __init__(
        self,
        env: DroneGymEnv,
        policy: str = "MultiInputPolicy",  # accepted for reference parity
        policy_kwargs: Optional[dict] = None,
        learning_rate: float = 3e-4,
        buffer_size: int = 100_000,
        batch_size: int = 256,
        tau: float = 0.005,
        gamma: float = 0.99,
        train_freq: int = 1,
        gradient_steps: int = 1,
        learning_starts: int = 1000,
        ent_coef: str = "auto",
        seed: int = 42,
        comment: Optional[str] = None,
        save_path: Optional[str] = None,
        train: bool = True,  # accepted for the runner's eval flow: SAC never needs a grad env
    ):
        self.env = env
        self.buffer_size = int(buffer_size)
        self.batch_size = int(batch_size)
        self.tau = float(tau)
        self.gamma = float(gamma)
        self.train_freq = int(train_freq)
        gs = int(gradient_steps)
        if gs < -1:
            raise ValueError(f"gradient_steps must be >= -1, got {gs}")
        self.gradient_steps = env.global_rows[2] if gs == -1 else gs
        self.learning_starts = int(learning_starts)
        self.auto_ent = ent_coef == "auto"
        self.target_entropy = -float(env.action_size)
        self.learning_rate = learning_rate
        self.seed = seed
        self.comment = comment
        self.save_path = save_path
        # a done row's next observation is the pre-reset one
        env.terminal_obs_in_info = True
        self.policy_kwargs = dict(policy_kwargs or {})
        self.actor = self.critic = self.critic_target = self.log_alpha = None
        self.mesh = None  # a parallel.Mesh when data-parallel

    def set_mesh(self, mesh) -> None:
        """Sum gradients and metrics over ``mesh``'s ranks from now on."""
        self.mesh = mesh

    def build(self, obs: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        """Actor, twin critic, target critic and ``log_alpha`` (0) for
        observations shaped like ``obs``, and their optimisers; parameters
        drawn on the CPU from ``generator`` (default: seeded with ``seed``),
        the actor's first."""
        pk = self.policy_kwargs
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        shapes = {k: tuple(v.shape[1:]) for k, v in obs.items()}
        latent = tuple(pk.get("latent_dim", (256, 256)))
        dev = self.env.device
        self.actor = Actor(shapes, action_dim=self.env.action_size, net_arch=pk.get("net_arch"),
                           latent_dim=latent, generator=generator).to(dev)
        self.critic = QCritic(shapes, action_dim=self.env.action_size, n_critics=2,
                              net_arch=pk.get("net_arch"), latent_dim=latent,
                              generator=generator).to(dev)
        self.critic_target = frozen_copy(self.critic)
        self.log_alpha = torch.zeros((), device=dev, requires_grad=True)
        self.actor_opt = AdamChain(self.actor.parameters(), self.learning_rate)
        self.critic_opt = AdamChain(self.critic.parameters(), self.learning_rate)
        self.alpha_opt = AdamChain([self.log_alpha], self.learning_rate)

    def _state(self, buf, env_state, obs, gen, global_step) -> SACState:
        return SACState(dict(self.actor.named_parameters()), self.actor_opt,
                        dict(self.critic.named_parameters()), self.critic_opt,
                        dict(self.critic_target.named_parameters()), self.log_alpha,
                        self.alpha_opt, buf, env_state, obs, gen, global_step)

    def init(self, gen: Optional[torch.Generator] = None) -> SACState:
        """Reset the env with ``gen`` (default: seeded with ``seed`` on the
        env's device), build the networks and an empty buffer, and seed the
        draws' generator with ``seed + 1``."""
        dev = self.env.device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, obs = self.env.reset(gen)
        self.build(obs)
        buf = buffers.create(self.buffer_size, obs, self.env.action_size,
                             rows=self.env.global_rows)
        return self._state(buf, env_state, obs, torch.Generator(device=dev).manual_seed(
            self.seed + 1), 0)

    def _draws(self, buf, gen, draws, g: int):
        """Gradient step ``g``'s sample indices, then the target's and the
        actor loss's action noise, (batch, A) each: from ``draws`` or from
        ``gen``, in the order the actor would draw them."""
        if draws is not None:
            return draws["index"][g], draws["next"][g], draws["pi"][g]
        idx = buffers.sample_indices(buf, gen, self.batch_size)
        shape = (self.batch_size, self.env.action_size)
        return (idx, *(torch.randn(shape, generator=gen, dtype=torch.float32,
                                   device=idx.device) for _ in range(2)))

    def _gradient_step(self, buf, gen, draws, g: int):
        """One critic, actor, temperature and target step on a fresh sample
        → (critic loss, actor loss, the actor's gradient norm). Each loss is
        the sum over the sample's rows this rank holds over the batch size,
        so that the ranks' gradients sum to the whole sample's."""
        idx, eps_next, eps_pi = self._draws(buf, gen, draws, g)
        mine, rows = buffers.held(buf, idx)
        b_obs, b_next, b_act, b_rew, b_done = buffers.take(buf, rows)
        if mine is not None:
            eps_next, eps_pi = eps_next[mine], eps_pi[mine]
        n = self.batch_size
        alpha = torch.exp(self.log_alpha.detach())
        with torch.no_grad():
            next_a, next_logp = self.actor(b_next, gen, noise=eps_next)
            q_next = self.critic_target(b_next, next_a)
            target_q = b_rew + self.gamma * (~b_done) * (q_next.min(dim=-1).values
                                                          - alpha * next_logp)
        self.critic_opt.zero_grad()
        q = self.critic(b_obs, b_act)
        c_loss = ((q - target_q[:, None]) ** 2).sum() / (n * q.shape[-1])
        c_loss.backward()
        all_reduce_grads_(self.critic.parameters(), self.mesh)  # no-op without a mesh
        self.critic_opt.step()

        self.actor_opt.zero_grad()
        a, logp = self.actor(b_obs, gen, noise=eps_pi)
        # the loss reaches the critic's parameters too; only the actor steps,
        # and the critic's next step starts from zeroed gradients
        a_loss = (alpha * logp - self.critic(b_obs, a).min(dim=-1).values).sum() / n
        a_loss.backward()
        all_reduce_grads_(self.actor.parameters(), self.mesh)
        a_norm = self.actor_opt.step()

        if self.auto_ent:
            self.alpha_opt.zero_grad()
            alpha_loss = -(self.log_alpha * (logp.detach() + self.target_entropy)).sum() / n
            alpha_loss.backward()
            all_reduce_grads_([self.log_alpha], self.mesh)
            self.alpha_opt.step()
        polyak_(self.critic_target, self.critic, self.tau)
        losses = all_reduce_(torch.stack([c_loss.detach(), a_loss.detach()]), self.mesh)
        return losses[0], losses[1], a_norm

    def step_and_train(self, st: SACState, train: bool, draws: Optional[dict] = None
                       ) -> Tuple[SACState, Dict[str, Tensor]]:
        """One env step of every agent and the transitions stored; with
        ``train``, ``gradient_steps`` gradient steps after them."""
        with torch.no_grad():
            # the whole batch's draw, sliced where the env is a rank's block
            eps = (self.env._rows_draw(torch.randn, st.gen, (self.env.action_size,),
                                       torch.float32) if draws is None else draws["action"])
            action, _ = self.actor(st.obs, st.gen, noise=eps)
            action = torch.clamp(action, -1.0, 1.0)
            env_state, out = self.env.step(st.env_state, action)
            terminal = out.done & ~out.info["TimeLimit.truncated"]
            term_obs = out.info["terminal_observation"]
            next_obs = {k: torch.where(out.done.reshape((-1,) + (1,) * (v.dim() - 1)),
                                       term_obs[k], v) for k, v in out.obs.items()}
            buf = buffers.insert(st.buffer, st.obs, next_obs, action, out.reward, terminal)
        metrics = {"reward_mean": all_reduce_(out.reward.mean(), self.mesh, "mean"),
                   "critic_loss": out.reward.new_zeros(()),
                   "actor_loss": out.reward.new_zeros(()),
                   "alpha": torch.exp(self.log_alpha.detach())}
        if train and self.gradient_steps > 0:
            for g in range(self.gradient_steps):
                c_loss, a_loss, a_norm = self._gradient_step(buf, st.gen, draws, g)
            metrics.update(critic_loss=c_loss, actor_loss=a_loss,
                           alpha=torch.exp(self.log_alpha.detach()), grad_norm=a_norm)
        obs = {k: v.detach() for k, v in out.obs.items()}
        return self._state(buf, env_state, obs, st.gen,
                           st.global_step + self.env.global_rows[2]), metrics

    def learn(self, total_timesteps: int, state: Optional[SACState] = None,
              log_interval: int = 500) -> SACState:
        st = self.init() if state is None else state
        n_env = self.env.global_rows[2]
        n_steps = max(1, int(total_timesteps) // n_env)
        t0 = time.time()
        try:
            for i in range(n_steps):
                train = (i * n_env) >= self.learning_starts and (i % self.train_freq == 0)
                st, metrics = self.step_and_train(st, train)
                if log_interval and (i % log_interval == 0 or i == n_steps - 1):
                    m = {k: float(v) for k, v in metrics.items()}
                    fps = (i + 1) * n_env / max(time.time() - t0, 1e-9)
                    print(f"[SAC] step {i + 1}/{n_steps} r̄={m['reward_mean']:.4f} "
                          f"c_loss={m['critic_loss']:.4f} α={m['alpha']:.3f} fps={fps:.0f}",
                          flush=True)
        except KeyboardInterrupt:
            self.save_interrupt_cache(st, None)
        return st

    def predict(self, st: SACState, obs: Dict[str, Tensor]) -> Tensor:
        with torch.no_grad():
            action, _ = self.actor(obs, deterministic=True)
        return torch.clamp(action, -1.0, 1.0)
