"""BPTT: analytic policy gradients through the differentiable simulator
(counterpart of ``visfly_tpu/algos/bptt.py``).

An update rolls the policy out for ``horizon`` steps through ``env.step``
(policy, dynamics, reward, auto-reset and, on visual envs, the renderer), takes
the gradient of the discounted return by autograd, clips it to a global norm
and steps Adam. A Python loop over the steps takes the place of ``lax.scan``.

Semantics kept from the JAX trainer:

* stochastic actor actions clipped to the action space
* actor loss ``Σ −r·d`` with the discount resetting on done:
  ``d ← d·γ·(1−done) + done``
* global-norm clip at 0.5 written as optax writes it, scale =
  ``max_norm / max(norm, max_norm)``, then Adam (``eps = 1e-8`` outside the
  root, the rate from ``transfer_schedule`` at the count of updates so far):
  ``common.AdamChain``, which every trainer of the package uses
* the carried env state, observation and hidden state are detached between
  updates (``env.detach``), so the graph never outgrows one horizon.

``remat`` is accepted and has nothing to do: the JAX trainer rematerialises
the scan body and names the render kernel's outputs so that a replay never
contains the kernel; autograd keeps every kernel's outputs and never replays a
forward, so no kernel runs backward here either (the renderers' backward is
the closed-form implicit-function rule).

The policy lives in ``trainer.actor`` (an ``nn.Module``) and is updated in
place; ``BPTTState.params`` and ``.opt_state`` refer to it and to the
optimiser for the shape of the JAX API.

Data parallel (``parallel.shard_train_state``): each rank rolls out its block
of agents with the action noise of the whole batch sliced to it, the
gradients are averaged over the ranks before the clip (the loss is a mean
over equal blocks), and the metrics are the global ones.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..envs.base import DroneGymEnv, EnvState
from ..parallel.mesh import all_reduce_, all_reduce_grads_
from ..policies.networks import Actor, RecurrentActor
from .common import AdamChain, TrainerMixin


class BPTTState(NamedTuple):
    params: Any  # name → parameter tensor of trainer.actor (updated in place)
    opt_state: Any  # the trainer's AdamChain
    env_state: EnvState
    obs: Dict[str, Tensor]
    gen: torch.Generator  # the action noise's generator
    global_step: int
    hidden: Any = ()  # GRU hidden state when recurrent


class BPTT(TrainerMixin):
    """Analytic-gradient trainer. ``learn()`` runs the host loop."""

    def __init__(
        self,
        env: DroneGymEnv,
        policy: str = "MultiInputPolicy",  # accepted for reference parity
        policy_kwargs: Optional[dict] = None,
        learning_rate: float = 1e-3,
        horizon: int = 32,
        gamma: float = 0.99,
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
        self.max_grad_norm = float(max_grad_norm)
        self.seed = seed
        self.remat = remat
        self.comment = comment
        self.save_path = save_path
        self.policy_kwargs = dict(policy_kwargs or {})
        self.recurrent = bool(self.policy_kwargs.get("recurrent", False))
        self.learning_rate = learning_rate
        self.actor = None  # built from the first observation's shapes
        self.optimizer = None
        self.mesh = None  # a parallel.Mesh when data-parallel

    def set_mesh(self, mesh) -> None:
        """Average gradients and metrics over ``mesh``'s ranks from now on."""
        self.mesh = mesh

    # -- setup ---------------------------------------------------------------

    def build(self, obs: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        """The actor for observations shaped like ``obs`` and its optimiser.
        Parameters are drawn on the CPU from ``generator`` (default: seeded
        with ``seed``), so one seed gives one policy on every device."""
        pk = self.policy_kwargs
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        shapes = {k: tuple(v.shape[1:]) for k, v in obs.items()}
        if self.recurrent:
            actor = RecurrentActor(
                shapes, action_dim=self.env.action_size, hidden_dim=pk.get("hidden_dim", 128),
                net_arch=pk.get("net_arch"), latent_dim=tuple(pk.get("latent_dim", (128,))),
                activation=pk.get("activation", "relu"), generator=generator)
        else:
            actor = Actor(
                shapes, action_dim=self.env.action_size, net_arch=pk.get("net_arch"),
                latent_dim=tuple(pk.get("latent_dim", (256, 256))),
                activation=pk.get("activation", "relu"),
                layer_norm=pk.get("layer_norm", False), generator=generator)
        self.actor = actor.to(self.env.device)
        self.optimizer = AdamChain(self.actor.parameters(), self.learning_rate,
                                   self.max_grad_norm)
        return self.actor

    def _state(self, env_state, obs, gen, global_step, hidden) -> "BPTTState":
        return BPTTState(dict(self.actor.named_parameters()), self.optimizer, env_state, obs, gen,
                         global_step, hidden)

    def init(self, gen: Optional[torch.Generator] = None) -> BPTTState:
        """Reset the env with ``gen`` (default: a generator on the env's
        device seeded with ``seed``), build the actor, and seed the action
        noise's generator with ``seed + 1``."""
        dev = self.env.device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, obs = self.env.reset(gen)
        self.build(obs)
        hidden = self.actor.initial_hidden(self.env.num_envs) if self.recurrent else ()
        noise_gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        return self._state(env_state, obs, noise_gen, 0, hidden)

    # -- one update ------------------------------------------------------------

    def _rollout_loss(self, env_state: EnvState, obs: Dict[str, Tensor], gen, hidden,
                      noise: Optional[Tensor] = None):
        """The H-step rollout → (loss, (env_state, obs, hidden, metrics)).
        The action noise of step i is ``noise[i]`` (``noise`` (H, N,
        action_dim)) or drawn from ``gen``."""
        env = self.env
        n, dev = env.num_envs, env.device
        discount = torch.ones((n,), dtype=torch.float32, device=dev)
        loss = torch.zeros((n,), dtype=torch.float32, device=dev)
        rewards, dones, successes = [], [], []
        for i in range(self.H):
            # the whole batch's draw, sliced where the env is a rank's block
            eps = (env._rows_draw(torch.randn, gen, (env.action_size,), torch.float32)
                   if noise is None else noise[i])
            if self.recurrent:
                action, _logp, hidden = self.actor(obs, hidden, gen, noise=eps)
            else:
                action, _logp = self.actor(obs, gen, noise=eps)
            action = torch.clamp(action, -1.0, 1.0)
            env_state, out = env.step(env_state, action)
            done = out.done.to(loss.dtype)
            if self.recurrent:
                # the hidden state resets with the episode (auto-reset boundary)
                hidden = hidden * (1.0 - done)[:, None]
            loss = loss - out.reward * discount
            discount = discount * self.gamma * (1.0 - done) + done
            obs = out.obs
            rewards.append(out.reward.detach())
            dones.append(out.done)
            successes.append(out.info["is_success"])
        metrics = (torch.stack(rewards), torch.stack(dones), torch.stack(successes))
        return loss.mean(), (env_state, obs, hidden, metrics)

    def update(self, st: BPTTState, noise: Optional[Tensor] = None
               ) -> Tuple[BPTTState, Dict[str, Tensor]]:
        """One rollout, backward pass and clipped Adam step; the actor's
        parameters change in place."""
        self.optimizer.zero_grad()
        loss, (env_state, obs, hidden, metrics) = self._rollout_loss(
            st.env_state, st.obs, st.gen, st.hidden, noise)
        loss.backward()
        all_reduce_grads_(self.actor.parameters(), self.mesh, "mean")  # no-op without a mesh
        grad_norm = self.optimizer.step()

        # truncate the graph between updates
        env_state = self.env.detach(env_state)
        obs = {k: v.detach() for k, v in obs.items()}
        if self.recurrent:
            hidden = hidden.detach()

        rewards, dones, succ = metrics
        means = all_reduce_(torch.stack([loss.detach(), rewards.mean(), dones.float().mean(),
                                         succ.float().mean()]), self.mesh, "mean")
        out_metrics = {
            "actor_loss": means[0],
            "reward_mean": means[1],
            "done_rate": means[2],
            "success_rate": means[3],
            "grad_norm": grad_norm,
        }
        return self._state(env_state, obs, st.gen, st.global_step + self.H * self.env.global_rows[2],
                           hidden), out_metrics

    # -- host training loop ----------------------------------------------------

    def learn(
        self,
        total_timesteps: int,
        state: Optional[BPTTState] = None,
        log_interval: int = 10,
        callback: Optional[Callable] = None,
        log_dir: Optional[str] = None,
        eval_env=None,
        eval_interval: int = 0,
    ) -> BPTTState:
        st = self.init() if state is None else state
        logger = self.make_logger(log_dir)
        steps_per_update = self.H * self.env.global_rows[2]
        n_updates = max(1, int(total_timesteps) // steps_per_update)
        t0 = time.time()
        try:
            for i in range(n_updates):
                st, metrics = self.update(st)
                if callback is not None:
                    callback(i, st, metrics)
                if log_interval and (i % log_interval == 0 or i == n_updates - 1):
                    m = {k: float(v) for k, v in metrics.items()}
                    fps = (i + 1) * steps_per_update / max(time.time() - t0, 1e-9)
                    print(
                        f"[BPTT] update {i + 1}/{n_updates} "
                        f"loss={m['actor_loss']:.4f} r̄={m['reward_mean']:.4f} "
                        f"success={m['success_rate']:.2%} fps={fps:.0f}",
                        flush=True,
                    )
                    m["time/fps"] = fps
                    if eval_interval and i % eval_interval == 0:
                        m.update(self.evaluate(st, eval_env))
                    self.log_metrics(logger, m, int(st.global_step))
        except KeyboardInterrupt:
            self.save_interrupt_cache(st, log_dir)
        finally:
            if logger is not None:
                logger.close()
        return st

    def predict(self, st: BPTTState, obs: Dict[str, Tensor], hidden: Any = None) -> Tensor:
        """Deterministic action. For recurrent actors pass (and thread) the
        hidden state through :meth:`predict_step`; bare predict uses the
        hidden state the trainer carries (or zeros) and discards the GRU's
        update, so rollouts must use predict_step."""
        with torch.no_grad():
            if self.recurrent:
                if hidden is None:
                    hidden = (st.hidden if isinstance(st.hidden, Tensor)
                              else self.actor.initial_hidden(next(iter(obs.values())).shape[0]))
                action, _, _ = self.actor(obs, hidden, deterministic=True)
            else:
                action, _ = self.actor(obs, deterministic=True)
        return torch.clamp(action, -1.0, 1.0)

    # recurrent evaluation hooks (TrainerMixin.evaluate threads the GRU hidden
    # state through the rollout and resets it at episode boundaries)
    def init_predict_carry(self, obs):
        if not self.recurrent:
            return ()
        return self.actor.initial_hidden(next(iter(obs.values())).shape[0])

    def predict_step(self, st: BPTTState, obs, carry):
        if not self.recurrent:
            return self.predict(st, obs), carry
        with torch.no_grad():
            action, _, hidden = self.actor(obs, carry, deterministic=True)
        return torch.clamp(action, -1.0, 1.0), hidden

    def mask_predict_carry(self, carry, done):
        if not self.recurrent:
            return carry
        keep = 1.0 - torch.as_tensor(done, device=carry.device).to(carry.dtype)
        return carry * keep[:, None]
