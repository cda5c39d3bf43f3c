"""PPO: clipped-surrogate on-policy RL (counterpart of
``visfly_tpu/algos/ppo.py``).

An update collects ``n_steps`` env steps of every agent under no gradient,
computes SB3's GAE, and takes ``n_epochs`` passes of minibatch SGD over the
rollout. Python loops over steps, epochs and minibatches take the place of
the JAX package's scans.

Semantics kept from the JAX trainer:

* Gaussian policy with a state-independent log-std; the sampled action is
  clipped to [-1, 1] for the env and kept unclipped for the log-probability
* SB3's truncation bootstrap: on a timeout the reward gains
  γ·V(terminal observation), so the env is switched to
  ``terminal_obs_in_info`` (a second render a step on a visual env)
* advantage normalisation per minibatch with the population std (ddof 0, as
  ``jnp.std``), value clipping (``clip_range_vf``), entropy bonus, the
  global-norm clip and Adam, or AdamW with ``weight_decay`` (``AdamChain``)
* ``target_kl``: once a minibatch's approx KL (Schulman's k3) exceeds
  1.5·target_kl, that minibatch and every later one take no step; their losses
  are still evaluated (under no gradient), because the JAX trainer masks them
  and its metrics average over every minibatch of every epoch
  (``update_fraction`` < 1 after a stop)
* a 100-episode window of completed-episode stats (SB3's ``ep_info_buffer``)
  as a ring of tensors on the device
* the recurrent policy trains on whole sequences over the agent axis, the GRU
  replayed from the rollout's first hidden state and zeroed with ``done``

The policy lives in ``trainer.policy`` and is updated in place;
``PPOState.params`` and ``.opt_state`` refer to it and to the optimiser.
``update`` takes the rollout's action noise (n_steps, N, A) and each epoch's
permutation (n_epochs, n_steps·N; of the N agents when recurrent) as optional
arguments, so that a test can feed both packages the same draws.

Data parallel (``parallel.shard_train_state``, either policy): each rank
rolls out its block of agents with the whole batch's action noise sliced to
it; the epochs draw one permutation of the whole batch (of its agents when
recurrent), and each rank trains on the part of a minibatch that falls in its
block, normalising advantages with the minibatch's global mean and standard
deviation (two all-reduces); its loss is its share of the minibatch mean, the
gradients are summed over the ranks before the clip, the ``target_kl`` test
reads the global KL, and the episode window is kept whole on every rank.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..envs.base import DroneGymEnv, EnvState
from ..parallel.mesh import all_reduce_, all_reduce_grads_, gather_rows
from ..policies.networks import (
    ActorCriticPolicy,
    RecurrentActorCriticPolicy,
    gaussian_entropy,
    gaussian_log_prob,
)
from .common import AdamChain, TrainerMixin
from .returns import compute_gae

EP_WINDOW = 100  # SB3's ep_info_buffer maxlen


class EpisodeStats(NamedTuple):
    """The last ≤ ``EP_WINDOW`` completed episodes, a ring on the device."""

    returns: Tensor  # (EP_WINDOW,)
    lengths: Tensor  # (EP_WINDOW,)
    success: Tensor  # (EP_WINDOW,)
    pos: Tensor  # () int64, the next write slot
    count: Tensor  # () int64, episodes seen, saturating at EP_WINDOW


def init_episode_stats(device=None, dtype=torch.float32) -> EpisodeStats:
    z = torch.zeros((EP_WINDOW,), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return EpisodeStats(returns=z, lengths=z.clone(), success=z.clone(), pos=zero,
                        count=zero.clone())


def push_episode_stats(stats: EpisodeStats, done: Tensor, ep_return: Tensor,
                       ep_length: Tensor, ep_success: Tensor) -> EpisodeStats:
    """Write this step's completed episodes into the ring, in agent order. If
    more than ``EP_WINDOW`` finish at once, the last ``EP_WINDOW`` of them are
    kept (the deque's "most recent 100"); the rest go to a slot past the end
    that is dropped, so every kept slot is written once."""
    d = done.to(torch.int64)
    offs = torch.cumsum(d, 0) - 1
    n_done = d.sum()
    slot = (stats.pos + offs) % EP_WINDOW
    keep = done & (offs >= n_done - EP_WINDOW)
    idx = torch.where(keep, slot, torch.full_like(slot, EP_WINDOW))

    def put(store, x):
        ext = torch.cat([store, store.new_zeros(1)])
        ext.index_copy_(0, idx, x.to(store.dtype))
        return ext[:EP_WINDOW]

    return EpisodeStats(
        returns=put(stats.returns, ep_return),
        lengths=put(stats.lengths, ep_length),
        success=put(stats.success, ep_success),
        pos=(stats.pos + n_done) % EP_WINDOW,
        count=torch.clamp(stats.count + n_done, max=EP_WINDOW),
    )


def episode_stats_means(stats: EpisodeStats) -> Tuple[Tensor, Tensor, Tensor]:
    """Mean return, length and success over the episodes in the window."""
    dt = stats.returns.dtype
    valid = (torch.arange(EP_WINDOW, device=stats.returns.device) < stats.count).to(dt)
    n = torch.clamp(stats.count.to(dt), min=1.0)
    return ((stats.returns * valid).sum() / n, (stats.lengths * valid).sum() / n,
            (stats.success * valid).sum() / n)


class PPOState(NamedTuple):
    params: Any  # name → parameter tensor of trainer.policy (updated in place)
    opt_state: Any  # the trainer's AdamChain
    env_state: EnvState
    obs: Dict[str, Tensor]
    gen: torch.Generator  # action noise and epoch permutations
    global_step: int
    ep_stats: EpisodeStats
    hidden: Any = ()  # GRU hidden state when recurrent


class PPO(TrainerMixin):
    def __init__(
        self,
        env: DroneGymEnv,
        policy: str = "MultiInputPolicy",  # accepted for reference parity
        policy_kwargs: Optional[dict] = None,
        learning_rate: float = 3e-4,
        n_steps: int = 256,
        batch_size: int = 0,  # 0: one minibatch an epoch (the whole rollout)
        n_epochs: int = 10,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        clip_range: float = 0.2,
        clip_range_vf: Optional[float] = None,
        ent_coef: float = 0.0,
        vf_coef: float = 0.5,
        max_grad_norm: float = 0.5,
        normalize_advantage: bool = True,
        target_kl: Optional[float] = None,
        weight_decay: float = 0.0,
        bootstrap_truncated: bool = True,
        scene_freq: Optional[int] = None,
        seed: int = 42,
        comment: Optional[str] = None,
        save_path: Optional[str] = None,
        train: bool = True,  # accepted for the runner's eval flow: PPO never needs a grad env
    ):
        self.env = env
        self.n_steps = int(n_steps)
        self.n_epochs = int(n_epochs)
        self.gamma = float(gamma)
        self.gae_lambda = float(gae_lambda)
        self.clip_range = float(clip_range)
        self.clip_range_vf = None if clip_range_vf is None else float(clip_range_vf)
        self.ent_coef = float(ent_coef)
        self.vf_coef = float(vf_coef)
        self.max_grad_norm = float(max_grad_norm)
        self.normalize_advantage = normalize_advantage
        self.target_kl = None if target_kl is None else float(target_kl)
        self.learning_rate = learning_rate
        self.weight_decay = float(weight_decay)
        self.bootstrap_truncated = bool(bootstrap_truncated)
        if self.bootstrap_truncated:
            env.terminal_obs_in_info = True
        self.scene_freq = scene_freq
        self.seed = seed
        self.comment = comment
        self.save_path = save_path
        self.policy_kwargs = dict(policy_kwargs or {})
        self.recurrent = bool(self.policy_kwargs.get("recurrent", False))
        self._batch_size_arg = batch_size
        self._layout(env.num_envs)
        self.policy = None  # built from the first observation's shapes
        self.optimizer = None
        self.mesh = None  # a parallel.Mesh when data-parallel

    def _layout(self, n_env: int) -> None:
        """Minibatch size and count for a rollout of ``n_env`` agents."""
        batch_size = self._batch_size_arg
        if self.recurrent:
            # minibatches are whole sequences over the agent axis
            mb_agents = (max(1, min(n_env, int(batch_size) // self.n_steps))
                         if batch_size else n_env)
            while n_env % mb_agents:
                mb_agents -= 1
            self.n_minibatches = n_env // mb_agents
            self.batch_size = mb_agents * self.n_steps
        else:
            total = self.n_steps * n_env
            self.batch_size = int(batch_size) if batch_size else total
            self.n_minibatches = max(1, total // self.batch_size)

    def set_mesh(self, mesh) -> None:
        """Train over ``mesh``'s ranks from now on: minibatches of the whole
        batch, global statistics, summed gradients."""
        self.mesh = mesh
        self._layout(self.env.global_rows[2])

    # -- setup ---------------------------------------------------------------

    def build(self, obs: Dict[str, Tensor], generator: Optional[torch.Generator] = None):
        """The policy for observations shaped like ``obs`` and its optimiser.
        Parameters are drawn on the CPU from ``generator`` (default: seeded
        with ``seed``), so one seed gives one policy on every device."""
        pk = self.policy_kwargs
        if generator is None:
            generator = torch.Generator().manual_seed(self.seed)
        shapes = {k: tuple(v.shape[1:]) for k, v in obs.items()}
        common = dict(action_dim=self.env.action_size, net_arch=pk.get("net_arch"),
                      activation=pk.get("activation", "relu"), generator=generator)
        if self.recurrent:
            policy = RecurrentActorCriticPolicy(
                shapes, hidden_dim=int(pk.get("hidden_dim", 128)),
                pi_layers=tuple(pk.get("pi_layers", (64,))),
                vf_layers=tuple(pk.get("vf_layers", (64,))), **common)
        else:
            policy = ActorCriticPolicy(shapes, pi_layers=tuple(pk.get("pi_layers", (64, 64))),
                                       vf_layers=tuple(pk.get("vf_layers", (64, 64))), **common)
        self.policy = policy.to(self.env.device)
        self.optimizer = AdamChain(self.policy.parameters(), self.learning_rate,
                                   self.max_grad_norm, self.weight_decay)
        return self.policy

    def _state(self, env_state, obs, gen, global_step, ep_stats, hidden) -> PPOState:
        return PPOState(dict(self.policy.named_parameters()), self.optimizer, env_state, obs,
                        gen, global_step, ep_stats, hidden)

    def init(self, gen: Optional[torch.Generator] = None) -> PPOState:
        """Reset the env with ``gen`` (default: a generator on the env's
        device seeded with ``seed``), build the policy, and seed the action
        noise's generator with ``seed + 1``."""
        dev = self.env.device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(self.seed)
        env_state, obs = self.env.reset(gen)
        self.build(obs)
        hidden = self.policy.initial_hidden(self.env.num_envs) if self.recurrent else ()
        noise_gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        return self._state(env_state, obs, noise_gen, 0, init_episode_stats(dev), hidden)

    # -- one update ------------------------------------------------------------

    def _policy_fwd(self, obs, hidden):
        """(mean, log_std, value, new hidden) for either policy."""
        if self.recurrent:
            return self.policy(obs, hidden)
        return (*self.policy(obs), hidden)

    @torch.no_grad()
    def _collect(self, st: PPOState, noise: Optional[Tensor] = None):
        """The rollout → (env_state, obs, ep_stats, hidden, tape); the tape
        holds (obs, action, logp, value, reward with the bootstrap, reward,
        done), each stacked over the steps."""
        env = self.env
        env_state, obs, ep_stats, hidden = st.env_state, st.obs, st.ep_stats, st.hidden
        steps: List[tuple] = []
        for i in range(self.n_steps):
            mean, log_std, value, new_hidden = self._policy_fwd(obs, hidden)
            # the whole batch's draw, sliced where the env is a rank's block
            eps = (env._rows_draw(torch.randn, st.gen, mean.shape[1:], mean.dtype)
                   if noise is None else noise[i])
            action = mean + torch.exp(log_std) * eps
            logp = gaussian_log_prob(mean, log_std, action)
            env_state, out = env.step(env_state, torch.clamp(action, -1.0, 1.0))
            reward = out.reward
            if self.bootstrap_truncated:
                # SB3's truncation rule: r += γ·V(s_terminal) on a timeout
                _, _, term_value, _ = self._policy_fwd(out.info["terminal_observation"],
                                                       new_hidden)
                reward = reward + self.gamma * term_value * out.info["TimeLimit.truncated"]
            ep_stats = push_episode_stats(ep_stats, *self._gather(
                out.done, out.info["episode_return"], out.info["episode_length"],
                out.info["is_success"]))
            if self.recurrent:
                # the hidden state resets with the episode
                new_hidden = new_hidden * (1.0 - out.done.to(new_hidden.dtype))[:, None]
            steps.append((obs, action, logp, value, reward, out.reward, out.done))
            obs, hidden = out.obs, new_hidden
        b_obs = {k: torch.stack([s[0][k] for s in steps]) for k in steps[0][0]}
        tape = (b_obs, *(torch.stack([s[j] for s in steps]) for j in range(1, 7)))
        return env_state, obs, ep_stats, hidden, tape

    @torch.no_grad()
    def _advantages(self, obs, hidden, b_val, b_rew, b_done) -> Tuple[Tensor, Tensor]:
        _, _, last_value, _ = self._policy_fwd(obs, hidden)
        return compute_gae(b_rew, b_val, b_done, last_value, b_done[-1], gamma=self.gamma,
                           gae_lambda=self.gae_lambda)

    def _gather(self, *xs):
        """The whole batch's per-agent tensors on every rank (as they are
        without a mesh)."""
        return tuple(gather_rows(x, self.env.global_rows, self.mesh) for x in xs)

    def _ppo_losses(self, mean, log_std, value, old_logp, old_value, action, adv, ret,
                    n: int):
        """The loss and (pg_loss, v_loss, entropy, clip fraction, approx KL)
        of a minibatch of ``n`` samples over all ranks, of any batch shape;
        each term is this rank's share of the minibatch mean."""
        def reduce(x: Tensor) -> Tensor:
            return x.sum() / n

        logp = gaussian_log_prob(mean, log_std, action)
        log_ratio = logp - old_logp
        ratio = torch.exp(log_ratio)
        pg1 = adv * ratio
        pg2 = adv * torch.clamp(ratio, 1.0 - self.clip_range, 1.0 + self.clip_range)
        pg_loss = -reduce(torch.minimum(pg1, pg2))
        if self.clip_range_vf is not None:
            # predictions move at most clip_range_vf from the rollout's values
            value = old_value + torch.clamp(value - old_value, -self.clip_range_vf,
                                            self.clip_range_vf)
        v_loss = reduce((ret - value) ** 2)
        ent = reduce(gaussian_entropy(log_std))
        loss = pg_loss + self.vf_coef * v_loss - self.ent_coef * ent
        approx_kl = reduce(ratio - 1.0 - log_ratio)
        clip_frac = reduce(((ratio - 1.0).abs() > self.clip_range).to(ratio.dtype))
        return loss, (pg_loss, v_loss, ent, clip_frac, approx_kl)

    def _minibatch(self, loss_fn, cont: bool, stats: list, norms: list) -> bool:
        """One minibatch: while ``cont``, the loss with its gradient, the KL
        test, and a step if it passes; after a stop, the loss alone. Appends
        (loss, pg, v, entropy, clip fraction, approx KL, applied) to
        ``stats`` → whether later minibatches may step."""
        if cont:
            self.optimizer.zero_grad()
            loss, aux = loss_fn()
            vals = all_reduce_(torch.stack([loss.detach(), *(a.detach() for a in aux)]),
                               self.mesh)
            if self.target_kl is not None:
                # SB3 checks before applying the offending minibatch
                cont = bool(vals[-1] <= 1.5 * self.target_kl)
            if cont:
                loss.backward()
                all_reduce_grads_(self.policy.parameters(), self.mesh)
                norms.append(self.optimizer.step())
        else:
            with torch.no_grad():
                loss, aux = loss_fn()
                vals = all_reduce_(torch.stack([loss, *aux]), self.mesh)
        stats.append(torch.cat([vals, vals.new_tensor([float(cont)])]))
        return cont

    def _normalize(self, adv: Tensor, n: int) -> Tensor:
        """``adv`` normalised by the mean and standard deviation of the
        minibatch of ``n`` samples it is this rank's share of."""
        if not self.normalize_advantage:
            return adv
        mean = all_reduce_(adv.sum().reshape(1), self.mesh) / n
        var = all_reduce_(((adv - mean) ** 2).sum().reshape(1), self.mesh) / n
        return (adv - mean) / (var.sqrt() + 1e-8)

    def _permutation(self, gen, n: int, perms: Optional[Tensor], epoch: int) -> Tensor:
        if perms is not None:
            return perms[epoch].to(self.env.device)
        return torch.randperm(n, generator=gen, device=self.env.device)

    def _train_flat(self, gen, tape, advantages, returns, perms=None):
        """Each minibatch of the whole batch's permutation, in (step, agent)
        order, trains on the rows this env holds (all of them without a
        mesh), with the minibatch's global advantage statistics."""
        b_obs, b_act, b_logp, b_val = tape[:4]
        lo, hi, n_global = self.env.global_rows
        n_local = hi - lo
        total = self.n_steps * n_global

        def flat(x):
            return x.reshape((self.n_steps * n_local,) + tuple(x.shape[2:]))

        f_obs = {k: flat(v) for k, v in b_obs.items()}
        f_act, f_logp, f_adv, f_ret, f_val = (flat(x) for x in (b_act, b_logp, advantages,
                                                                 returns, b_val))
        mb = total // self.n_minibatches
        cont, stats, norms = True, [], []
        for epoch in range(self.n_epochs):
            perm = self._permutation(gen, total, perms, epoch)
            for g_idx in perm[: self.n_minibatches * mb].reshape(self.n_minibatches, mb):
                idx = g_idx
                if n_local < n_global:  # the rows this rank holds (a host sync)
                    step, agent = g_idx // n_global, g_idx % n_global
                    mine = (agent >= lo) & (agent < hi)
                    idx = step[mine] * n_local + (agent[mine] - lo)
                mb_adv = self._normalize(f_adv[idx], mb)
                mb_obs = {k: v[idx] for k, v in f_obs.items()}

                def loss_fn(mb_obs=mb_obs, idx=idx, mb_adv=mb_adv):
                    mean, log_std, value = self.policy(mb_obs)
                    return self._ppo_losses(mean, log_std, value, f_logp[idx], f_val[idx],
                                            f_act[idx], mb_adv, f_ret[idx], mb)

                cont = self._minibatch(loss_fn, cont, stats, norms)
        return stats, norms

    def _train_recurrent(self, gen, h0, tape, advantages, returns, perms=None):
        """Minibatches of whole sequences over the agent axis of the whole
        batch's permutation; the minibatch's agents that this env holds (all
        of them without a mesh) replay the GRU from the rollout's first hidden
        state ``h0``, zeroing it at the recorded dones, with the minibatch's
        global advantage statistics."""
        b_obs, b_act, b_logp, b_val = tape[:4]
        b_done = tape[6]
        lo, hi, n_global = self.env.global_rows
        mb_agents = n_global // self.n_minibatches
        n_mb = self.n_steps * mb_agents
        cont, stats, norms = True, [], []
        for epoch in range(self.n_epochs):
            perm = self._permutation(gen, n_global, perms, epoch)
            for idx in perm[: self.n_minibatches * mb_agents].reshape(self.n_minibatches,
                                                                      mb_agents):
                if hi - lo < n_global:  # the agents this rank holds (a host sync)
                    idx = idx[(idx >= lo) & (idx < hi)] - lo
                mb_obs = {k: v[:, idx] for k, v in b_obs.items()}
                mb_done = b_done[:, idx].to(h0.dtype)
                mb_adv = self._normalize(advantages[:, idx], n_mb)

                def loss_fn(mb_obs=mb_obs, idx=idx, mb_done=mb_done, mb_adv=mb_adv, n_mb=n_mb):
                    h = h0[idx]
                    outs = []
                    for t in range(self.n_steps):
                        mean, log_std, value, h = self.policy(
                            {k: v[t] for k, v in mb_obs.items()}, h)
                        h = h * (1.0 - mb_done[t])[:, None]
                        outs.append((mean, log_std, value))
                    mean, log_std, value = (torch.stack(x) for x in zip(*outs))
                    return self._ppo_losses(mean, log_std, value, b_logp[:, idx],
                                            b_val[:, idx], b_act[:, idx], mb_adv,
                                            returns[:, idx], n_mb)

                cont = self._minibatch(loss_fn, cont, stats, norms)
        return stats, norms

    def update(self, st: PPOState, noise: Optional[Tensor] = None,
               perms: Optional[Tensor] = None) -> Tuple[PPOState, Dict[str, Tensor]]:
        """One rollout, GAE and the epochs of minibatch steps; the policy's
        parameters change in place. ``noise`` (n_steps, N, A) and ``perms``
        (n_epochs, n) replace the draws from ``st.gen``."""
        env_state, obs, ep_stats, hidden, tape = self._collect(st, noise)
        advantages, returns = self._advantages(obs, hidden, tape[3], tape[4], tape[6])
        if self.recurrent:
            stats, norms = self._train_recurrent(st.gen, st.hidden, tape, advantages, returns,
                                                 perms)
        else:
            stats, norms = self._train_flat(st.gen, tape, advantages, returns, perms)
        loss, pg_loss, v_loss, ent, clip_frac, approx_kl, applied = torch.stack(stats).mean(0)
        ep_rew, ep_len, succ_rate = episode_stats_means(ep_stats)
        metrics = {
            "loss": loss,
            "pg_loss": pg_loss,
            "value_loss": v_loss,
            "entropy": ent,
            "clip_fraction": clip_frac,
            "approx_kl": approx_kl,
            "update_fraction": applied,  # < 1 when target_kl stopped early
            "ep_rew_mean": ep_rew,
            "ep_len_mean": ep_len,
            "success_rate": succ_rate,
            "reward_mean": all_reduce_(tape[5].mean(), self.mesh, "mean"),
            # the mean global norm, before the clip, of the steps taken
            "grad_norm": torch.stack(norms).mean() if norms else loss.new_zeros(()),
        }
        if self.recurrent:
            hidden = hidden.detach()
        return self._state(env_state, obs, st.gen,
                           st.global_step + self.n_steps * self.env.global_rows[2], ep_stats,
                           hidden), metrics

    # -- host training loop ----------------------------------------------------

    def learn(self, total_timesteps: int, state: Optional[PPOState] = None,
              log_interval: int = 1, log_dir: Optional[str] = None, eval_env=None,
              eval_interval: int = 0) -> PPOState:
        st = self.init() if state is None else state
        logger = self.make_logger(log_dir)
        per = self.n_steps * self.env.global_rows[2]
        n_updates = max(1, int(total_timesteps) // per)
        t0 = time.time()
        try:
            for i in range(n_updates):
                if self.scene_freq and i and i % self.scene_freq == 0:
                    st = self.rotate_scenes(st)
                st, metrics = self.update(st)
                if log_interval and (i % log_interval == 0 or i == n_updates - 1):
                    m = {k: float(v) for k, v in metrics.items()}
                    fps = (i + 1) * per / max(time.time() - t0, 1e-9)
                    print(
                        f"[PPO] update {i + 1}/{n_updates} "
                        f"ep_rew={m['ep_rew_mean']:.3f} ep_len={m['ep_len_mean']:.1f} "
                        f"success={m['success_rate']:.2%} loss={m['loss']:.4f} "
                        f"kl={m['approx_kl']:.4f} fps={fps:.0f}",
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

    def rotate_scenes(self, st: PPOState) -> PPOState:
        """Scene rotation between updates: regenerate the procedural scenes
        with fresh seeds and respawn every agent in them. The carried
        observation is kept, as the JAX trainer keeps it."""
        if self.env.scene is None:
            return st
        return st._replace(env_state=self.env.reset_scenes(st.env_state))

    def predict(self, st: PPOState, obs: Dict[str, Tensor], deterministic: bool = True
                ) -> Tensor:
        """The mean action, clipped. A recurrent policy reads the hidden state
        the trainer carries (or zeros) and drops the GRU's update; rollouts
        thread it through :meth:`predict_step`."""
        with torch.no_grad():
            if self.recurrent:
                hidden = (st.hidden if isinstance(st.hidden, Tensor)
                          else self.policy.initial_hidden(next(iter(obs.values())).shape[0]))
                mean = self.policy(obs, hidden)[0]
            else:
                mean = self.policy(obs)[0]
        return torch.clamp(mean, -1.0, 1.0)

    # recurrent evaluation hooks (TrainerMixin.evaluate)
    def init_predict_carry(self, obs):
        if not self.recurrent:
            return ()
        return self.policy.initial_hidden(next(iter(obs.values())).shape[0])

    def predict_step(self, st: PPOState, obs, carry):
        if not self.recurrent:
            return self.predict(st, obs), carry
        with torch.no_grad():
            mean, _, _, hidden = self.policy(obs, carry)
        return torch.clamp(mean, -1.0, 1.0), hidden

    def mask_predict_carry(self, carry, done):
        if not self.recurrent:
            return carry
        keep = 1.0 - torch.as_tensor(done, device=carry.device).to(carry.dtype)
        return carry * keep[:, None]
