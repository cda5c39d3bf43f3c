"""The port's SAC (``visfly_tpu_torch/algos/sac.py``) against
``visfly_tpu/algos/sac.py``.

The JAX trainer collects three env steps into its replay buffer; its state,
buffer included, crosses over with ``sac_state_from_jax``. Then both packages
take one env step and three gradient steps with the same draws, replayed
from the JAX trainer's key splits: the action's noise, and per gradient step
the sample's indices and the noise of the target's and of the actor loss's
actions. The episode limit makes that step a timeout for every agent, so the
stored next observations are the pre-reset ones and the rows are not
terminal. Tolerances: losses and α within 1e-5, absolute up to 1 and
relative above it (the critic's loss is near 5, where float32 resolves
4.8e-7, and the log-probabilities inside it round differently by a few ulps
in the two packages), every parameter (actor, critic, target critic, log α)
within 1e-5, the stored rows within 1e-5.
The squashed Gaussian's ``log(1 − a² + 1e-6)`` amplifies the last ulp of
``tanh`` past |a| = 0.999 (one such action of 768 moved the critic loss by
1.4e-4), so the log-probabilities are compared only inside it: the actor's
log-std bias starts at −2 in both packages (σ ≈ 0.14), and a test checks that
every action the gradient steps sample stays inside |a| < 0.999.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu import envs as jenvs
from visfly_tpu.algos import SAC as JSAC
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import SAC, SACState
from visfly_tpu_torch.algos import buffers as tbuf
from visfly_tpu_torch.interop import (
    actor_params_from_flax,
    policy_params_from_flax,
    sac_state_from_jax,
)

torch.set_num_threads(1)

N, G, B = 8, 3, 32
ENV = dict(num_agent_per_scene=N, visual=False, dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03},
           max_episode_steps=4)
ALGO = dict(buffer_size=64, batch_size=B, gradient_steps=G, learning_starts=0,
            policy_kwargs={"latent_dim": (32, 32)})


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_draws(key, buf_size_after):
    """The draws of ``_step_and_train_impl`` with ``train=True``."""
    key, k_act, k_samp, _k_next, _k_pi = jax.random.split(key, 5)
    draws = {"action": np.asarray(jax.random.normal(k_act, (N, 4))), "index": [], "next": [],
             "pi": []}
    for k in jax.random.split(jax.random.fold_in(k_samp, 1), G):
        k_s, k_n, k_p = jax.random.split(k, 3)
        draws["index"].append(np.asarray(jax.random.randint(k_s, (B,), 0, buf_size_after)))
        draws["next"].append(np.asarray(jax.random.normal(k_n, (B, 4))))
        draws["pi"].append(np.asarray(jax.random.normal(k_p, (B, 4))))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


@pytest.fixture(scope="module")
def sac_updated():
    jtr = JSAC(jenvs.NavigationEnv2(**ENV), **ALGO)
    jst = jtr.init(jax.random.PRNGKey(0))
    p = jst.actor_params["params"]
    log_std = dict(p["log_std"], bias=jnp.full((4,), -2.0))
    jst = jst._replace(actor_params={"params": {**p, "log_std": log_std}})
    for _ in range(3):
        jst, _ = jtr._step_and_train(jst, False)
    ttr = SAC(tenvs.NavigationEnv2(device="cpu", **ENV), **ALGO)
    tst = sac_state_from_jax(to_numpy(jst), ttr)
    draws = jax_draws(jst.key, 4 * N)
    draws["index"] = draws["index"].long()
    jst2, m_j = jtr._step_and_train(jst, True)
    tst2, m_t = ttr.step_and_train(tst, True, draws)
    return jst2, to_numpy(m_j), ttr, tst, tst2, m_t, draws


def test_draws_stay_inside_the_squash(sac_updated):
    """The precondition of the comparison: every action the gradient steps
    sample stays inside |a| < 0.999 (read with the actor after the update;
    each of its steps moves a parameter by at most lr)."""
    _, _, ttr, _, tst2, _, draws = sac_updated
    buf = tst2.buffer
    for g in range(G):
        b_obs, b_next = (tbuf.sample(buf, None, B, draws["index"][g])[i] for i in (0, 1))
        for obs, eps in ((b_next, draws["next"][g]), (b_obs, draws["pi"][g])):
            a, _ = ttr.actor(obs, noise=eps)
            assert float(a.abs().max()) < 0.99
    assert float(ttr.actor.head.log_std.bias.detach().max()) < -1.9


def test_sac_update_matches_jax(sac_updated):
    jst2, m_j, ttr, _, tst2, m_t, _ = sac_updated
    for k in ("reward_mean", "critic_loss", "actor_loss", "alpha"):
        want = float(m_j[k])
        assert abs(float(m_t[k]) - want) < 1e-5 * max(1.0, abs(want)), (k, float(m_t[k]), want)
    assert abs(float(tst2.log_alpha) - float(jst2.log_alpha)) < 1e-5
    assert float(tst2.log_alpha) != 0.0 and float(m_t["grad_norm"]) > 0
    twin = SAC(ttr.env, **ALGO)
    twin.build(tst2.obs)
    actor_params_from_flax(to_numpy(jst2.actor_params), twin.actor)
    policy_params_from_flax(to_numpy(jst2.critic_params), twin.critic)
    policy_params_from_flax(to_numpy(jst2.critic_target_params), twin.critic_target)
    for mine, want in ((ttr.actor, twin.actor), (ttr.critic, twin.critic),
                       (ttr.critic_target, twin.critic_target)):
        for (name, p), q in zip(mine.named_parameters(), want.parameters()):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-5,
                                       rtol=0, err_msg=name)
    assert tst2.global_step == int(jst2.global_step) == 4 * N


def test_replay_rows_match_jax(sac_updated):
    """The stored transitions: the crossed-over rows bit-equal, the new row
    block within 1e-5, its next observations the pre-reset ones (every agent
    timed out) and none terminal."""
    jst2, _, ttr, tst, tst2, _, _ = sac_updated
    jb, tb = to_numpy(jst2.buffer), tst2.buffer
    assert tb.pos == int(jb.pos) == 4 * N and not tb.full
    old, new = slice(0, 3 * N), slice(3 * N, 4 * N)
    for k in jb.obs:
        np.testing.assert_array_equal(tb.obs[k][old].numpy(), jb.obs[k][old])
        np.testing.assert_allclose(tb.obs[k][new].numpy(), jb.obs[k][new], atol=1e-5)
        np.testing.assert_allclose(tb.next_obs[k][new].numpy(), jb.next_obs[k][new], atol=1e-5)
    np.testing.assert_allclose(tb.actions.numpy(), jb.actions, atol=1e-5)
    np.testing.assert_allclose(tb.rewards.numpy(), jb.rewards, atol=1e-5)
    assert not bool(tb.dones.any()) and not jb.dones.any()
    # pre-reset next observations: far from the respawned agents' observations
    gap = (tb.next_obs["state"][new] - tst2.obs["state"]).abs().amax(-1)
    assert bool((gap > 1e-3).all())


def test_collect_only_and_gradient_steps_semantics():
    env = tenvs.HoverEnv(num_agent_per_scene=4, visual=False, device="cpu",
                         dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=8)
    with pytest.raises(ValueError, match="gradient_steps"):
        SAC(env, gradient_steps=-2)
    assert SAC(env, gradient_steps=-1).gradient_steps == 4
    assert env.terminal_obs_in_info
    tr = SAC(env, buffer_size=16, batch_size=8, gradient_steps=2, learning_starts=8,
             policy_kwargs={"latent_dim": (8,)})
    st = tr.init(torch.Generator().manual_seed(0))
    assert isinstance(st, SACState) and st.log_alpha is tr.log_alpha
    params = {n: p.detach().clone() for n, p in tr.actor.named_parameters()}
    st, m = tr.step_and_train(st, False)
    assert float(m["critic_loss"]) == 0.0 and "grad_norm" not in m
    assert all(torch.equal(params[n], p) for n, p in tr.actor.named_parameters())
    st = tr.learn(total_timesteps=6 * 4, state=st, log_interval=0)
    assert st.buffer.full and st.buffer.pos == (7 * 4) % 16
    assert any(not torch.equal(params[n], p) for n, p in tr.actor.named_parameters())
    a = tr.predict(st, st.obs)
    assert torch.equal(a, tr.predict(st, st.obs)) and float(a.abs().max()) <= 1.0
