"""The port's SHAC and APG (``visfly_tpu_torch/algos/shac.py``, ``apg.py``)
against ``visfly_tpu/algos``.

Both packages start from the same parameters and env state (the JAX
trainer's initial state crosses over with ``shac_state_from_jax`` /
``apg_state_from_jax``); SHAC's action noise (the action's and the bootstrap
action's of every step) is replayed from the JAX trainer's key splits. The
env is ``NavigationEnv2`` without a camera, 8 agents, H = 8, so that no agent
is done within the horizon (the packages' respawn draws differ) and the
horizon's bootstrap through the target critic is exercised. Tolerances, as
``test_torch_bptt.py`` holds BPTT: the losses within 1e-5, the gradient norm
within 1e-4 relative, every parameter after the update (actor, critic and
target critic) within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax

from visfly_tpu import envs as jenvs
from visfly_tpu.algos import APG as JAPG
from visfly_tpu.algos import SHAC as JSHAC
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import APG, SHAC, APGState, SHACState
from visfly_tpu_torch.interop import (
    actor_params_from_flax,
    apg_state_from_jax,
    policy_params_from_flax,
    shac_state_from_jax,
)

torch.set_num_threads(1)

N, H = 8, 8
ENV = dict(num_agent_per_scene=N, visual=False, requires_grad=True,
           dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=256)
POLICY = {"latent_dim": (32, 32)}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def shac_noise(key):
    """Each step's split into the action's and the bootstrap action's keys."""
    out = np.zeros((2, H, N, 4), np.float32)
    for i in range(H):
        key, k_act, k_next = jax.random.split(key, 3)
        out[0, i] = np.asarray(jax.random.normal(k_act, (N, 4)))
        out[1, i] = np.asarray(jax.random.normal(k_next, (N, 4)))
    return torch.from_numpy(out)


def assert_params_close(module, twin, tol=1e-5):
    for (name, p), q in zip(module.named_parameters(), twin.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=tol, rtol=0,
                                   err_msg=name)


@pytest.fixture(scope="module")
def shac_updated():
    jtr = JSHAC(jenvs.NavigationEnv2(**ENV), horizon=H, gradient_steps=3, policy_kwargs=POLICY)
    jst = jtr.init(jax.random.PRNGKey(0))
    ttr = SHAC(tenvs.NavigationEnv2(device="cpu", **ENV), horizon=H, gradient_steps=3,
               policy_kwargs=POLICY)
    tst = shac_state_from_jax(to_numpy(jst), ttr)
    noise = shac_noise(jst.key)
    (_, (_, _, _, tape)), _ = jax.value_and_grad(jtr._rollout, has_aux=True)(
        jst.actor_params, jst.critic_target_params, jst.env_state, jst.obs, jst.key)
    assert not bool(np.asarray(tape[3]).any()), "an agent was done within the horizon"
    before = {n: p.detach().clone() for n, p in ttr.actor.named_parameters()}
    jst2, m_j = jtr.update(jst)
    tst2, m_t = ttr.update(tst, noise)
    return jst2, to_numpy(m_j), ttr, tst2, m_t, before


def test_shac_update_matches_jax(shac_updated):
    jst2, m_j, ttr, tst2, m_t, before = shac_updated
    for k in ("actor_loss", "critic_loss", "reward_mean", "success_rate"):
        assert abs(float(m_t[k]) - float(m_j[k])) < 1e-5, (k, float(m_t[k]), float(m_j[k]))
    assert float(m_t["grad_norm"]) == pytest.approx(float(m_j["grad_norm"]), rel=1e-4)
    assert float(m_t["grad_norm"]) > 0
    twin = SHAC(ttr.env, horizon=H, policy_kwargs=POLICY)
    twin.build(tst2.obs)
    actor_params_from_flax(to_numpy(jst2.actor_params), twin.actor)
    policy_params_from_flax(to_numpy(jst2.critic_params), twin.critic)
    policy_params_from_flax(to_numpy(jst2.critic_target_params), twin.critic_target)
    assert_params_close(ttr.actor, twin.actor)
    assert_params_close(ttr.critic, twin.critic)
    assert_params_close(ttr.critic_target, twin.critic_target)
    assert any(not torch.equal(before[n], p) for n, p in ttr.actor.named_parameters())
    assert tst2.global_step == int(jst2.global_step) == N * H


def test_shac_state_and_targets(shac_updated):
    """The carried state is detached; the target critic trails the critic
    by Polyak steps and is not trained itself."""
    _, _, ttr, tst2, _, _ = shac_updated
    assert isinstance(tst2, SHACState)
    assert not any(t.requires_grad for t in list(tst2.obs.values()) + [
        t for t in tst2.env_state.dyn if isinstance(t, torch.Tensor)])
    assert all(not p.requires_grad for p in ttr.critic_target.parameters())
    gap = max(float((p - q).abs().max()) for p, q in zip(ttr.critic.parameters(),
                                                         ttr.critic_target.parameters()))
    # 3 Adam steps move a critic parameter by at most 3 × lr = 3e-3; the
    # target follows by τ
    assert 0 < gap <= 3e-3 + 1e-6
    assert all(tst2.critic_target_params[n] is p
               for n, p in ttr.critic_target.named_parameters())


@pytest.fixture(scope="module")
def apg_updated():
    jtr = JAPG(jenvs.NavigationEnv2(**ENV), horizon=H, policy_kwargs=POLICY)
    jst = jtr.init(jax.random.PRNGKey(1))
    ttr = APG(tenvs.NavigationEnv2(device="cpu", **ENV), horizon=H, policy_kwargs=POLICY)
    tst = apg_state_from_jax(to_numpy(jst), ttr)
    jst2, m_j = jtr.update(jst)
    tst2, m_t = ttr.update(tst)
    return jst2, to_numpy(m_j), ttr, tst2, m_t


def test_apg_update_matches_jax(apg_updated):
    jst2, m_j, ttr, tst2, m_t = apg_updated
    for k in ("loss", "reward_mean"):
        assert abs(float(m_t[k]) - float(m_j[k])) < 1e-5, (k, float(m_t[k]), float(m_j[k]))
    assert float(m_t["grad_norm"]) == pytest.approx(float(m_j["grad_norm"]), rel=1e-4)
    twin = APG(ttr.env, horizon=H, policy_kwargs=POLICY)
    twin.build(tst2.obs)
    actor_params_from_flax(to_numpy(jst2.params), twin.actor)
    assert_params_close(ttr.actor, twin.actor)
    assert isinstance(tst2, APGState) and tst2.global_step == N * H
    assert not any(t.requires_grad for t in tst2.obs.values())


def test_apg_masks_rewards_after_done():
    """An agent's rewards stop counting after its first done: with every
    agent done at the first step the loss is minus the first reward."""
    env = tenvs.NavigationEnv2(device="cpu", **dict(ENV, max_episode_steps=1))
    tr = APG(env, horizon=3, policy_kwargs={"latent_dim": (8,)})
    st = tr.init(torch.Generator().manual_seed(0))
    first = tr.env.step(st.env_state, tr.predict(st, st.obs))[1].reward
    loss, (_, _, rewards) = tr._loss(st.env_state, st.obs)
    assert float(loss) == pytest.approx(-float(first.mean()), abs=1e-6)
    assert rewards.shape == (3, N)


@pytest.mark.parametrize("algo", ["shac", "apg"])
def test_learn_predict_and_requires_grad(algo):
    """Both flip the env to ``requires_grad``, learn for a few updates and
    predict deterministically."""
    env = tenvs.HoverEnv(num_agent_per_scene=4, visual=False, device="cpu",
                         dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=6)
    assert not env.requires_grad
    cls = SHAC if algo == "shac" else APG
    tr = cls(env, horizon=4, policy_kwargs={"latent_dim": (8,)})
    assert env.requires_grad
    st = tr.learn(total_timesteps=3 * 4 * 4, log_interval=0)
    assert st.global_step == 3 * 4 * 4
    a = tr.predict(st, st.obs)
    assert torch.equal(a, tr.predict(st, st.obs)) and a.shape == (4, 4)
    assert np.isfinite(tr.evaluate(st, max_steps=3)["eval/ep_rew_mean"])
    cls(tenvs.HoverEnv(num_agent_per_scene=2, device="cpu"), train=False)
