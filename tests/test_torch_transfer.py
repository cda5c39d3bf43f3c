"""The port's actor → PPO transplant (``visfly_tpu_torch/policies/transfer.py``)
against ``visfly_tpu/policies/transfer.py``, and
``tests/test_algos.py::test_actor_to_policy_transplant`` on the port's
trainers.

The JAX parameters cross over with ``interop``; the transplant of the port
is held to the JAX transplant carried across, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.policies import networks as jn
from visfly_tpu.policies.transfer import actor_to_policy_params as jax_transfer
from visfly_tpu_torch.algos import BPTT, PPO
from visfly_tpu_torch.envs import HoverEnv
from visfly_tpu_torch.interop import policy_params_from_flax
from visfly_tpu_torch.policies import actor_to_policy_params
from visfly_tpu_torch.policies import networks as tn

torch.set_num_threads(1)

ARCH = {"depth": {"cnn": 16}, "state": {"mlp": [16]}}
SHAPES = {"depth": (1, 16, 16), "state": (13,)}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def hover_env(**kw):
    kw.setdefault("num_agent_per_scene", 16)
    return HoverEnv(visual=False, dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03},
                    max_episode_steps=64, device="cpu", **kw)


def test_transplant_matches_jax():
    rng = np.random.default_rng(0)
    obs = {"depth": rng.uniform(0, 1, (3, 1, 16, 16)).astype(np.float32),
           "state": rng.normal(size=(3, 13)).astype(np.float32)}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    ja = jn.Actor(net_arch=ARCH, latent_dim=(24, 24))
    jp = jn.ActorCriticPolicy(net_arch=ARCH, pi_layers=(24, 24), vf_layers=(8,))
    a_params = ja.init(jax.random.PRNGKey(0), jobs)
    p_params = jp.init(jax.random.PRNGKey(1), jobs)
    want = jax_transfer(a_params, p_params, log_std=-0.7)

    actor = policy_params_from_flax(to_numpy(a_params), tn.Actor(SHAPES, net_arch=ARCH,
                                                                 latent_dim=(24, 24)))
    policy = policy_params_from_flax(to_numpy(p_params), tn.ActorCriticPolicy(
        SHAPES, net_arch=ARCH, pi_layers=(24, 24), vf_layers=(8,)))
    before = {k: v.clone() for k, v in policy.state_dict().items()}
    got = actor_to_policy_params(actor, policy, log_std=-0.7)
    # the inputs are unchanged
    for k, v in policy.state_dict().items():
        assert torch.equal(v, before[k]), k
    ref = policy_params_from_flax(to_numpy(want), tn.ActorCriticPolicy(
        SHAPES, net_arch=ARCH, pi_layers=(24, 24), vf_layers=(8,))).state_dict()
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    policy.load_state_dict(got)
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    mean, log_std, _ = policy(tobs)
    jmean, _, _ = jp.apply(want, jobs)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), atol=1e-5, rtol=0)
    assert torch.equal(log_std, torch.full_like(log_std, -0.7))
    kept = actor_to_policy_params(actor.state_dict(), policy.state_dict(), log_std=None)
    assert torch.equal(kept["heads.log_std"], policy.heads.log_std.detach())


def test_actor_to_policy_transplant():
    """A BPTT actor transplanted into a PPO policy gives the actor's mean,
    so tanh of the PPO mean is the actor's squashed action; the value branch
    keeps its own values and PPO trains; a mismatched architecture raises."""
    bptt = BPTT(hover_env(requires_grad=True), horizon=4, learning_rate=1e-3,
                policy_kwargs={"latent_dim": (32, 32)})
    st_b = bptt.init()
    st_b, _ = bptt.update(st_b)  # move off the init point

    ppo = PPO(hover_env(), n_steps=8, n_epochs=1,
              policy_kwargs={"pi_layers": [32, 32], "vf_layers": [32, 32]})
    st_p = ppo.init(torch.Generator().manual_seed(1))
    vf_before = {k: v.clone() for k, v in ppo.policy.state_dict().items() if "_vf" in k
                 or "value" in k}
    ppo.policy.load_state_dict(actor_to_policy_params(bptt.actor, ppo.policy, log_std=-0.7))

    _, obs = ppo.env.reset(torch.Generator().manual_seed(2))
    with torch.no_grad():
        mean, log_std, _ = ppo.policy(obs)
        pre_tanh = bptt.actor.head.mu(bptt.actor.latent(bptt.actor.extractor(obs)))
    assert torch.equal(mean, pre_tanh)
    torch.testing.assert_close(torch.tanh(mean), bptt.predict(st_b, obs), atol=1e-6, rtol=0)
    torch.testing.assert_close(log_std, torch.full_like(log_std, -0.7), atol=1e-6, rtol=0)
    for k, v in vf_before.items():
        assert torch.equal(ppo.policy.state_dict()[k], v), k

    st_p, m = ppo.update(st_p)
    assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(ppo.policy.state_dict()[k], v) for k, v in vf_before.items())

    ppo_bad = PPO(hover_env(), n_steps=8, n_epochs=1,
                  policy_kwargs={"pi_layers": [64, 64], "vf_layers": [32]})
    ppo_bad.init(torch.Generator().manual_seed(3))
    with pytest.raises(ValueError, match="shape .* PPO pi_layers"):
        actor_to_policy_params(bptt.actor, ppo_bad.policy)
    with pytest.raises(ValueError, match="structure mismatch"):
        actor_to_policy_params(bptt.actor, PPO(hover_env(), n_steps=8, policy_kwargs={
            "pi_layers": [32], "vf_layers": [32]}).build(obs))
    with pytest.raises(ValueError, match="no 'extractor' module"):
        actor_to_policy_params({}, ppo.policy)
