"""The port's world model (``visfly_tpu_torch/policies/world_model.py``) and
the env's latent hooks against ``visfly_tpu/policies/world_model.py`` and
``visfly_tpu/envs/base.py``.

The flax parameters cross over with ``interop.world_model_params_from_flax``,
env states (latents included) with ``env_state_from_numpy``. The Gaussian
noise the JAX model draws from its key is computed here from the same key and
handed to the port as ``noise``: outputs within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.envs import HoverEnv as JHover
from visfly_tpu.policies import world_model as jwm
from visfly_tpu_torch.envs import HoverEnv as THover
from visfly_tpu_torch.interop import env_state_from_numpy, world_model_params_from_flax
from visfly_tpu_torch.policies import world_model as twm

torch.set_num_threads(1)

TOL = 1e-5
N, DETER, STOCH = 4, 16, 8
DYN = {"dt": 0.03, "ctrl_dt": 0.03}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol, rtol=0)


def observations(seed=0):
    rng = np.random.default_rng(seed)
    return {"state": rng.normal(size=(N, 13)).astype(np.float32),
            "target": rng.normal(size=(N, 3)).astype(np.float32)}


def worlds(obs, seed=0):
    jw = jwm.create_world_model({k: jnp.asarray(v) for k, v in obs.items()}, deter_dim=DETER,
                                stoch_dim=STOCH, key=jax.random.PRNGKey(seed))
    tw = twm.create_world_model({k: t(v) for k, v in obs.items()}, deter_dim=DETER,
                                stoch_dim=STOCH)
    return jw, world_model_params_from_flax(to_numpy(jw.params), tw)


def test_world_model_parts_match_jax():
    obs = observations()
    jw, tw = worlds(obs)
    rng = np.random.default_rng(1)
    action = rng.uniform(-1, 1, size=(N, 4)).astype(np.float32)
    stoch = rng.normal(size=(N, STOCH)).astype(np.float32)
    deter = rng.normal(size=(N, DETER)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in obs.items()}
    o = {k: t(v) for k, v in obs.items()}
    key = jax.random.PRNGKey(5)

    # imagine: the prior, deterministic and with the key's noise
    jp, jd = jw.imagine(jnp.asarray(action), jnp.asarray(stoch), jnp.asarray(deter), key)
    noise = t(jax.random.normal(key, (N, STOCH)))
    tp, td = tw.imagine(t(action), t(stoch), t(deter), noise=noise)
    close(tp, jp)
    close(td, jd)
    jm, _ = jw.imagine(jnp.asarray(action), jnp.asarray(stoch), jnp.asarray(deter))
    tm, _ = tw.imagine(t(action), t(stoch), t(deter))
    close(tm, jm)
    assert not np.allclose(np.asarray(jm), np.asarray(jp))
    # the log-std is clipped to [-5, 2]: the noise scale stays inside
    scale = (tp - tm).abs() / noise.abs().clamp(min=1e-6)
    assert float(scale.detach().max()) <= np.exp(2.0) * (1 + 1e-5)

    # step: the posterior; the key splits into the prior's and the posterior's noise
    js, jd = jw.step(jnp.asarray(action), jnp.asarray(stoch), jnp.asarray(deter), j, key)
    k1, k2 = jax.random.split(key)
    pair = (t(jax.random.normal(k1, (N, STOCH))), t(jax.random.normal(k2, (N, STOCH))))
    ts, td = tw.step(t(action), t(stoch), t(deter), o, noise=pair)
    close(ts, js)
    close(td, jd)
    js, _ = jw.step(jnp.asarray(action), jnp.asarray(stoch), jnp.asarray(deter), j, key,
                    deterministic=True)
    ts, _ = tw.step(t(action), t(stoch), t(deter), o, generator=torch.Generator(),
                    deterministic=True)
    close(ts, js)

    # the parts on their own, and decode
    close(tw.encoder(o, t(deter)), jw.encoder.apply(jw.params["encoder"], j, jnp.asarray(deter)))
    close(tw.decode(t(deter), t(stoch)), jw.decode(jnp.asarray(deter), jnp.asarray(stoch)))
    assert tuple(tw.decode(t(deter), t(stoch)).shape) == (N, 13)
    init = tw.sequence.initial(N)
    assert init["deter"].shape == (N, DETER) and not init["stoch"].any()


def test_world_model_draws_from_the_generator():
    obs = {k: t(v) for k, v in observations().items()}
    tw = twm.create_world_model(obs, deter_dim=DETER, stoch_dim=STOCH)
    a, s, d = torch.zeros(N, 4), torch.zeros(N, STOCH), torch.zeros(N, DETER)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    x1, _ = tw.step(a, s, d, obs, generator=g1)
    x2, _ = tw.step(a, s, d, obs, generator=g2)
    x3, _ = tw.step(a, s, d, obs, generator=g1)
    mean, _ = tw.step(a, s, d, obs)
    assert torch.equal(x1, x2) and not torch.equal(x1, x3) and not torch.equal(x1, mean)


class _Replay(twm.WorldModel):
    """The port's world model handed the JAX env's noise, step by step."""

    def __init__(self, world, noise):
        super().__init__(world.sequence, world.encoder, world.decoder)
        self.noise = list(noise)

    def step(self, action, stoch, deter, obs, generator=None, deterministic=False, noise=None):
        return super().step(action, stoch, deter, obs, noise=self.noise.pop(0))


def _env_noise(state_key):
    """The (prior, posterior) noise the JAX env's world model draws in the
    step from ``state_key``: ``fold_in(split(key, 3)[0], 23)``, split."""
    key = jax.random.fold_in(jax.random.split(state_key, 3)[0], 23)
    k1, k2 = jax.random.split(key)
    return tuple(t(jax.random.normal(k, (N, STOCH))) for k in (k1, k2))


def test_latent_env_matches_jax():
    """``test_world_model_and_latent_env`` on both packages: HoverEnv with 4
    agents and a world model; the states and latents carried across; two
    steps, the second with two agents at their last step (``is_test``: done,
    not respawned), whose latents are zeroed before the posterior update."""
    jenv = JHover(num_agent_per_scene=N, visual=False, dynamics_kwargs=DYN, max_episode_steps=8)
    tenv = THover(num_agent_per_scene=N, visual=False, dynamics_kwargs=DYN, max_episode_steps=8,
                  device="cpu")
    _, jobs = jenv.reset(jax.random.PRNGKey(0))
    jw, tw = worlds({k: np.asarray(v) for k, v in jobs.items()})
    jenv.initialize_latent(DETER, STOCH, world=jw)
    jst, jobs = jenv.reset(jax.random.PRNGKey(0))
    assert jobs["deter"].shape == (N, DETER) and jobs["stoch"].shape == (N, STOCH)
    jstep = jax.jit(jenv.step, static_argnames="is_test")
    rng = np.random.default_rng(2)

    # one JAX step first, so that the latents are non-zero when they cross
    jst, _ = jstep(jst, jnp.asarray(rng.uniform(-0.3, 0.3, (N, 4)).astype(np.float32)))
    jst = jst._replace(step_count=jst.step_count.at[:2].set(7))
    tst = env_state_from_numpy(to_numpy(jst))
    assert len(tst.latent) == 2 and float(tst.latent[0].abs().max()) > 0
    for i in range(2):
        a = rng.uniform(-0.3, 0.3, (N, 4)).astype(np.float32) + 0.2 * i
        replay = _Replay(tw, [_env_noise(jst.key)])
        tenv.initialize_latent(DETER, STOCH, world=replay)
        jst, jout = jstep(jst, jnp.asarray(a), is_test=True)
        tst, tout = tenv.step(tst, t(a), is_test=True)
        assert set(tout.obs) == set(jout.obs) == {"state", "deter", "stoch"}
        for k in tout.obs:
            close(tout.obs[k], jout.obs[k], 1e-4 if k == "state" else TOL)
        for a_, b_ in zip(tst.latent, jst.latent):
            close(a_, b_)
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
    assert tout.done[:2].all() and not tout.done[2:].any()
    recon = tw.decode(tout.obs["deter"], tout.obs["stoch"])
    assert tuple(recon.shape) == (N, 13)


def test_done_agents_latents_zeroed_before_the_update():
    env = THover(num_agent_per_scene=N, visual=False, dynamics_kwargs=DYN, max_episode_steps=3,
                 device="cpu")
    st, obs = env.reset(torch.Generator().manual_seed(0))
    world = twm.create_world_model(obs, deter_dim=DETER, stoch_dim=STOCH)
    env.initialize_latent(DETER, STOCH, world=world)
    st, obs = env.reset(torch.Generator().manual_seed(0))
    assert not obs["deter"].any() and not obs["stoch"].any()
    a = torch.full((N, 4), 0.2)
    for _ in range(2):
        st, out = env.step(st, a)
    before = tuple(x.clone() for x in st.latent)
    gen_state = st.gen.get_state()
    st, out = env.step(st, a, is_test=True)  # the third step: every agent done
    assert out.done.all()
    # replay with the same draws (a test step of HoverEnv draws nothing
    # before the world model): zeroed latents through the world model
    g = torch.Generator()
    g.set_state(gen_state)
    zeros = [torch.zeros_like(x) for x in before]
    stoch, deter = world.step(a, zeros[1], zeros[0], {"state": out.obs["state"]}, g)
    torch.testing.assert_close(out.obs["deter"], deter, atol=0, rtol=0)
    torch.testing.assert_close(out.obs["stoch"], stoch, atol=0, rtol=0)
    g.set_state(gen_state)
    stoch_nz, _ = world.step(a, before[1], before[0], {"state": out.obs["state"]}, g)
    assert not torch.allclose(stoch_nz, stoch)


@pytest.mark.parametrize("terminal", [False, True])
def test_latents_without_a_world_model_stay_zero(terminal):
    env = THover(num_agent_per_scene=N, visual=False, dynamics_kwargs=DYN, latent_dim=6,
                 device="cpu")
    env.terminal_obs_in_info = terminal
    st, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs["deter"].shape == (N, 6) and obs["stoch"].shape == (N, 6)
    for _ in range(3):
        st, out = env.step(st, torch.full((N, 4), 0.1))
    for k in ("deter", "stoch"):
        assert not out.obs[k].any()
        if terminal:
            assert k in out.info["terminal_observation"]
    assert env.obs_space()["deter"][0] == (6,)
