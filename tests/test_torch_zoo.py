"""The rest of the port's env zoo (``racing.py``, ``tracking.py``,
``catch.py``, ``dynamic.py``, ``controller.py``, ``ENV_ALIASES``) against
``visfly_tpu``'s, and the settings of ``chip_smoke.py`` path M.

Each env resets in the JAX package; its state and aux cross over
(``interop.env_state_from_numpy``); both step 6 times with the same actions
and ``is_test=True``. Tolerances: observations, rewards, collision
distances and aux within 1e-5 (the gate index and flags exactly); depth
within 1e-3 m on all but 2 pixels per 1,024-pixel camera; controller
thrusts within 1e-5 N.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (module constants before a jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.dynamics import DroneConfig as JDroneConfig
from visfly_tpu.dynamics import init_state as jinit_state
from visfly_tpu.dynamics import make_drone_params as jmake_params
from visfly_tpu.envs import controller as jctrl
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import BPTT, PPO
from visfly_tpu_torch.dynamics import DroneConfig, init_state, make_drone_params
from visfly_tpu_torch.envs import controller as tctrl
from visfly_tpu_torch.interop import dyn_state_from_numpy, env_state_from_numpy

torch.set_num_threads(1)

TOL = 1e-5
N = 4
DYN = {"dt": 0.03, "ctrl_dt": 0.03}


def _np(x):
    return np.asarray(x)


def test_env_aliases_match_jax():
    assert set(tenvs.ENV_ALIASES) == set(jenvs.ENV_ALIASES)
    for k, cls in tenvs.ENV_ALIASES.items():
        assert cls.__name__ == jenvs.ENV_ALIASES[k].__name__


CASES = {
    "racing": ("RacingEnv", {}),
    "racing2": ("RacingEnv2", {}),
    "tracking": ("TrackEnv", {}),
    "tracking2": ("TrackEnv2", {"visual": True, "scene_kwargs": {"path": "box15_wall_empty"}}),
    "catch": ("CatchEnv", {}),
    "dynamic": ("DynEnv", {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_env_steps_match_jax(case):
    cls, kw = CASES[case]
    kw = dict(dict(num_agent_per_scene=N, visual=False, dynamics_kwargs=DYN), **kw)
    jenv = getattr(jenvs, cls)(**kw)
    tenv = getattr(tenvs, cls)(device="cpu", **kw)
    jst, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    assert type(tst.aux).__name__ == type(jst.aux).__name__
    jstep = jax.jit(lambda s, a: jenv.step(s, a, is_test=True))
    if case.startswith("racing"):
        # one agent on its gate: the pass, the bonus and the advance
        gate = _np(jenv.targets)[int(jst.aux.next_target_i[0])]
        pos = _np(jst.dyn.pos).copy()
        pos[0] = gate
        jst = jst._replace(dyn=jst.dyn._replace(pos=jnp.asarray(pos)))
        tst = tst._replace(dyn=tst.dyn._replace(pos=torch.from_numpy(pos)))
    rng = np.random.default_rng(1)
    for i in range(6):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        assert set(tout.obs) == set(jout.obs)
        for k, v in jout.obs.items():
            x = tout.obs[k].numpy()
            assert x.dtype == _np(v).dtype, k
            if k == "depth":
                off = np.abs(x - _np(v)) > 1e-3
                assert off.sum(axis=(1, 2, 3)).max() <= 2, (i, np.argwhere(off))
            else:
                np.testing.assert_allclose(x, _np(v), atol=TOL, rtol=0, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(tout.reward.numpy(), _np(jout.reward), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tout.done.numpy(), _np(jout.done))
        for k in ("episode_done", "is_success", "TimeLimit.truncated", "collision"):
            np.testing.assert_array_equal(tout.info[k].numpy(), _np(jout.info[k]), err_msg=k)
        for f, v in zip(jst.aux._fields if jst.aux != () else (), jst.aux):
            np.testing.assert_allclose(getattr(tst.aux, f).numpy(), _np(v), atol=TOL, rtol=0,
                                       err_msg=f"step {i} aux {f}")
        np.testing.assert_allclose(tst.collision.dis.numpy(), _np(jst.collision.dis), atol=TOL)
    if case.startswith("racing"):
        assert int(tst.aux.past_targets[0]) == 1


def test_racing_env_gate_progression():
    """Mirror of the JAX package's test: the quadrant rule chooses the first
    gate; an agent teleported onto its gate passes it on the next step."""
    env = tenvs.RacingEnv(num_agent_per_scene=N, visual=False, device="cpu",
                          dynamics_kwargs=DYN)
    assert len(env.randomizers) == 4  # the Union spawn
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs["gate"].shape == (N, 1) and obs["gate"].dtype == torch.int32
    for g, p in zip(state.aux.next_target_i.tolist(), state.dyn.pos.numpy()):
        rel = p - np.asarray([4.0, 0.0, 1.0])
        if rel[0] < 0:
            assert g == (0 if rel[1] > 0 else 3)
    target = env.targets[state.aux.next_target_i[0].long()]
    pos = state.dyn.pos.clone()
    pos[0] = target
    state = state._replace(dyn=state.dyn._replace(pos=pos))
    state2, out = env.step(state, torch.zeros(N, 4), is_test=True)
    assert bool(state2.aux.is_pass_next[0]) and int(state2.aux.past_targets[0]) == 1
    assert float(out.reward[0]) > 10
    # the auto-reset chooses the gate again from the new spawn
    state3 = env.reset_agents(state2, torch.tensor([True, False, False, False]))
    assert int(state3.aux.past_targets[0]) == 0 and not bool(state3.aux.is_pass_next[0])


def test_tracking_env_waypoints():
    env = tenvs.TrackEnv(num_agent_per_scene=N, visual=False, device="cpu", dynamics_kwargs=DYN)
    state, obs = env.reset(torch.Generator().manual_seed(0))
    assert obs["state"].shape == (N, 30 + 10)
    wp = env.waypoints(state.dyn.t).numpy()
    assert wp.shape == (N, 10, 3)
    np.testing.assert_allclose(np.linalg.norm(wp[:, :, :2] - np.asarray([2.0, 0.0]), axis=-1),
                               2.0, atol=1e-5)
    t = torch.tensor([0.0, 0.7, 3.1, 9.9])
    jenv = jenvs.TrackEnv(num_agent_per_scene=N, visual=False, dynamics_kwargs=DYN)
    np.testing.assert_allclose(env.waypoints(t).numpy(), _np(jenv.waypoints(jnp.asarray(t))),
                               atol=TOL, rtol=0)


def test_catch_env_ballistics_and_training():
    """Mirror of the JAX package's test: the ball falls ballistically at
    ``ball_dt``, ``grounded`` latches below z = 0.1, and a BPTT update gives
    a finite loss and a gradient."""
    env = tenvs.CatchEnv(num_agent_per_scene=8, requires_grad=True, device="cpu",
                         dynamics_kwargs=DYN, max_episode_steps=32)
    state, obs = env.reset(torch.Generator().manual_seed(0))
    z0, v0 = state.aux.pos[:, 2].clone(), state.aux.vel[:, 2].clone()
    assert obs["ball"].shape == (8, 6)
    # the spawn: x = 1, y within ±2, z within 1.5 ± 1, no vertical speed
    assert (state.aux.pos[:, 0] == 1.0).all() and (state.aux.pos[:, 1].abs() <= 2).all()
    assert (state.aux.vel[:, 2] == 0).all()
    a = torch.zeros(8, 4)
    state, out = env.step(state, a)
    torch.testing.assert_close(state.aux.pos[:, 2], z0 + v0 * env.ball_dt, atol=1e-5, rtol=0)
    torch.testing.assert_close(state.aux.vel[:, 2], v0 - 9.8 * env.ball_dt, atol=1e-5, rtol=0)
    for _ in range(10):
        state, out = env.step(state, a)
    assert torch.isfinite(out.reward).all()
    tr = BPTT(env, horizon=4, policy_kwargs={"latent_dim": (16,)})
    st = tr.init(torch.Generator().manual_seed(1))
    st, m = tr.update(st)
    assert np.isfinite(float(m["actor_loss"])) and float(m["grad_norm"]) > 0


@pytest.mark.parametrize("name", ["ThrustController", "BodyrateController",
                                  "VelocityController", "PositionController"])
def test_controllers_match_jax(name):
    """Each controller's thrusts for random commands and states equal the
    JAX package's within 1e-5 N, whatever the config's own action type;
    they are finite and non-negative (mirror of ``test_controllers``)."""
    cfg_j, cfg_t = JDroneConfig(**DYN), DroneConfig(**DYN)
    params_j = jmake_params(cfg_j)
    params_t = make_drone_params(cfg_t, device="cpu")
    rng = np.random.default_rng(5)
    st_j = jinit_state(cfg_j, params_j, 16)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    q[:, 0] += 3.0
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    st_j = st_j._replace(pos=jnp.asarray(rng.uniform(-2, 2, (16, 3)), jnp.float32),
                         q=jnp.asarray(q),
                         vel=jnp.asarray(rng.uniform(-1, 1, (16, 3)), jnp.float32),
                         omega=jnp.asarray(rng.uniform(-1, 1, (16, 3)), jnp.float32))
    st_t = dyn_state_from_numpy(jax.tree_util.tree_map(np.asarray, st_j))
    a = rng.uniform(-1, 1, (16, 4)).astype(np.float32)
    got = getattr(tctrl, name)(cfg_t, params_t)(st_t, torch.from_numpy(a)).numpy()
    want = _np(getattr(jctrl, name)(cfg_j, params_j)(st_j, jnp.asarray(a)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got.shape == (16, 4) and np.isfinite(got).all() and (got >= 0).all()
    zero = getattr(tctrl, name)(cfg_t, params_t)(init_state(cfg_t, params_t, 4), torch.zeros(4, 4))
    assert (zero.numpy() >= 0).all()


def test_chip_smoke_runs_the_zoo_configs():
    """Path M's settings equal their YAML files (racing2 with PPO, tracking
    with BPTT and its env override) and the trainers take them."""
    import os

    import yaml

    import chip_smoke

    exps = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "visfly_tpu", "exps")

    def load(*parts):
        with open(os.path.join(exps, *parts)) as f:
            return yaml.safe_load(f)

    assert chip_smoke.RACING2 == load("env_cfgs", "racing2.yaml")["env"]
    assert chip_smoke.PPO_RACING2 == load("alg_cfgs", "racing2", "PPO.yaml")["algorithm"]
    bptt = load("alg_cfgs", "tracking", "BPTT.yaml")
    assert chip_smoke.TRACKING == load("env_cfgs", "tracking.yaml")["env"]
    assert chip_smoke.TRACKING_BPTT_ENV == bptt["env"]
    assert chip_smoke.BPTT_TRACKING == bptt["algorithm"]
    tr = PPO(tenvs.RacingEnv2(device="cpu", **chip_smoke.RACING2), **chip_smoke.PPO_RACING2)
    assert (tr.n_steps, tr.n_epochs, tr.n_minibatches) == (256, 10, 1)
    assert tr.env.num_envs * tr.n_steps == tr.batch_size == 16384
    env = tenvs.TrackEnv(device="cpu", **dict(chip_smoke.TRACKING, **chip_smoke.TRACKING_BPTT_ENV))
    tr = BPTT(env, **chip_smoke.BPTT_TRACKING)
    assert tr.H == 48 and env.requires_grad and env.num_envs == 64
