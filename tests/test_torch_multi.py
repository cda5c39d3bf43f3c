"""The port's swarm envs (``visfly_tpu_torch/envs/multi.py``) against
``visfly_tpu``'s, and the swarm crossing run (``python -m visfly_tpu.run -e
crossing -a PPO_tuned``) that ``chip_smoke.py`` path K drives.

States cross over from the JAX env (``interop.env_state_from_numpy``), with
positions injected so that drones come within the collision radius of each
other and whole scenes pass x = 10. Tolerances: state observations, swarm
observations, rewards and collision distances within 1e-5; ``done`` and the
info flags exactly; depth within 1e-3 m on all but 2 pixels per 1,024-pixel
camera; the PPO update: every loss metric within 1e-5, as in
``tests/test_torch_ppo.py``, and every parameter after the update within
2e-5 where that file holds 1e-5: the depth the policy sees differs in the
last bits (the JAX CPU render adds a residual SDF evaluation after the
analytic trace), and Adam turns a gradient entry near zero into a step of up
to the learning rate whatever its rounding (measured: 1.13e-5 on 2 of the 208
entries of the state projection, every other tensor within 6.1e-6).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (module constants before a jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.algos import PPO as JPPO
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import PPO
from visfly_tpu_torch.interop import (env_state_from_numpy, policy_params_from_flax,
                                      ppo_state_from_jax)

torch.set_num_threads(1)

TOL = 1e-5
TOL_DEPTH = 1e-3
S, A = 2, 3
N = S * A
SPAWN = {"state_generator": {"class": "Uniform", "kwargs": [
    {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 2.0, 1.0]}}]}}
DYN = {"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate", "ctrl_delay": True}


def _np(x):
    return np.asarray(x)


def crossing_kwargs(visual=True, res=16, **over):
    kw = dict(num_agent_per_scene=A, num_scene=S, random_kwargs=SPAWN, visual=visual,
              max_episode_steps=256, scene_kwargs={"path": "garage_crossing", "trace_steps": 32},
              dynamics_kwargs=DYN,
              sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [res, res]}])
    kw.update(over)
    return kw


def _assert_depth_close(out, ref, msg):
    off = np.abs(out - ref) > TOL_DEPTH
    assert off.sum(axis=(1, 2, 3)).max() <= 2, (msg, np.argwhere(off))


def _injected(jst, pos):
    return jst._replace(dyn=jst.dyn._replace(pos=jnp.asarray(pos, jnp.float32)))


# scene 0: agents 0 and 1 0.15 m apart (inside two radii), agent 2 alone;
# scene 1: every agent past x = 10, agent 4 0.5 m from agent 5
INJECTED = np.asarray([[3.0, 0.0, 1.5], [3.15, 0.0, 1.5], [3.0, 2.5, 1.2],
                       [10.5, -1.0, 1.5], [10.5, 1.0, 1.5], [10.5, 1.5, 1.5]], np.float32)


@pytest.mark.parametrize("visual", [False, True])
def test_multi_navigation_steps_match_jax(visual):
    """Reset, then 4 ``is_test`` steps from injected positions: the swarm
    observation, the inter-drone override, the per-scene success and done,
    the reward and, with a camera, the depth with the drones in view."""
    jenv = jenvs.MultiNavigationEnv(**crossing_kwargs(visual))
    tenv = tenvs.MultiNavigationEnv(device="cpu", **crossing_kwargs(visual))
    jst, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    tobs = tenv.get_observation(tst, tenv.sensor_observations(tst))
    assert set(tobs) == set(jobs)
    for k, v in jobs.items():
        if k == "depth":
            _assert_depth_close(tobs[k].numpy(), _np(v), "reset")
        else:
            np.testing.assert_allclose(tobs[k].numpy(), _np(v), atol=TOL, rtol=0, err_msg=k)
    jst = _injected(jst, INJECTED)
    tst = tst._replace(dyn=tst.dyn._replace(pos=torch.from_numpy(INJECTED)))
    jstep = jax.jit(lambda s, a: jenv.step(s, a, is_test=True))
    rng = np.random.default_rng(0)
    for i in range(4):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        for k, v in jout.obs.items():
            if k == "depth":
                _assert_depth_close(tout.obs[k].numpy(), _np(v), f"step {i}")
            else:
                np.testing.assert_allclose(tout.obs[k].numpy(), _np(v), atol=TOL, rtol=0,
                                           err_msg=f"step {i} {k}")
        np.testing.assert_allclose(tout.reward.numpy(), _np(jout.reward), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tout.done.numpy(), _np(jout.done))
        for k in ("episode_done", "is_success", "TimeLimit.truncated", "collision"):
            np.testing.assert_array_equal(tout.info[k].numpy(), _np(jout.info[k]), err_msg=k)
        for f in ("point", "vector", "dis"):
            np.testing.assert_allclose(getattr(tst.collision, f).numpy(),
                                       _np(getattr(jst.collision, f)), atol=TOL, rtol=0,
                                       err_msg=f)
        np.testing.assert_array_equal(tst.collision.is_collision.numpy(),
                                      _np(jst.collision.is_collision))
    # what the injection set up: a collision between two drones of scene 0,
    # which ends scene 0 for all three; scene 1 succeeds as a whole
    done = tout.done.numpy().reshape(S, A)
    assert (done == done[:, :1]).all() and done.all()
    assert tst.collision.is_collision[:2].all() and not tst.collision.is_collision[2]
    np.testing.assert_array_equal(tout.info["is_success"].numpy(), [0, 0, 0, 1, 1, 1])
    sw = tout.obs["swarm"].numpy()
    s = tout.obs["state"].numpy()
    assert sw.shape == (N, A - 1, 13)
    np.testing.assert_array_equal(sw[0], s[[1, 2]])
    np.testing.assert_array_equal(sw[4], s[[3, 5]])


def two_drone_kwargs(**over):
    """Two agents of one scene 1.2 m apart at the same height, facing +x."""
    kw = dict(num_scene=1, num_agent_per_scene=2, visual=True, uav_radius=0.25,
              scene_kwargs={"path": "box15_wall_empty"},
              sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}],
              random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                  {"position": {"mean": [1.0, -1.0, 2.0], "half": [0, 0, 0]}},
                  {"position": {"mean": [2.2, -1.0, 2.0], "half": [0, 0, 0]}}]}},
              dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})
    kw.update(over)
    return kw


def test_multi_drone_cameras_see_true_drone_geometry():
    """Mirror of the JAX package's test: agent 0's camera sees agent 1 as a
    flat quadrotor, not its bounding sphere; the depth equals JAX's."""
    env = tenvs.MultiNavigationEnv(device="cpu", **two_drone_kwargs())
    st, obs = env.reset(torch.Generator().manual_seed(0))
    depth = obs["depth"][0, 0].numpy()
    sil = depth < 1.7  # the neighbour is 1.2 m ahead; the walls are 10 m away or more
    assert sil.any()
    ys, xs = np.where(sil)
    w, h = np.ptp(xs) + 1, np.ptp(ys) + 1
    assert w > 1.5 * h
    assert sil.sum() < 0.5 * np.pi * (max(w, h) / 2.0) ** 2
    jenv = jenvs.MultiNavigationEnv(**two_drone_kwargs())
    _, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    _assert_depth_close(obs["depth"].numpy(), _np(jobs["depth"]), "two drones")
    # agent 1 looks away (+x), so it sees no drone; its own body stays invisible
    assert (obs["depth"][1, 0] > 1.7).all()


def test_drones_and_objects_render_together():
    """A swarm env with dynamic objects: the objects (a sphere and a human
    template) come first, then the drones, templates padded to one K;
    colour and semantic renders match JAX."""
    objs = [{"name": "ball", "path": {"class": "circle", "kwargs": {
        "radius": 0.5, "center": [2.5, -1.0, 2.0]}}, "velocity": 1.0, "radius": 0.4},
        {"name": "human", "model_path": "human", "radius": 0.9, "path": {
            "class": "polygon", "kwargs": {"points": [[3.5, -2, 0.2], [3.5, 0, 0.2]]}},
         "velocity": 1.0}]
    sensors = [{"sensor_type": "color", "uuid": "color", "resolution": [32, 32]},
               {"sensor_type": "semantic", "uuid": "semantic", "resolution": [32, 32]}]
    kw = two_drone_kwargs(scene_kwargs={"path": "box15_wall_empty", "obj_settings": objs},
                          sensor_kwargs=sensors)
    jenv = jenvs.MultiNavigationEnv(**kw)
    tenv = tenvs.MultiNavigationEnv(device="cpu", **kw)
    jst, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    got = tenv.render_objects(tst)
    want = jax.tree_util.tree_map(np.asarray, jenv.render_objects(jst))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    out = tenv.sensor_observations(tst)
    ref = jax.jit(jenv.sensor_observations)(jst)
    for k in ("color", "semantic"):
        diff = np.abs(out[k].numpy().astype(int) - _np(ref[k]).astype(int)).max(axis=1)
        assert (diff > 1).sum(axis=(1, 2)).max() <= 2, (k, np.argwhere(diff > 1))
    assert (out["semantic"] == 255).any()


def test_swarm_guards():
    """One agent a scene is refused; the path planner is ported, and so is
    its replan after ``reset_env_by_id`` (without a scene there is no path
    to plan); the drone template is built once on the env's device."""
    with pytest.raises(ValueError, match="should not be 1"):
        tenvs.MultiNavigationEnv(device="cpu", num_agent_per_scene=1, visual=False)
    planning = tenvs.MultiNavigationEnv(device="cpu", num_agent_per_scene=3, visual=False,
                                        scene_kwargs={"path": "garage_crossing",
                                                      "is_find_path": True})
    assert planning.is_find_path and planning.path == [None] * 3
    st = planning.reset_env_by_id(planning.reset(torch.Generator().manual_seed(0))[0], 0)
    assert planning.path == [None] * 3 and st.step_count.tolist() == [0, 0, 0]
    env = tenvs.MultiNavigationEnv(device="cpu", **crossing_kwargs(False))
    assert env._drone_template.shape == (84, 9) and env._drone_template.device.type == "cpu"
    st, _ = env.reset(torch.Generator().manual_seed(0))
    objs = env.render_objects(st)
    assert objs[3].shape == (S, A, 84, 9)
    assert objs[3].data_ptr() == env._drone_template.data_ptr()  # a view, not a copy
    np.testing.assert_array_equal(objs[2][0].numpy(), [[200, 60, 60], [60, 180, 60],
                                                       [70, 90, 220]])


def test_chip_smoke_runs_the_crossing_configs():
    """Path K's settings equal ``env_cfgs/crossing.yaml`` and
    ``alg_cfgs/crossing/PPO_tuned.yaml``, and the trainer takes them: one
    minibatch of 18,432 = 72 agents × 256 steps, 5 epochs."""
    import os

    import yaml

    import chip_smoke

    exps = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "visfly_tpu", "exps")
    with open(os.path.join(exps, "env_cfgs", "crossing.yaml")) as f:
        assert chip_smoke.CROSSING == yaml.safe_load(f)["env"]
    with open(os.path.join(exps, "alg_cfgs", "crossing", "PPO_tuned.yaml")) as f:
        assert chip_smoke.PPO_TUNED_CROSSING == yaml.safe_load(f)["algorithm"]
    env = tenvs.MultiNavigationEnv(device="cpu", **dict(chip_smoke.CROSSING, visual=False))
    tr = PPO(env, **chip_smoke.PPO_TUNED_CROSSING)
    assert env.num_envs == 72 and tr.n_steps * env.num_envs == tr.batch_size == 18432
    assert (tr.n_epochs, tr.n_minibatches) == (5, 1)


STEPS = 4


def test_crossing_ppo_update_matches_jax():
    """One PPO update of the crossing recipe cut to 2 scenes × 3 agents,
    16×16 depth, 4 steps, 2 epochs of 2 minibatches, from the same
    parameters, state and draws (replayed from the JAX trainer's key
    splits). The episode limit is the rollout's length and no drone
    collides, so no respawn draws feed the batch."""
    policy_kwargs = {"pi_layers": [16], "vf_layers": [16], "net_arch": {
        "depth": {"cnn": 16}, "state": {"mlp": [16]}, "target": {"mlp": [8]},
        "swarm": {"mlp": [16]}}}
    kw = dict(n_steps=STEPS, n_epochs=2, batch_size=12, ent_coef=0.003, weight_decay=1e-5,
              policy_kwargs=policy_kwargs)
    env_kw = crossing_kwargs(True, max_episode_steps=STEPS)
    jtr = JPPO(jenvs.MultiNavigationEnv(**env_kw), **kw)
    jst = jtr.init(jax.random.PRNGKey(0))
    ttr = PPO(tenvs.MultiNavigationEnv(device="cpu", **env_kw), **kw)
    tst = ppo_state_from_jax(jax.tree_util.tree_map(np.asarray, jst), ttr)
    key, noise, perms = jst.key, [], []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (N, 4))))
    for _ in range(ttr.n_epochs):
        key, k = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k, N * STEPS)))
    jst2, m_j = jtr.update(jst)
    tst2, m_t = ttr.update(tst, torch.from_numpy(np.stack(noise)),
                           torch.from_numpy(np.stack(perms)))
    assert int(jst2.ep_stats.count) == N  # every episode ended by the time limit
    for k, v in m_j.items():
        assert abs(float(m_t[k]) - float(v)) < 1e-5, (k, float(m_t[k]), float(v))
    twin = PPO(ttr.env, **kw)
    twin.build(tst2.obs)
    policy_params_from_flax(jax.tree_util.tree_map(np.asarray, jst2.params), twin.policy)
    for (name, p), q in zip(ttr.policy.named_parameters(), twin.policy.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)
    assert tst2.obs["swarm"].shape == (N, A - 1, 13) and tst2.obs["depth"].shape == (N, 1, 16, 16)
