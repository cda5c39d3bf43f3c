"""The depth-leg slice end to end: the port's ``NavigationEnv`` against
``visfly_tpu``'s, with the bench configuration cut to 4 agents and 16×64
depth.

The JAX env resets; its state crosses over through ``interop``; both then
step 8 times with the same numpy actions and ``is_test=True``. Depth agrees
within 1e-3 m (the JAX CPU path adds one residual SDF evaluation after the
analytic trace) on all but at most 2 of the 1024 pixels per camera: on a
grazing or silhouette ray the last-ulp differences of the two float32
dynamics and ray rotations move t by more (measured: one pixel in 32768 off
by 1.6e-3 m). State obs, reward and collision distance/vector agree within
1e-4, ``done`` exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu import envs as jenvs
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.interop import env_state_from_numpy
from visfly_tpu_torch.scene import point_is_collision

torch.set_num_threads(1)

TOL_DEPTH = 1e-3
TOL = 1e-4
N = 4
SPAWN_MEAN = np.asarray([1.0, 0.0, 1.5])
SPAWN_HALF = np.asarray([0.5, 2.0, 1.0])


def bench_kwargs(visual=True, **over):
    kw = dict(
        num_agent_per_scene=N,
        visual=visual,
        scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": 40},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 64]}],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": SPAWN_MEAN.tolist(), "half": SPAWN_HALF.tolist()}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        max_episode_steps=256,
    )
    kw.update(over)
    return kw


def _np(x):
    return np.asarray(x)


def _assert_depth_close(out, ref, msg, max_off_per_camera=2):
    off = np.abs(out - ref) > TOL_DEPTH  # (N, 1, H, W)
    assert off.sum(axis=(1, 2, 3)).max() <= max_off_per_camera, (msg, np.argwhere(off))
    np.testing.assert_allclose(out[~off], ref[~off], atol=TOL_DEPTH, rtol=0, err_msg=msg)


@pytest.mark.parametrize("cls,visual", [("NavigationEnv", True), ("NavigationEnv2", True),
                                        ("NavigationEnv", False)])
def test_slice_matches_jax(cls, visual):
    jenv = getattr(jenvs, cls)(**bench_kwargs(visual))
    tenv = getattr(tenvs, cls)(**bench_kwargs(visual))
    jst, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    jstep = jax.jit(lambda s, a: jenv.step(s, a, is_test=True))
    rng = np.random.default_rng(0)
    for i in range(8):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        assert set(tout.obs) == set(jout.obs)
        for k, v in jout.obs.items():
            if k == "depth":
                _assert_depth_close(tout.obs[k].numpy(), _np(v), f"step {i}")
            else:
                np.testing.assert_allclose(tout.obs[k].numpy(), _np(v), atol=TOL, rtol=0,
                                           err_msg=f"step {i} obs {k}")
        np.testing.assert_allclose(tout.reward.numpy(), _np(jout.reward), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tout.done.numpy(), _np(jout.done))
        np.testing.assert_allclose(tst.collision.dis.numpy(), _np(jst.collision.dis),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tst.collision.vector.numpy(), _np(jst.collision.vector),
                                   atol=TOL, rtol=0)
        for k in ("episode_done", "is_success", "TimeLimit.truncated", "collision"):
            np.testing.assert_array_equal(tout.info[k].numpy(), _np(jout.info[k]), err_msg=k)
    if visual:
        depth = tout.obs["depth"]
        assert depth.shape == (N, 1, 16, 64) and depth.dtype == torch.float32
        assert (depth < 20.0).float().mean() > 0.5


def test_reset_observations_match_jax():
    """Observations right after reset, from the same spawn state."""
    jenv = jenvs.NavigationEnv(**bench_kwargs())
    tenv = tenvs.NavigationEnv(**bench_kwargs())
    jst, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(1))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    tobs = tenv.get_observation(tst, tenv.sensor_observations(tst))
    for k, v in jobs.items():
        if k == "depth":
            _assert_depth_close(tobs[k].numpy(), _np(v), "reset")
        else:
            np.testing.assert_allclose(tobs[k].numpy(), _np(v), atol=TOL, rtol=0)


def test_auto_reset_respawns_inside_bounds_collision_free():
    """With auto-reset on, agents that end an episode respawn inside the
    sampler's box, collision-free at radius 1 m, with fresh bookkeeping."""
    env = tenvs.NavigationEnv(**bench_kwargs(max_episode_steps=3, num_agent_per_scene=16))
    st, obs = env.reset(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    respawned = 0
    for _ in range(7):
        a = torch.rand((16, 4), generator=g) * 0.6 - 0.3
        st, out = env.step(st, a)
        done = out.done
        respawned += int(done.sum())
        pos = st.dyn.pos[done].numpy()
        assert (pos >= SPAWN_MEAN - SPAWN_HALF - 1e-6).all()
        assert (pos <= SPAWN_MEAN + SPAWN_HALF + 1e-6).all()
        assert not point_is_collision(env.scene, st.dyn.pos[done], radius=1.0).any()
        assert (st.step_count[done] == 0).all() and (st.returns[done] == 0).all()
        assert not st.episode_done[done].any()
        np.testing.assert_array_equal(st.dyn.vel[done].numpy(), 0.0)
        assert torch.isfinite(out.obs["depth"]).all()
    assert respawned >= 32  # every agent truncates at step 3 and 6


@pytest.mark.parametrize("kind", ["uniform", "heading", "normal", "target_uniform"])
def test_randomizer_kinds(kind):
    """Each state generator draws finite states of the right shapes, inside
    its support (generators differ from JAX's, so no value parity)."""
    from visfly_tpu_torch.core import quaternion as tquat
    from visfly_tpu_torch.envs.randomization import RandomizerSpec, safe_sample

    spec = RandomizerSpec.uniform(
        position={"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]},
        orientation={"mean": [0.0, 0.0, 0.0], "half": [0.1, 0.1, 0.5]},
        velocity={"mean": [0.0, 0.0, 0.0], "half": [0.2, 0.2, 0.2]},
        kind="uniform" if kind == "heading" else kind, heading=kind == "heading",
        min_dis=1.0, max_dis=2.0)
    n = 4096
    target = torch.tensor([5.0, 0.0, 1.0])
    pos, q, vel, omega = safe_sample(spec, torch.Generator().manual_seed(0), n,
                                     target_pos=target)
    assert pos.shape == vel.shape == omega.shape == (n, 3) and q.shape == (n, 4)
    for x in (pos, q, vel, omega):
        assert torch.isfinite(x).all()
    torch.testing.assert_close(tquat.norm(q), torch.ones(n))
    if kind in ("uniform", "heading"):
        assert ((pos - spec.pos_mean).abs() <= spec.pos_half + 1e-6).all()
        assert ((vel - spec.vel_mean).abs() <= spec.vel_half + 1e-6).all()
    if kind == "heading":  # yaw aims back at the spawn-range centre
        yaw = tquat.yaw(q)
        to_center = spec.pos_mean - pos
        aim = torch.atan2(to_center[:, 1], to_center[:, 0])
        err = torch.atan2(torch.sin(yaw - aim), torch.cos(yaw - aim)).abs()
        assert (err <= 0.5 + 0.2).all()
    if kind == "normal":  # (2·N(0,1) − 1)·std + mean: shifted by −std
        torch.testing.assert_close(pos.mean(0), spec.pos_mean - spec.pos_half,
                                   atol=0.1, rtol=0)
    if kind == "target_uniform":
        dis = torch.linalg.vector_norm(pos - target, dim=1)
        assert (dis >= 1.0 - 1e-5).all() and (dis <= 2.0 + 1e-5).all()


def test_unported_branches_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tenvs.NavigationEnv(**bench_kwargs(sensor_kwargs=[
            {"uuid": "color", "sensor_type": "color", "resolution": [8, 8]}])).reset()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tenvs.NavigationEnv(**bench_kwargs(sensor_kwargs=[
            {"uuid": "depth", "sensor_type": "depth", "resolution": [8, 8],
             "trace_mode": "march"}])).reset()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tenvs.NavigationEnv(**bench_kwargs(requires_grad=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tenvs.NavigationEnv(**bench_kwargs(scene_kwargs={
            "path": "garage_simple_l_medium", "obj_settings": {"path": "x"}}))
