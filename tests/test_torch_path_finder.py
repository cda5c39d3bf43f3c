"""The port's PRM planner (``visfly_tpu_torch/utils/path_finder.py``) and
the swarm env's path hints against ``visfly_tpu``'s: the same seed samples
the same roadmap, so the waypoints are equal wherever the two packages'
collision tests agree (everywhere, in these scenes)."""
import numpy as np
import pytest
import torch


from visfly_tpu import envs as jenvs
from visfly_tpu.utils import path_finder as jpf
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.scene import point_is_collision
from visfly_tpu_torch.utils import path_finder as tpf

torch.set_num_threads(1)


def wall(p):
    """A wall at x = 0 with a gap at y > 2."""
    p = np.asarray(p)
    return (np.abs(p[:, 0]) < 0.4) & (p[:, 1] < 2.0)


def test_prm_planner_plans_around_obstacle():
    """``tests/test_aux_subsystems.py::test_prm_planner_plans_around_obstacle``,
    and the same waypoints as the JAX planner's."""
    path = tpf.PRMPlanner(wall, [-5, -5, 0.5], [5, 5, 3], n_samples=300, seed=1).plan(
        [-4, 0, 1], [4, 0, 1])
    assert path is not None
    crossings = path[(np.abs(path[:, 0]) < 0.6)]
    assert (crossings[:, 1] > 1.0).all()
    ref = jpf.PRMPlanner(wall, [-5, -5, 0.5], [5, 5, 3], n_samples=300, seed=1).plan(
        [-4, 0, 1], [4, 0, 1])
    np.testing.assert_array_equal(path, ref)
    # a closed wall: no path
    closed = tpf.PRMPlanner(lambda p: np.abs(np.asarray(p)[:, 0]) < 0.6, [-5, -5, 0.5],
                            [5, 5, 3], n_samples=200, seed=1)
    assert closed.plan([-4, 0, 1], [4, 0, 1]) is None


def swarm_kwargs(**scene):
    return dict(num_agent_per_scene=2, num_scene=1, visual=True,
                sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [16, 16]}],
                scene_kwargs={"path": "garage_simple_l_medium", **scene},
                random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                    {"position": {"mean": [2.0, 0.0, 1.5], "half": [0.5, 1.0, 0.3]}}]}})


def test_find_paths_matches_jax():
    jenv = jenvs.MultiNavigationEnv(**swarm_kwargs())
    tenv = tenvs.MultiNavigationEnv(device="cpu", **swarm_kwargs())
    starts = np.asarray([[2.0, -0.5, 1.5], [1.5, 0.8, 1.2]], np.float32)
    targets = tenv.target.numpy()
    ours = tpf.find_paths(tenv, torch.from_numpy(starts), tenv.target)
    ref = jpf.find_paths(jenv, starts, targets)
    assert len(ours) == len(ref) == 2
    for p, q in zip(ours, ref):
        assert p is not None and q is not None
        np.testing.assert_array_equal(p, q)
    assert tpf.find_paths(tenvs.HoverEnv(device="cpu", num_agent_per_scene=3), starts,
                          targets) == [None] * 3


def test_swarm_env_path_hints():
    """``tests/test_prim_scene.py::test_multi_navigation_path_hints`` on the
    port: every reset plans a collision-free path per agent, from its
    position to its target."""
    env = tenvs.MultiNavigationEnv(device="cpu", **swarm_kwargs(is_find_path=True))
    assert env.is_find_path and env.path == [None, None]
    state, _ = env.reset(torch.Generator().manual_seed(1))
    assert len(env.path) == env.num_envs
    pos, tgt = state.dyn.pos.numpy(), env.target.numpy()
    for i, p in enumerate(env.path):
        assert p is not None, f"agent {i}: no path found"
        assert p.shape[-1] == 3 and p.shape[0] >= 2
        np.testing.assert_allclose(p[0], pos[i], atol=1e-5)
        np.testing.assert_allclose(p[-1], tgt[i], atol=1e-5)
        col = point_is_collision(env.scene, torch.from_numpy(p[1:-1]), radius=env.uav_radius)
        assert not col.any(), f"agent {i}: waypoint in collision"
    # a scene swap replans its agents from where they respawned
    state = env.reset_env_by_id(state, 0)
    for i, p in enumerate(env.path):
        assert p is not None
        np.testing.assert_allclose(p[0], state.dyn.pos[i].numpy(), atol=1e-5)
    off = tenvs.MultiNavigationEnv(device="cpu", num_agent_per_scene=2, visual=False)
    off.reset(torch.Generator().manual_seed(0))
    assert off.path == [None, None]
