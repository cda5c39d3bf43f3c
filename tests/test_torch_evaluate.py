"""The port's evaluation harness (``visfly_tpu_torch/utils/evaluate.py``)
against ``visfly_tpu/utils/evaluate.py``.

Both ``TestBase.rollout``s start from the same state (each env's ``reset``
is replaced by one that returns the JAX env's reset state, carried across by
``interop``) with the same PPO policy (``interop.ppo_state_from_jax``) and
run the deterministic policy with ``is_test=True`` until every agent is done.
Tolerances are the env steps' of ``tests/test_torch_env_base.py``: positions,
velocities, actions, rewards and collision distances within 1e-4, dones and
the episode stats equal (returns within 1e-4), depth frames within 1e-3 m on
all but 2 pixels a camera.
"""
import os

import numpy as np
import pytest
import torch

import jax

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.algos import PPO as JPPO
from visfly_tpu.utils.evaluate import TestBase as JTestBase
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import PPO
from visfly_tpu_torch.interop import env_state_from_numpy, ppo_state_from_jax
from visfly_tpu_torch.utils.evaluate import TestBase

torch.set_num_threads(1)

TOL, TOL_DEPTH = 1e-4, 1e-3
N, STEPS = 4, 24
ENV = dict(num_agent_per_scene=N, visual=True, max_episode_steps=STEPS,
           scene_kwargs={"path": "garage_simple_l_medium"},
           sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [16, 16]}],
           random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
               {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 1.5, 0.5]}}]}},
           dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"})
POLICY = {"pi_layers": (16,), "vf_layers": (16,),
          "net_arch": {"depth": {"cnn": 16}, "state": {"mlp": [16]}, "target": {"mlp": [8]}}}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def rollouts(tmp_path_factory):
    jenv = jenvs.NavigationEnv(**ENV)
    jtr = JPPO(jenv, n_steps=8, policy_kwargs=POLICY)
    jst = jtr.init(jax.random.PRNGKey(0))
    tenv = tenvs.NavigationEnv(device="cpu", **ENV)
    ttr = PPO(tenv, n_steps=8, policy_kwargs=POLICY)
    tst = ppo_state_from_jax(to_numpy(jst), ttr)
    # the state both rollouts start from: the JAX env's reset
    j0, jobs0 = jenv.reset(jax.random.PRNGKey(3))
    t0 = env_state_from_numpy(to_numpy(j0))
    tobs0 = {k: torch.from_numpy(np.array(v)) for k, v in to_numpy(jobs0).items()}
    jenv.reset = lambda key=None, state=None: (j0, jobs0)
    tenv.reset = lambda gen=None: (t0, tobs0)
    base = tmp_path_factory.mktemp("eval")
    jtb = JTestBase(jtr, jenv, save_path=str(base / "jax"))
    ttb = TestBase(ttr, tenv, save_path=str(base / "port"))
    return jtb.rollout(jst, max_steps=64), ttb.rollout(tst, max_steps=64), ttb, tst


def test_rollout_matches_jax(rollouts):
    (ja, jf, js), (ta, tf, ts), _, _ = rollouts
    assert set(ta) == set(ja) and ta["position"].shape == ja["position"].shape
    assert len(ta["done"]) == STEPS and ta["done"][-1].all()  # every agent done: the loop ends
    for k in ("position", "velocity", "action", "reward", "collision_dis", "t"):
        np.testing.assert_allclose(ta[k], ja[k], atol=TOL, rtol=0, err_msg=k)
    np.testing.assert_array_equal(ta["done"], ja["done"])
    for k in ("episode_lengths", "success"):
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    np.testing.assert_allclose(ts["episode_returns"], js["episode_returns"], atol=TOL)
    for k in ("success_rate", "mean_length"):
        assert ts[k] == js[k], k
    assert abs(ts["mean_return"] - js["mean_return"]) < TOL
    # the depth camera's frames, (T, N, 1, 16, 16)
    assert set(tf) == set(jf) == {"depth"}
    out, ref = np.stack(tf["depth"]), np.stack(jf["depth"])
    assert out.shape == ref.shape == (STEPS, N, 1, 16, 16)
    off = np.abs(out - ref) > TOL_DEPTH
    assert off.sum(axis=(2, 3, 4)).max() <= 2
    np.testing.assert_allclose(out[~off], ref[~off], atol=TOL_DEPTH, rtol=0)


def test_test_writes_its_files(rollouts):
    """``test()`` writes the figure and one video (or ``.npy``) per image
    sensor, and the global view's frames when asked for."""
    _, _, ttb, tst = rollouts
    stats = ttb.test(state=tst, max_steps=STEPS, is_render=True)
    assert 0 <= stats["success_rate"] <= 1
    names = sorted(os.path.basename(f) for f in ttb.files)
    assert names[0] == "test_depth.mp4" or names[0] == "test_depth.npy"
    assert names[-1] == "test_trajectories.png"
    assert all(os.path.isfile(f) for f in ttb.files)
    assert ttb.last_state.dyn.pos.shape == (N, 3)
    _, frames, _ = ttb.rollout(tst, max_steps=3, render_every=2,
                               render_kwargs={"resolution": [24, 32], "view": "near"})
    assert len(frames["global"]) == 2 and frames["global"][0].shape == (1, 24, 32, 3)
    videos = ttb.save_video({"global": frames["global"]})
    assert os.path.basename(videos[0]).startswith("test_global")


def test_frames_without_a_video_writer(tmp_path, monkeypatch):
    """Where neither imageio nor cv2 imports (the card's machine), the
    frames land in ``.npy``, as the JAX package writes them."""
    from visfly_tpu_torch.utils import evaluate

    for name in ("imageio", "imageio.v2", "cv2"):
        monkeypatch.setitem(__import__("sys").modules, name, None)
    frames = np.arange(2 * 4 * 4 * 3, dtype=np.uint8).reshape(2, 4, 4, 3)
    path = evaluate._write_video(str(tmp_path / "clip.mp4"), frames, 30)
    assert path == str(tmp_path / "clip.npy")
    np.testing.assert_array_equal(np.load(path), frames)
