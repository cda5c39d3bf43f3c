"""The port's global view (``visfly_tpu_torch/render/global_view.py`` and
``DroneGymEnv.render``) against ``visfly_tpu/render/global_view.py``.

The JAX env resets and steps, its state crosses over through
``interop.env_state_from_numpy``, and both packages render the same views
with the same overlays. The overlays are host numpy on equal inputs; the
scene image comes from each package's trace, so a pixel on a silhouette may
differ: colour equal on all but 2 pixels per 1,024 (ROADMAP Queue C, "Id
ties and silhouettes"; any channel off by more than 1 counts). 96×128 is
whole 1,024-ray tiles (the per-tile cull with frustum planes), 48×96 is not
(no cull), 64×80 is whole tiles whose width does not divide 1,024 (the cull
without frustum planes, as at 480×640 on the card).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.render.global_view import render_global as jrender_global
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.interop import env_state_from_numpy
from visfly_tpu_torch.render import global_view as gv

torch.set_num_threads(1)

SCENE = {"path": "garage_simple_l_medium"}
MOVER = [{"name": "mover", "path": {"class": "circle", "kwargs": {"radius": 1.0,
                                                                  "center": [3.0, 0.0, 1.5]}},
          "velocity": 1.0, "radius": 0.3}]


def kwargs(n=2, **over):
    kw = dict(num_agent_per_scene=n, visual=True, scene_kwargs=dict(SCENE),
              sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [16, 16]}],
              random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                  {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 1.0, 0.5]}}]}},
              dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})
    kw.update(over)
    return kw


def pair(**over):
    """Both envs, the JAX state after one step, and its port twin."""
    jenv = jenvs.NavigationEnv(**kwargs(**over))
    tenv = tenvs.NavigationEnv(device="cpu", **kwargs(**over))
    jst, _ = jenv.reset(jax.random.PRNGKey(0))
    jst, _ = jenv.step(jst, jnp.full((jenv.num_envs, 4), 0.2))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    return jenv, jst, tenv, tst


@pytest.fixture(scope="module")
def envs():
    return pair()


def assert_frames_close(out, ref, msg=""):
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8, msg
    off = np.abs(out.astype(int) - ref.astype(int)).max(axis=-1) > 1
    allowed = 2 * -(-out.shape[0] * out.shape[1] // 1024)
    assert off.sum() <= allowed, (msg, int(off.sum()), allowed, np.argwhere(off)[:8])


HIST = np.stack([np.full((2, 3), [0.5, 0.0, 1.2]) + 0.05 * k * np.asarray([1.0, 0.3, 0.1])
                 for k in range(14)])
CASES = {
    "top": dict(view="top"),
    "near_overlays": dict(view="near", traj_history=HIST, trajectory=True, velocity=True,
                          collision=True, axes=True),
    "side_follow": dict(view="side", mode="follow", traj_history=HIST, trajectory=True),
    "back_custom": dict(view="back", position=[[0.5, -2.0, 2.0], [4.0, 0.0, 1.0]],
                        line_width=3.0, hfov=70.0),
}


@pytest.mark.parametrize("case,res", [
    ("top", (96, 128)), ("top", (48, 96)), ("top", (64, 80)),
    ("near_overlays", (96, 128)), ("near_overlays", (48, 96)),
    ("side_follow", (64, 80)), ("back_custom", (96, 128)),
], ids=lambda x: f"{x[0]}x{x[1]}" if isinstance(x, tuple) else x)
def test_render_global_matches_jax(envs, case, res):
    jenv, jst, tenv, tst = envs
    kw = dict(CASES[case], resolution=list(res))
    out = gv.render_global(tenv, tst, **kw)
    ref = jrender_global(jenv, jst, **kw)
    assert_frames_close(out, ref, case)
    assert out.std() > 5


def test_overlays_change_pixels(envs):
    _, _, tenv, tst = envs
    base = gv.render_global(tenv, tst, view="near", resolution=[96, 128])
    full = gv.render_global(tenv, tst, view="near", resolution=[96, 128], traj_history=HIST,
                            velocity=True, collision=True, axes=True)
    assert (base != full).any()


def test_env_render(envs):
    """``env.render`` draws the trajectory with the scene's
    ``render_settings`` under the call's own, as the JAX env does."""
    jenv, jst, tenv, tst = envs
    for env in (jenv, tenv):
        env.scene_kwargs["render_settings"] = {"view": "near", "resolution": [48, 64]}
    try:
        out = tenv.render(tst, traj_history=HIST, trajectory=True, axes=True)
        ref = jenv.render(jst, traj_history=HIST, trajectory=True, axes=True)
    finally:
        for env in (jenv, tenv):
            env.scene_kwargs.pop("render_settings")
    assert out.shape == (48, 64, 3)
    assert_frames_close(out, ref)
    assert tenvs.HoverEnv(device="cpu", num_agent_per_scene=2).render(None) is None


def test_approaching_is_not_ported(envs):
    """The approaching overlay, which named its ROADMAP item until
    ``approaching_point`` was ported, draws the JAX lines."""
    jenv, jst, tenv, tst = envs
    kw = dict(view="top", resolution=[48, 96], approaching=True)
    out = gv.render_global(tenv, tst, **kw)
    assert_frames_close(out, jrender_global(jenv, jst, **kw), "approaching")


def test_object_mode_tracks_the_first_object():
    """``test_global_render_overlays_and_object_mode``'s object view. The
    JAX package's test of the objects state never passes (its
    ``ObjectsState`` is a tuple), so its object mode falls back to
    ``follow``; the port's tracks the first object. Held against the JAX
    render of the same camera: ``view='back'`` at the object."""
    jenv, jst, tenv, tst = pair(scene_kwargs=dict(SCENE, obj_settings=MOVER))
    obj = gv.render_global(tenv, tst, mode="object", view="back", resolution=[64, 96])
    assert obj.shape == (64, 96, 3) and obj.std() > 5
    focus = tst.objects.pos[0].numpy()
    eye, _ = gv._camera_pose("back", tenv.bbox.numpy(), focus)
    ref = jrender_global(jenv, jst, view="back", position=[eye, focus], resolution=[64, 96])
    assert_frames_close(obj, ref)
    follow = jrender_global(jenv, jst, mode="object", view="back", resolution=[64, 96])
    assert_frames_close(gv.render_global(tenv, tst, mode="follow", view="back",
                                         resolution=[64, 96]), follow)
    # without objects the object mode follows the agents
    _, _, tenv2, tst2 = pair()
    assert np.array_equal(gv.render_global(tenv2, tst2, mode="object", view="back",
                                           resolution=[32, 32]),
                          gv.render_global(tenv2, tst2, mode="follow", view="back",
                                           resolution=[32, 32]))


def test_multi_scene_env_renders_scene_zero():
    """A 3-scene env renders its scene 0, as the JAX call (scene id 0,
    ``num_scene=1``) means to. On the CPU that JAX call fails for several
    scenes (its trace maps the 3 scenes' rows against 1 scene's rays), so
    the reference is the JAX render of the same state in the one-scene env,
    whose scene is scene 0."""
    jenv, jst, tenv, tst = pair(num_scene=3)
    assert tenv.scene.num_scene == 3
    zero = gv.scene_zero(tenv.scene)
    assert zero.num_scene == 1 and torch.equal(zero.boxes[0], tenv.scene.boxes[0])
    jenv1 = jenvs.NavigationEnv(**kwargs(n=2 * 3))
    np.testing.assert_array_equal(np.asarray(jenv1.scene.params[0]), zero.params[0].numpy())
    np.testing.assert_array_equal(np.asarray(jenv1.bbox), tenv.bbox.numpy())
    kw = dict(view="top", resolution=[48, 64], traj_history=HIST, trajectory=True)
    out = gv.render_global(tenv, tst, **kw)
    assert_frames_close(out, jrender_global(jenv1, jst, **kw))
    with pytest.raises(ValueError, match="inconsistent sizes"):
        jrender_global(jenv, jst, **kw)
    single = tenvs.NavigationEnv(device="cpu", **kwargs(num_scene=3))
    single.scene = zero
    assert np.array_equal(gv.render_global(single, tst, **kw), out)


def test_one_camera_hands_the_kernels_contiguous_rays(envs, monkeypatch):
    """The view is one camera in one scene, where the rays' reshape is a view
    of a stride-0 expand; the kernels on the card take contiguous rays only,
    so the render hands them contiguous ones (as it does an env of one agent
    a scene, such as landing's eval env)."""
    from visfly_tpu_torch.render import sphere_trace

    _, _, tenv, tst = envs
    seen = []
    trace = sphere_trace.trace_diff

    def checked(kscene, origins, dirs, *args, **kw):
        seen.append(origins.is_contiguous() and dirs.is_contiguous())
        return trace(kscene, origins, dirs, *args, **kw)

    monkeypatch.setattr(sphere_trace, "trace_diff", checked)
    gv.render_global(tenv, tst, view="top", resolution=[32, 32])
    one = tenvs.LandingEnv(device="cpu", num_agent_per_scene=1)
    state, _ = one.reset(torch.Generator().manual_seed(0))
    one.sensor_observations(state)
    assert seen == [True] * 3  # the view, the reset and the observation
