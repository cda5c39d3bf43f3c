"""The port's envs end to end against ``visfly_tpu``'s: ``NavigationEnv``
with the bench configuration cut to 4 agents and 16×64 depth, the same env
with the four-sensor suite (semantic, march, un-culled over-relaxed march,
cone-warm-started march), ``LandingEnv`` with a 16×16 colour camera,
``LandingEnv2``, ``HoverEnv`` and ``HoverEnv2``.

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

# its module constants must exist before a jit traces a render
import visfly_tpu.render.sphere_trace  # noqa: F401
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
    """The depth leg's configuration for either package (the JAX envs accept
    and ignore ``device``)."""
    kw = dict(
        device="cpu",
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
    assert env.device.type == "cpu"
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


def test_unported_branches_raise(tmp_path):
    """Nothing of the env is left to port. World-model latents (Queue A item
    14) exist as zero observations without a world model. The scene sources
    and mesh render branches that raised until
    Queue A items 18-20 were ported now build and render: a preset baked into
    a grid, a mesh file's decomposition, textures, shadow rays, the grid
    render opt-out and a grid scene without triangles; files that are not
    what their names say raise as in the JAX package."""
    def nav(**over):
        return tenvs.NavigationEnv(**bench_kwargs(**over))

    scene = {"path": "garage_simple_l_medium"}
    obj = _write_room_obj(tmp_path / "room.obj")
    glb = tmp_path / "stage.glb"
    glb.write_bytes(b"glTF")
    (tmp_path / "stage.scene_instance.json").write_text("{}")
    # differentiable rollouts are ported: the flags are attributes
    env = nav(requires_grad=True, grad_collision=True)
    assert env.requires_grad and env.grad_collision and not nav().requires_grad
    # keywords that only set attributes in the JAX package do so here
    env = nav(tensor_output=False, is_train=True, sensitive_radius=6.0, multi_drone=True)
    assert (not env.tensor_output and env.is_train and env.sensitive_radius == 6.0
            and env.is_multi_drone)
    env = nav()
    assert env.tensor_output and not env.is_train and not env.is_multi_drone
    assert env.sensitive_radius == 10.0
    latent = nav(latent_dim=8)
    assert latent.world is None and latent.deter_dim == latent.stoch_dim == 8
    st, obs = latent.reset(torch.Generator().manual_seed(0))
    st, out = latent.step(st, torch.zeros(N, 4))
    for o in (obs, out.obs):
        assert o["deter"].shape == o["stoch"].shape == (N, 8)
        assert not o["deter"].any() and not o["stoch"].any()
    from visfly_tpu_torch.scene import PrimitiveScene, SceneData

    grid = nav(scene_kwargs=dict(scene, backend="grid", sdf_spacing=0.25))
    assert isinstance(grid.scene, SceneData) and not grid.scene.has_triangles
    assert isinstance(nav(scene_kwargs={"path": obj}).scene, PrimitiveScene)
    with pytest.raises(ValueError, match="not a GLB"):
        nav(scene_kwargs={"path": str(glb)})
    # an instance file without stage or objects is no habitat scene, and a
    # directory of such files holds no scene JSONs
    with pytest.raises(ValueError, match="unknown scene preset"):
        nav(scene_kwargs={"path": str(tmp_path / "stage.scene_instance.json")})
    with pytest.raises(KeyError, match="primitives"):
        nav(scene_kwargs={"path": str(tmp_path)})
    # the path planner (once Queue A item 21) is ported
    planning = tenvs.MultiNavigationEnv(**bench_kwargs(num_agent_per_scene=3, scene_kwargs=dict(
        scene, is_find_path=True)))
    assert planning.is_find_path and planning.path == [None] * 3
    st, _ = tenvs.NavigationEnv(**bench_kwargs()).reset(torch.Generator().manual_seed(0))
    # colour, march and refined sensors render
    env = nav(sensor_kwargs=[
        {"uuid": "color", "sensor_type": "color", "resolution": [8, 8]},
        {"uuid": "depth", "sensor_type": "depth", "resolution": [8, 8], "trace_mode": "march"},
        {"uuid": "refined", "sensor_type": "depth", "resolution": [8, 8], "analytic_refine": 2}])
    images = env.sensor_observations(st)
    assert images["color"].dtype == torch.uint8 and images["color"].shape == (N, 3, 8, 8)
    assert torch.isfinite(images["depth"]).all() and torch.isfinite(images["refined"]).all()
    # on a mesh scene: the grid render opt-out, shadow rays, textures and a
    # grid scene without triangles
    from visfly_tpu_torch.render import bake_lighting, render_camera

    mesh_env = nav(scene_kwargs={"path": obj, "backend": "grid", "sdf_spacing": 0.25})
    pos, q = st.dyn.pos, st.dyn.q
    spec = {"sensor_type": "color", "resolution": [8, 8]}
    sun = bake_lighting({"shadows": True, "lights": [
        {"type": "directional", "direction": [0, 0, -1]}]})
    ball = (pos[None, :1] + 1.0, torch.full((1, 1), 0.2))
    T = mesh_env.scene.triangles.shape[1]
    grey = torch.zeros(1, T, 4)
    grey[..., :2] = 1.0  # every face samples one 180-grey texel, the grid's albedo
    textured = mesh_env.scene._replace(tri_uv=torch.zeros(1, T, 6), tri_rect=grey,
                                       atlas=torch.full((1, 1, 1, 3), 180, dtype=torch.uint8))
    plain = render_camera(mesh_env.scene, pos, q, spec)["color"]
    assert plain.shape == (N, 3, 8, 8)
    assert torch.equal(render_camera(textured, pos, q, spec)["color"], plain)
    assert (render_camera(mesh_env.scene, pos, q, spec, lighting=sun)["color"]
            <= render_camera(mesh_env.scene, pos, q, spec, lighting=bake_lighting(
                {"lights": [{"type": "directional", "direction": [0, 0, -1]}]}))["color"]).all()
    for data, sp in ((mesh_env.scene, dict(spec, render_backend="grid")),
                     (mesh_env.scene._replace(triangles=()), spec)):
        assert render_camera(data, pos, q, sp, n_steps=8)["color"].shape == (N, 3, 8, 8)
    assert render_camera(mesh_env.scene, pos, q, spec, objects=ball)["color"].shape == (
        N, 3, 8, 8)
    # off the CPU a camera whose rays are not whole 1,024-ray tiles raises: no
    # render steps down to the brute force by shape alone
    assert (N * 8 * 8) % 1024
    with pytest.raises(ValueError, match="whole 1024-ray tiles"):
        render_camera(mesh_env.scene, pos.to("meta"), q.to("meta"), spec)


def test_env_without_device_is_on_the_card(tmp_path):
    """An env built without ``device=`` is on ``cuda``, a mesh env with its
    baked scene too. With no card the constructor fails with torch's own
    error: nothing falls back to the CPU."""
    mesh_kw = dict(num_agent_per_scene=2, visual=True, scene_kwargs={
        "path": _write_room_obj(tmp_path / "room.obj"), "backend": "grid"})
    if torch.cuda.is_available():
        env = tenvs.HoverEnv(num_agent_per_scene=2)
        assert env.device.type == "cuda" and env.params.mass.device.type == "cuda"
        env = tenvs.NavigationEnv(**mesh_kw)
        assert env.scene.sdf.device.type == "cuda" and env.scene.triangles.device.type == "cuda"
    else:
        for build in (lambda: tenvs.HoverEnv(num_agent_per_scene=2),
                      lambda: tenvs.NavigationEnv(**mesh_kw)):
            with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda|nvidia"):
                build()


# ---------------------------------------------------------------------------
# landing, hover and the sensor suite
# ---------------------------------------------------------------------------


def _pair(cls, **kw):
    """The same env in both packages, the JAX one reset, its state crossed
    over, and a jitted ``is_test`` step."""
    jenv = getattr(jenvs, cls)(num_agent_per_scene=N, **kw)
    tenv = getattr(tenvs, cls)(num_agent_per_scene=N, device="cpu", **kw)
    return jenv, tenv


def _start(jenv, seed=0):
    jst, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(seed))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    return jst, tst, jax.jit(lambda s, a: jenv.step(s, a, is_test=True))


def _shrink_camera(jenv, tenv, res):
    """Cut the env's fixed 64×64 camera to ``res``×``res``."""
    from visfly_tpu_torch.render import camera_geometry

    for env in (jenv, tenv):
        env.sensor_kwargs[0]["resolution"] = [res, res]
        env.resolution = res
    tenv.cameras = [camera_geometry(s, "cpu") for s in tenv.sensor_kwargs]


def _assert_uint8_close(out, ref, msg, max_off_per_camera=2):
    """Equal within one count on all but the silhouette pixels."""
    diff = np.abs(out.astype(int) - ref.astype(int)).max(axis=1)  # (N, H, W)
    per_1024 = max(1, diff[0].size // 1024) * max_off_per_camera
    assert (diff > 1).sum(axis=(1, 2)).max() <= per_1024, (msg, np.argwhere(diff > 1))


def _assert_step_close(tout, jout, tst, jst, i):
    np.testing.assert_allclose(tout.reward.numpy(), _np(jout.reward), atol=TOL, rtol=0,
                               err_msg=f"step {i} reward")
    np.testing.assert_array_equal(tout.done.numpy(), _np(jout.done))
    for k in ("episode_done", "is_success", "TimeLimit.truncated", "collision"):
        np.testing.assert_array_equal(tout.info[k].numpy(), _np(jout.info[k]), err_msg=k)
    np.testing.assert_allclose(tst.collision.dis.numpy(), _np(jst.collision.dis), atol=TOL,
                               rtol=0)


def test_landing_env_matches_jax():
    """``LandingEnv``, 16×16 colour, 8 steps: the JAX CPU render shades by the
    nearest primitive, the port by the reported id."""
    jenv, tenv = _pair("LandingEnv")
    _shrink_camera(jenv, tenv, 16)
    jst, tst, jstep = _start(jenv)
    assert isinstance(tst.aux, tenvs.LandingAux)
    rng = np.random.default_rng(0)
    for i in range(8):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        assert set(tout.obs) == set(jout.obs) == {"state", "target", "color"}
        np.testing.assert_allclose(tout.obs["state"].numpy(), _np(jout.obs["state"]), atol=TOL)
        # a pad pixel more or less moves the centre of mass by under 1/16 pixel
        np.testing.assert_allclose(tout.obs["target"].numpy(), _np(jout.obs["target"]),
                                   atol=1.0 / 16 / 16, rtol=0)
        _assert_uint8_close(tout.obs["color"].numpy(), _np(jout.obs["color"]), f"step {i}")
        _assert_step_close(tout, jout, tst, jst, i)
        np.testing.assert_allclose(tst.aux.centers.numpy(), _np(jst.aux.centers),
                                   atol=1.0 / 16 / 16, rtol=0)
        np.testing.assert_array_equal(tst.aux.seen.numpy(), _np(jst.aux.seen))
    color = tout.obs["color"]
    assert color.shape == (N, 3, 16, 16) and color.dtype == torch.uint8
    assert tst.aux.seen.any() and (tst.aux.centers != 0).any()
    assert (color.float().mean(dim=1) < 70).any()  # the dark pad is in view


@pytest.mark.parametrize("cls", ["LandingEnv2", "HoverEnv", "HoverEnv2"])
def test_state_envs_match_jax(cls):
    kw = {}
    if cls == "HoverEnv2":  # its 64×64 depth camera, in the bench garage
        kw = dict(visual=True, scene_kwargs={"path": "garage_simple_l_medium"},
                  random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                      {"position": {"mean": SPAWN_MEAN.tolist(), "half": SPAWN_HALF.tolist()}}]}})
    jenv, tenv = _pair(cls, **kw)
    if cls == "HoverEnv2":
        _shrink_camera(jenv, tenv, 16)
    jst, tst, jstep = _start(jenv)
    rng = np.random.default_rng(1)
    for i in range(8):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        assert set(tout.obs) == set(jout.obs)
        np.testing.assert_allclose(tout.obs["state"].numpy(), _np(jout.obs["state"]), atol=TOL,
                                   rtol=0, err_msg=f"step {i}")
        if "depth" in jout.obs:
            _assert_depth_close(tout.obs["depth"].numpy() * 10, _np(jout.obs["depth"]) * 10,
                                f"step {i}")
            assert float(tout.obs["depth"].max()) <= 1.0
        _assert_step_close(tout, jout, tst, jst, i)


def test_hover_timeout_and_auto_reset():
    """Mirrors ``test_hover_timeout_and_autoreset`` of the JAX package."""
    env = tenvs.HoverEnv(num_agent_per_scene=3, max_episode_steps=5, device="cpu")
    st, _ = env.reset(torch.Generator().manual_seed(0))
    hover = torch.zeros(3, 4)
    for i in range(5):
        st, out = env.step(st, hover)
    assert out.done.all() and out.info["TimeLimit.truncated"].all()
    assert (st.step_count == 0).all() and (st.returns == 0).all()
    assert not out.info["is_success"].any()
    lo, hi = torch.tensor([0.0, -1.0, 1.0]) - 1e-6, torch.tensor([2.0, 1.0, 2.0]) + 1e-6
    assert ((st.dyn.pos >= lo) & (st.dyn.pos <= hi)).all()  # respawned in the default box
    st, out = env.step(st, hover)
    assert not out.done.any() and (st.step_count == 1).all()


def test_hover_bbox_collision_resets():
    """An agent flown into the floor of the bbox world collides and resets."""
    env = tenvs.HoverEnv(num_agent_per_scene=2, max_episode_steps=200, device="cpu")
    st, _ = env.reset(torch.Generator().manual_seed(0))
    down = torch.tensor([[-1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    collided = False
    for _ in range(120):
        st, out = env.step(st, down)
        if out.info["collision"][0]:
            collided = True
            assert out.done[0] and not out.info["TimeLimit.truncated"][0]
            assert st.step_count[0] == 0 and st.dyn.pos[0, 2] >= 1.0 - 1e-6
            break
    assert collided and not out.done[1]


def test_sensor_suite_matches_jax():
    """``NavigationEnv`` with the four sensors of the sensor-suite path at
    16×64. The JAX CPU march defaults to bfloat16, so its specs ask for
    float32; it runs with no per-tile cull, while the port's culled march
    (``depth_march``) computes the TPU kernel's culled function, which stays
    within the same 1e-3 m of the un-culled one here."""
    sensors = [
        {"uuid": "semantic", "sensor_type": "semantic"},
        {"uuid": "depth_march", "sensor_type": "depth", "trace_mode": "march"},
        {"uuid": "depth_nocull", "sensor_type": "depth", "trace_mode": "march", "cull": False,
         "march_omega": 1.5},
        {"uuid": "depth_tile", "sensor_type": "depth", "trace_mode": "march", "tile": 8},
    ]
    sensors = [dict(s, resolution=[16, 64], render_dtype="float32") for s in sensors]
    jenv = jenvs.NavigationEnv(**bench_kwargs(sensor_kwargs=sensors))
    tenv = tenvs.NavigationEnv(**bench_kwargs(sensor_kwargs=sensors))
    jst, tst, jstep = _start(jenv)
    rng = np.random.default_rng(2)
    for i in range(3):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        np.testing.assert_allclose(tout.obs["state"].numpy(), _np(jout.obs["state"]), atol=TOL)
        ref = {k: _np(v) for k, v in jenv.sensor_observations(jst).items()}
        out = {k: v.numpy() for k, v in tenv.sensor_observations(tst).items()}
        assert set(out) == set(ref) == {s["uuid"] for s in sensors}
        _assert_uint8_close(out["semantic"], ref["semantic"], f"step {i} semantic")
        # the XLA march is the same float32 march without the over-relaxation
        # (its ω is fixed at 1): the plain march agrees within 1e-3; the
        # over-relaxed one is held to the bound of the JAX package's
        # ``test_overrelaxed_march_converges`` (hit flags agree on > 98%,
        # median |Δ| < 1e-2), and to the interpret-mode tile in
        # ``test_torch_trace_modes.py``
        _assert_depth_close(out["depth_march"], ref["depth_march"], f"step {i} march")
        _assert_depth_close(out["depth_tile"], ref["depth_tile"], f"step {i} tile")
        hit, hit_ref = out["depth_nocull"] < 20.0, ref["depth_nocull"] < 20.0
        assert (hit == hit_ref).mean() > 0.98
        err = np.abs(out["depth_nocull"] - ref["depth_nocull"])[hit & hit_ref]
        assert np.median(err) < 1e-2, np.median(err)
    assert out["semantic"].dtype == np.uint8 and out["semantic"].shape == (N, 1, 16, 64)
    assert len(np.unique(out["semantic"])) > 2


def test_landing_and_sensor_suite_paths_run_as_in_jax():
    """The colour-landing path and the sensor-suite path as a whole, 4 agents,
    8 steps with the auto-reset on: shapes, dtypes and finiteness as in the
    JAX run (the two packages' generators differ, so no value parity)."""
    sensors = [dict(s, resolution=[16, 16]) for s in (
        {"uuid": "semantic", "sensor_type": "semantic"},
        {"uuid": "depth", "sensor_type": "depth", "trace_mode": "march"},
        {"uuid": "depth_nocull", "sensor_type": "depth", "trace_mode": "march", "cull": False,
         "march_omega": 1.5},
        {"uuid": "depth_tile", "sensor_type": "depth", "trace_mode": "march", "tile": 8})]
    pairs = [_pair("LandingEnv", max_episode_steps=5),
             (jenvs.NavigationEnv(**bench_kwargs(sensor_kwargs=sensors, max_episode_steps=5)),
              tenvs.NavigationEnv(**bench_kwargs(sensor_kwargs=sensors, max_episode_steps=5)))]
    _shrink_camera(*pairs[0], 16)
    for jenv, tenv in pairs:
        jst, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
        tst, tobs = tenv.reset(torch.Generator().manual_seed(0))
        jstep = jax.jit(jenv.step)
        rng = np.random.default_rng(3)
        n_done = 0
        for _ in range(8):
            a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
            jst, jout = jstep(jst, jnp.asarray(a))
            tst, tout = tenv.step(tst, torch.from_numpy(a))
            n_done += int(tout.done.sum())
            assert set(tout.obs) == set(jout.obs)
            for k, v in jout.obs.items():
                x = tout.obs[k].numpy()
                assert x.shape == v.shape and x.dtype == _np(v).dtype, k
                assert np.isfinite(x.astype(np.float32)).all(), k
            assert tout.reward.shape == (N,) and torch.isfinite(tout.reward).all()
            for k, v in jout.info.items():
                assert tout.info[k].shape == v.shape, k
        assert n_done >= N  # every agent timed out once and was respawned
        images = tenv.sensor_observations(tst)
        for k, v in jenv.sensor_observations(jst).items():
            assert images[k].numpy().shape == v.shape and images[k].numpy().dtype == v.dtype, k


# ---------------------------------------------------------------------------
# imported meshes
# ---------------------------------------------------------------------------

_CUBE_FACES = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                          [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])


def _write_room_obj(path):
    """A 12×8×3 m room of six slabs with a cube and two pillars in it, as an
    OBJ of 108 triangles."""
    parts = [((4, 0, -0.25), (6, 4, 0.25)), ((4, 0, 3.25), (6, 4, 0.25)),
             ((-2.25, 0, 1.5), (0.25, 4, 1.5)), ((10.25, 0, 1.5), (0.25, 4, 1.5)),
             ((4, -4.25, 1.5), (6, 0.25, 1.5)), ((4, 4.25, 1.5), (6, 0.25, 1.5)),
             ((4, 1, 1.5), (0.3, 0.3, 1.5)), ((6, -1.5, 1.5), (0.3, 0.3, 1.5)),
             ((7.5, 1.5, 0.5), (0.5, 0.5, 0.5))]
    with open(path, "w") as fo:
        for c, h in parts:
            for x in (-h[0], h[0]):
                for y in (-h[1], h[1]):
                    for z in (-h[2], h[2]):
                        fo.write(f"v {c[0] + x} {c[1] + y} {c[2] + z}\n")
        for i in range(len(parts)):
            for t in _CUBE_FACES + 8 * i + 1:
                fo.write(f"f {t[0]} {t[1]} {t[2]}\n")
    return str(path)


def _mesh_kwargs(obj, sensors=None, **over):
    spawn = {"class": "Uniform", "kwargs": [{"position": {"mean": [1.0, 0.0, 1.5],
                                                          "half": [0.5, 2.0, 0.4]}}]}
    sensors = sensors or [{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 64]}]
    kw = dict(scene_kwargs={"path": obj, "backend": "grid"}, sensor_kwargs=sensors,
              random_kwargs={"state_generator": spawn})
    kw.update(over)
    return bench_kwargs(**kw)


def test_mesh_slice_matches_jax(tmp_path):
    """``NavigationEnv`` on an imported OBJ (grid backend: spawn rejection on
    the baked grid, exact closest-point collisions, the exact-triangle camera),
    4 agents, 16×64 depth, 8 steps from the same state. The JAX CPU path
    traces by brute force, the port through its tiled tier with the wedge
    cull and the signed-volume body."""
    obj = _write_room_obj(tmp_path / "room.obj")
    jenv = jenvs.NavigationEnv(**_mesh_kwargs(obj))
    tenv = tenvs.NavigationEnv(**_mesh_kwargs(obj))
    np.testing.assert_array_equal(tenv.scene.sdf.numpy(), _np(jenv.scene.sdf))
    np.testing.assert_array_equal(tenv.bbox.numpy(), _np(jenv.scene.bbox))
    jst, tst, jstep = _start(jenv)
    tobs = tenv.get_observation(tst, tenv.sensor_observations(tst))
    rng = np.random.default_rng(0)
    for i in range(8):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        assert set(tout.obs) == set(jout.obs)
        _assert_depth_close(tout.obs["depth"].numpy(), _np(jout.obs["depth"]), f"step {i}")
        for k in ("state", "target"):
            np.testing.assert_allclose(tout.obs[k].numpy(), _np(jout.obs[k]), atol=TOL, rtol=0)
        _assert_step_close(tout, jout, tst, jst, i)
        np.testing.assert_allclose(tst.collision.dis.numpy(), _np(jst.collision.dis),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(tst.collision.vector.numpy(), _np(jst.collision.vector),
                                   atol=TOL, rtol=0)
    depth = tout.obs["depth"]
    assert depth.shape == (N, 1, 16, 64) and (depth < 20.0).all()  # a closed room


def test_mesh_colour_and_semantic_match_jax(tmp_path):
    """One colour and one semantic render of the mesh scene, with the default
    light and with a baked point light: equal within one count."""
    obj = _write_room_obj(tmp_path / "room.obj")
    sensors = [{"uuid": "color", "sensor_type": "color", "resolution": [16, 64]},
               {"uuid": "semantic", "sensor_type": "semantic", "resolution": [16, 64]},
               {"uuid": "small", "sensor_type": "depth", "resolution": [12, 12]}]
    lamp = {"ambient": 0.3, "lights": [{"type": "point", "position": [4.0, 0.0, 2.5],
                                        "color": [1.0, 0.9, 0.8], "intensity": 1.5}]}
    for lighting in (None, lamp):
        scene = {"path": obj, "backend": "grid", "lighting": lighting}
        jenv = jenvs.NavigationEnv(**_mesh_kwargs(obj, sensors, scene_kwargs=scene))
        tenv = tenvs.NavigationEnv(**_mesh_kwargs(obj, sensors, scene_kwargs=scene))
        # an eager reset: the JAX env bakes its lighting at the first render,
        # and under jit the cached bake would leak a tracer
        jst, _ = jenv.reset(jax.random.PRNGKey(3))
        tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
        jimg = {k: _np(v) for k, v in jenv.sensor_observations(jst).items()}
        timg = {k: v.numpy() for k, v in tenv.sensor_observations(tst).items()}
        assert timg["color"].dtype == np.uint8 and timg["color"].shape == (N, 3, 16, 64)
        _assert_uint8_close(timg["color"], jimg["color"], f"colour {lighting}")
        _assert_uint8_close(timg["semantic"], jimg["semantic"], "semantic")
        assert timg["semantic"].dtype == np.uint8 and set(np.unique(timg["semantic"])) == {1}
        assert len(np.unique(timg["color"])) > (2 if lighting is None else 8)
        # 144 rays a camera are no whole tiles: the brute force traces them
        _assert_depth_close(timg["small"], jimg["small"], "12x12 depth")


def test_mesh_env_from_baked_data_on_two_scenes(tmp_path):
    """``scene_kwargs["data"]`` hands over a baked scene, repeated over the
    env's scenes; 8 steps with the auto-reset on respawn collision-free on
    the grid."""
    from visfly_tpu_torch.scene import bake_mesh_scene

    data = bake_mesh_scene(_write_room_obj(tmp_path / "room.obj"), device="cpu")
    kw = _mesh_kwargs("unused", max_episode_steps=4)
    kw.update(scene_kwargs={"data": data}, num_scene=2, num_agent_per_scene=2)
    env = tenvs.NavigationEnv(**kw)
    assert env.scene.num_scene == 2 and env.scene.triangles.shape == (2, 112, 9)
    st, obs = env.reset(torch.Generator().manual_seed(0))
    assert not point_is_collision(env.scene, st.dyn.pos, env.scene_ids, 1.0).any()
    n_done = 0
    for _ in range(8):
        st, out = env.step(st, torch.zeros(N, 4))
        n_done += int(out.done.sum())
        assert torch.isfinite(out.obs["depth"]).all() and torch.isfinite(out.reward).all()
    assert n_done >= N and out.obs["depth"].shape == (N, 1, 16, 64)
    assert (st.collision.dis > 0.1).all()
    with pytest.raises(TypeError, match="SceneData"):
        tenvs.NavigationEnv(**dict(kw, scene_kwargs={"data": {"sdf": 0}}))
