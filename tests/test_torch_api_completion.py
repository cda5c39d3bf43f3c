"""The last public functions of ``visfly_tpu`` against their counterparts in
``visfly_tpu_torch``: the heading-frame quaternions, ``Uniform``/``Normal``/
``PID``, ``normalize_command`` and ``extend_state``, the grouped normal and
nearest-primitive queries, the XLA route's ``trace_grouped`` and the
``render_backend: "xla"`` render, and the pytree save and load. The same
numpy inputs, made from a seed, go through both packages.

Tolerances: the quaternion functions 1e-6; ``normalize_command`` round-trips
``_de_normalize`` within 1e-5 and equals JAX's within 1e-6; normals 1e-5,
nearest ids equal where the two nearest distances differ by more than 1e-5;
``trace_grouped`` in float32 (march, and analytic with 0 or 8 refine steps)
t within 1e-4 and hits equal; its gradient of summed depth w.r.t. the ray
origins within 1e-4 of the largest entry; the bfloat16 march as statistics
(XLA's CPU fusions and PyTorch round bfloat16 at different points): each
package's error against its own float32 256-step trace, the port's p99
within 1 cm of JAX's, and the two within 3 cm of each other on 99% of rays;
env renders depth 1e-3 m and colour and semantic ids one count, each on all
but 2 pixels of a 1,024-pixel camera (silhouettes), as the other render
parity tests allow. The distributions share no random stream with JAX: their
``sample`` is held to the affine map of a cloned generator's draw and to its
statistics.
"""
from collections import namedtuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace as jst  # before any jit: its module constant
from visfly_tpu import envs as jenvs
from visfly_tpu.core import quaternion as jquat
from visfly_tpu.dynamics import DroneConfig as JConfig
from visfly_tpu.dynamics import make_drone_params as j_params
from visfly_tpu.dynamics import dynamics as jdyn
from visfly_tpu.render.sphere_trace import trace_grouped as j_trace
from visfly_tpu.scene import make_scene as j_make_scene
from visfly_tpu.scene import pack_scenes as j_pack
from visfly_tpu.scene import prim_scene as jprim
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.core import PID, Normal, Uniform
from visfly_tpu_torch.core import quaternion as tquat
from visfly_tpu_torch.dynamics import DroneConfig, extend_state, make_drone_params
from visfly_tpu_torch.dynamics import dynamics as tdyn
from visfly_tpu_torch.interop import dyn_state_from_numpy, env_state_from_numpy, scene_from_numpy
from visfly_tpu_torch.render import sphere_trace as tst
from visfly_tpu_torch.render import trace_grouped
from visfly_tpu_torch.scene import prim_scene as tprim
from visfly_tpu_torch.utils.checkpoint import asarray_like, load_pytree, save_pytree

torch.set_num_threads(1)

TOL_Q = 1e-6
TOL_T = 1e-4
TOL_BF16_P99 = 0.03  # m
R = 1024


def _np(x):
    return np.asarray(x)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["xz_axis", "extract_yaw_only", "extract_pitch_roll"])
def test_quaternion_views_match_jax(name):
    q = _quats(256, 0)
    out = getattr(tquat, name)(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, _np(getattr(jquat, name)(jnp.asarray(q))), atol=TOL_Q, rtol=0)


@pytest.mark.parametrize("name", ["world_to_head", "local_to_head"])
def test_head_frames_match_jax(name):
    q = _quats(256, 1)
    v = np.random.default_rng(2).normal(size=(256, 3)).astype(np.float32)
    out = getattr(tquat, name)(torch.from_numpy(q), torch.from_numpy(v)).numpy()
    ref = _np(getattr(jquat, name)(jnp.asarray(q), jnp.asarray(v)))
    np.testing.assert_allclose(out, ref, atol=TOL_Q, rtol=0)


def test_quaternion_head_frames():
    """Mirror of the JAX package's ``test_quaternion_head_frames``."""
    q = tquat.from_euler(torch.tensor([0.2]), torch.tensor([0.1]), torch.tensor([1.0]), "zyx")
    v = torch.tensor([[1.0, 0.0, 0.0]])
    np.testing.assert_allclose(float(tquat.world_to_head(q, v)[0, 0]), np.cos(1.0), atol=1e-5)
    assert float(tquat.local_to_head(q, v)[0, 0]) > 0.9
    np.testing.assert_allclose(float(torch.linalg.vector_norm(tquat.extract_pitch_roll(q))), 1.0,
                               atol=1e-5)
    # the yaw-only quaternion keeps the yaw and nothing else
    yq = tquat.extract_yaw_only(q)
    np.testing.assert_allclose(float(tquat.yaw(yq)[0]), 1.0, atol=1e-6)
    np.testing.assert_allclose(tquat.to_euler(yq)[0, :2].numpy(), 0.0, atol=1e-6)


def _clone(gen):
    g = torch.Generator()
    g.set_state(gen.get_state())
    return g


def test_uniform_normal_sample_their_affine_maps():
    mean = torch.tensor([1.0, -2.0, 0.5])
    half = torch.tensor([0.4, 2.0, 0.0])
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((5, 3), generator=_clone(gen))
    torch.testing.assert_close(Uniform(mean, half).sample(gen, (5,)), (u - 0.5) * half + mean,
                               rtol=0, atol=0)
    std = torch.tensor([0.1, 1.0, 3.0])
    n = torch.randn((5, 3), generator=_clone(gen))
    torch.testing.assert_close(Normal(mean, std).sample(gen, (5,)), n * std + mean, rtol=0, atol=0)
    # a scalar distribution draws the batch shape alone
    assert Uniform(torch.tensor(0.0), torch.tensor(1.0)).sample(gen, (7,)).shape == (7,)


def test_uniform_normal_statistics():
    """The reference's quirk: the full width of ``Uniform`` is ``half``."""
    gen = torch.Generator().manual_seed(4)
    mean, half = torch.tensor([1.0, -2.0]), torch.tensor([0.4, 2.0])
    x = Uniform(mean, half).sample(gen, (200_000,))
    assert bool(((x >= mean - half / 2) & (x < mean + half / 2)).all())
    np.testing.assert_allclose(x.mean(0).numpy(), mean.numpy(), atol=0.01)
    np.testing.assert_allclose(x.std(0).numpy(), (half / np.sqrt(12)).numpy(), rtol=0.01)
    std = torch.tensor([0.5, 3.0])
    y = Normal(mean, std).sample(gen, (200_000,))
    np.testing.assert_allclose(y.mean(0).numpy(), mean.numpy(), atol=0.02)
    np.testing.assert_allclose(y.std(0).numpy(), std.numpy(), rtol=0.01)


def test_pid_fields_match_jax():
    from visfly_tpu.core import PID as JPID

    assert PID._fields == JPID._fields == ("p", "i", "d")
    g = PID(torch.ones(3), torch.zeros(3), torch.full((3,), 0.5))
    assert float(g.d[0]) == 0.5 and isinstance(g, tuple)


# ---------------------------------------------------------------------------
# dynamics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("action_type", ["bodyrate", "thrust", "velocity", "position"])
def test_normalize_command_inverts_de_normalize(action_type):
    """Mirror of ``test_normalize_denormalize_roundtrip`` for every action
    type: BODYRATE commands carry the z-acceleration, so the collective
    thrust is divided by the mass first. A column whose scale is 0 carries
    no action (the command is its bias) and normalises to 0."""
    kw = dict(action_type=action_type, dt=0.03, ctrl_dt=0.03)
    cfg, jcfg = DroneConfig(**kw), JConfig(**kw)
    params, jp = make_drone_params(cfg), j_params(jcfg)
    action = np.random.default_rng(5).uniform(-1, 1, (16, 4)).astype(np.float32)
    cmd = tdyn._de_normalize(cfg, params, torch.from_numpy(action))
    if action_type == "bodyrate":
        cmd = torch.cat([cmd[:, :1] / params.mass, cmd[:, 1:]], dim=-1)
    back = tdyn.normalize_command(cfg, params, cmd)
    ref = _np(jdyn.normalize_command(jcfg, jp, jnp.asarray(cmd.numpy())))
    np.testing.assert_allclose(back.numpy(), ref, atol=TOL_Q, rtol=0)
    if action_type == "thrust":
        scale = params.scale0.reshape(-1).expand(4)
    else:
        scale = torch.cat([params.scale0.reshape(-1).expand(1),
                           params.scale123.reshape(-1).expand(3)])
    live = (scale != 0).numpy()
    np.testing.assert_allclose(back.numpy()[:, live], action[:, live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(back.numpy()[:, ~live], 0.0, atol=1e-6)


def test_extend_state_matches_jax():
    cfg = JConfig(action_type="bodyrate", dt=0.03, ctrl_dt=0.03)
    jp = j_params(cfg)
    s = jdyn.init_state(cfg, jp, 8)
    a = jnp.asarray(np.random.default_rng(6).uniform(-0.5, 0.5, (8, 4)), jnp.float32)
    for _ in range(3):
        s = jdyn.step(cfg, jp, s, a)
    ts = dyn_state_from_numpy(jax.tree_util.tree_map(np.asarray, s))
    out = extend_state(ts)
    assert out.shape == (8, 28)
    np.testing.assert_array_equal(out.numpy(), _np(jdyn.extend_state(s)))


# ---------------------------------------------------------------------------
# scene queries
# ---------------------------------------------------------------------------


def _scenes(preset="garage_simple_l_medium"):
    jsc = j_pack([j_make_scene(preset, seed=0), j_make_scene(preset, seed=1)])
    return jsc, scene_from_numpy(jax.tree_util.tree_map(np.asarray, jsc))


def _points(n, seed):
    return np.random.default_rng(seed).uniform([-1, -5, 0.2], [17, 5, 4.5],
                                               (2, n, 3)).astype(np.float32)


def test_scene_normal_grouped_matches_jax():
    jsc, sc = _scenes()
    p = _points(1024, 7)
    ref = _np(jprim.scene_normal_grouped(jsc, jnp.asarray(p)))
    with torch.no_grad():  # the callers' mode: grad is enabled inside
        out = tprim.scene_normal_grouped(sc, torch.from_numpy(p))
    assert not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # a point that requires a gradient keeps the graph
    x = torch.from_numpy(p).requires_grad_(True)
    assert tprim.scene_normal_grouped(sc, x).requires_grad


def test_nearest_primitive_grouped_matches_jax():
    jsc, sc = _scenes()
    p = _points(1024, 8)
    ref = _np(jprim.nearest_primitive_grouped(jsc, jnp.asarray(p)))
    out = tprim.nearest_primitive_grouped(sc, torch.from_numpy(p)).numpy()
    dist = np.sort(_np(jax.vmap(jprim.prim_distances)(jsc.params, jnp.asarray(p))), axis=-1)
    untied = dist[..., 1] - dist[..., 0] > 1e-5
    assert untied.mean() > 0.99
    np.testing.assert_array_equal(out[untied], ref[untied])


# ---------------------------------------------------------------------------
# the XLA route's trace
# ---------------------------------------------------------------------------


def _rays(sc, seed):
    """2 scenes × R rays from free space (SDF > 0.1) in each scene, (2, R, 3)."""
    rng = np.random.default_rng(seed)
    os, ds = [], []
    for s in range(2):
        o = []
        while sum(len(x) for x in o) < R:
            x = (np.asarray([1.0, 0.0, 1.5]) + rng.uniform(-1, 1, (4 * R, 3))
                 * np.asarray([0.8, 3.0, 0.8])).astype(np.float32)
            keep = tprim.prim_sdf(sc.params[s], torch.from_numpy(x)).numpy() > 0.1
            o.append(x[keep])
        os.append(np.concatenate(o)[:R])
        d = rng.normal(size=(R, 3))
        ds.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return np.stack(os).astype(np.float32), np.stack(ds).astype(np.float32)


def _objects(o):
    """Three spheres a scene: one around ray 0's origin (left out for that
    ray), two out in the room."""
    pos = np.stack([np.stack([o[s, 0], [2.5, 0.3, 1.4], [1.0, -1.5, 1.2]]) for s in range(2)])
    rad = np.asarray([[0.2, 0.4, 0.3]] * 2, np.float32)
    return pos.astype(np.float32), rad


def _both(jsc, sc, o, d, objects, **kw):
    jkw = dict(kw)
    if "compute_dtype" in kw:
        jkw["compute_dtype"] = getattr(jnp, kw["compute_dtype"])
    jobj = None if objects is None else tuple(jnp.asarray(x) for x in objects)
    tobj = None if objects is None else tuple(torch.from_numpy(x) for x in objects)
    t_ref, hit_ref = j_trace(jsc, jnp.asarray(o), jnp.asarray(d), jobj, **jkw)
    t, hit = trace_grouped(sc, torch.from_numpy(o), torch.from_numpy(d), tobj, **kw)
    return t.numpy(), hit.numpy(), _np(t_ref), _np(hit_ref)


CASES = {"march_f32": dict(compute_dtype="float32"),
         "analytic": dict(mode="analytic"),
         "analytic_refine8": dict(mode="analytic", refine_steps=8)}


@pytest.mark.parametrize("objects", [False, True], ids=["scene", "objects"])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_grouped_matches_jax(case, objects):
    jsc, sc = _scenes("garage_simple")
    o, d = _rays(sc, 9)
    obj = _objects(o) if objects else None
    t, hit, t_ref, hit_ref = _both(jsc, sc, o, d, obj, **CASES[case])
    assert t.shape == hit.shape == (2, R) and t.dtype == np.float32
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(t, t_ref, atol=TOL_T, rtol=0)
    assert 0.3 < hit.mean() <= 1.0
    if objects:  # the sphere around ray 0's origin is invisible to it
        own = (obj[0][:, :1], obj[1][:, :1])
        t_own, _, _, _ = _both(jsc, sc, o[:, :1], d[:, :1], own, **CASES[case])
        free, _, _, _ = _both(jsc, sc, o[:, :1], d[:, :1], None, **CASES[case])
        np.testing.assert_array_equal(t_own, free)


@pytest.mark.parametrize("objects", [False, True], ids=["scene", "objects"])
def test_trace_grouped_bfloat16_matches_jax_statistics(objects):
    """The bfloat16 march (the default, 40 steps) as statistics: each
    package's |Δt| against its own float32 256-step trace of the same rays,
    the port's p99 within 1 cm and p90 within 2 mm of JAX's; hits equal; the
    port's t within 3 cm of JAX's on 99% of rays. The JAX docstring's own
    bound, p99 ≤ 3 cm, holds in neither package on these rays: both stand at
    17-21 cm here, grazing rays that a bfloat16 distance stops early."""
    jsc, sc = _scenes("garage_simple")
    o, d = _rays(sc, 10)
    obj = _objects(o) if objects else None
    t, hit, t_ref, hit_ref = _both(jsc, sc, o, d, obj)
    t64, hit64, j64, jhit64 = _both(jsc, sc, o, d, obj, n_steps=256, compute_dtype="float32")
    err, j_err = np.abs(t - t64)[hit64], np.abs(t_ref - j64)[jhit64]
    for q, tol in ((99, 0.01), (90, 0.002)):
        assert np.percentile(err, q) <= np.percentile(j_err, q) + tol, q
    np.testing.assert_array_equal(hit, hit_ref)
    assert np.percentile(np.abs(t - t_ref), 99) <= TOL_BF16_P99
def test_trace_grouped_gradient_matches_jax():
    """d(sum of t)/d(origins) in analytic mode: the closed-form candidate is
    detached, the gradient flows through the residual step at the hit."""
    jsc, sc = _scenes("garage_simple")
    o, d = _rays(sc, 11)
    obj = _objects(o)
    jobj = tuple(jnp.asarray(x) for x in obj)
    g_ref = _np(jax.grad(lambda x: jnp.sum(j_trace(jsc, x, jnp.asarray(d), jobj,
                                                   mode="analytic")[0]))(jnp.asarray(o)))
    x = torch.from_numpy(o).requires_grad_(True)
    t, _ = trace_grouped(sc, x, torch.from_numpy(d), tuple(torch.from_numpy(v) for v in obj),
                         mode="analytic")
    t.sum().backward()
    g = x.grad.numpy()
    assert np.abs(g_ref).max() > 0.5
    assert np.abs(g - g_ref).max() <= 1e-4 * np.abs(g_ref).max()


# ---------------------------------------------------------------------------
# render_backend: "xla"
# ---------------------------------------------------------------------------

N = 2
RES = [16, 64]  # one 1,024-pixel camera an agent
NEAR = {"name": "near", "path": {"class": "circle",
                                 "kwargs": {"radius": 0.8, "center": [2.5, 0, 1.5]}},
        "velocity": 1.5, "radius": 0.4}
FAR = {"name": "far", "path": {"class": "circle",
                               "kwargs": {"radius": 1.5, "center": [4.0, 1.0, 1.5]}},
       "velocity": 1.0, "radius": 0.6}


def _xla_sensors(**extra):
    return [dict({"uuid": u, "sensor_type": u, "resolution": RES, "render_backend": "xla"},
                 **extra) for u in ("depth", "color", "semantic")]


def _nav_kwargs(sensors):
    return dict(num_agent_per_scene=N, visual=True, max_episode_steps=256,
                scene_kwargs={"path": "garage_simple_l_medium", "obj_settings": [NEAR, FAR]},
                sensor_kwargs=sensors,
                random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                    {"position": {"mean": [0.5, 0.0, 1.5], "half": [0.3, 0.5, 0.3]}}]}},
                dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})


def _assert_depth_close(out, ref, msg):
    off = np.abs(out - ref) > 1e-3
    assert off.sum(axis=(1, 2, 3)).max() <= 2, (msg, np.argwhere(off))


def _assert_uint8_close(out, ref, msg):
    diff = np.abs(out.astype(int) - ref.astype(int)).max(axis=1)
    assert (diff > 1).sum(axis=(1, 2)).max() <= 2, (msg, np.argwhere(diff > 1))


def test_navigation_env_xla_render_matches_jax():
    """``NavigationEnv`` with template-less sphere objects and the three
    camera types on the XLA route, from the JAX reset's state, after two
    steps: object pixels shade by the nearest primitive as on the JAX CPU
    path (the kernel route gives them 82 and 255 instead)."""
    sensors = _xla_sensors()
    jenv = jenvs.NavigationEnv(**_nav_kwargs(sensors))
    tenv = tenvs.NavigationEnv(device="cpu", **_nav_kwargs(sensors))
    jstate, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tstate = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate))
    jstep = jax.jit(lambda s, a: jenv.step(s, a, is_test=True))
    rng = np.random.default_rng(12)
    for _ in range(2):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jstate, _ = jstep(jstate, jnp.asarray(a))
        tstate, _ = tenv.step(tstate, torch.from_numpy(a), is_test=True)
    ref = {k: _np(v) for k, v in jenv.sensor_observations(jstate).items()}
    out = {k: v.numpy() for k, v in tenv.sensor_observations(tstate).items()}
    assert out["depth"].shape == (N, 1, *RES) and out["color"].shape == (N, 3, *RES)
    _assert_depth_close(out["depth"], ref["depth"], "depth")
    _assert_uint8_close(out["color"], ref["color"], "color")
    _assert_uint8_close(out["semantic"], ref["semantic"], "semantic")
    # the objects are in view, and their pixels are no kernel-route grey
    kernel = tenvs.NavigationEnv(device="cpu", **_nav_kwargs(
        [dict(s, render_backend="pallas") for s in sensors]))
    k_out = {k: v.numpy() for k, v in kernel.sensor_observations(tstate).items()}
    obj_px = k_out["semantic"] == 255
    assert obj_px.any() and not (out["semantic"] == 255).any()


def _camera():
    jsc, sc = _scenes("garage_simple")
    pos = np.asarray([[1.0, 0.0, 1.5], [1.2, 1.0, 1.0], [1.4, -1.0, 1.2], [0.8, 0.5, 1.6]],
                     np.float32)
    q = _np(jquat.from_euler(jnp.zeros(4), jnp.zeros(4), jnp.asarray([0.0, 0.25, -0.4, 0.1])))
    objects = (np.asarray([[pos[0], [2.6, 0.2, 1.4]], [pos[2], [2.4, -0.5, 1.0]]], np.float32),
               np.asarray([[0.2, 0.4], [0.2, 0.3]], np.float32))
    return jsc, sc, pos, q, objects


SPECS = {
    "analytic": {},
    "analytic_refine2": {"analytic_refine": 2},
    "march_f32": {"trace_mode": "march", "render_dtype": "float32"},
    "march_f32_tile4": {"trace_mode": "march", "render_dtype": "float32", "tile": 4},
}


@pytest.mark.parametrize("stype", ["depth", "semantic"])
@pytest.mark.parametrize("name", list(SPECS))
def test_render_camera_xla_route_matches_jax(name, stype):
    """Two scenes of two agents, objects as spheres, each XLA-route option
    against the JAX CPU render (which takes the same route)."""
    jsc, sc, pos, q, objects = _camera()
    spec = dict(SPECS[name], sensor_type=stype, resolution=RES, render_backend="xla")
    ref = jst.render_camera(jsc, jnp.asarray([0, 0, 1, 1]), jnp.asarray(pos), jnp.asarray(q),
                            spec, objects=tuple(jnp.asarray(x) for x in objects))[stype]
    out = tst.render_camera(sc, torch.from_numpy(pos), torch.from_numpy(q), spec,
                            objects=tuple(torch.from_numpy(x) for x in objects))[stype]
    img, img_ref = out.numpy(), _np(ref)
    assert img.shape == img_ref.shape == (4, 1, *RES) and img.dtype == img_ref.dtype
    if stype == "depth":
        _assert_depth_close(img, img_ref, name)
        assert img[0].min() > 0.5  # the first camera does not see the sphere around it
    else:
        _assert_uint8_close(img, img_ref, name)
        assert len(np.unique(img)) > 2


def test_render_camera_xla_route_bfloat16_matches_jax():
    """The default ``render_dtype`` on the march, with and without objects:
    hits equal on all but 2 pixels a camera; the depth image within 1e-3 m
    of JAX's at the median and within 3 cm on 95% of pixels (a grazing ray
    whose bfloat16 distance rounds the other way stops a step apart); each
    package's p99 against its own float32 render within 1 cm of the
    other's."""
    jsc, sc, pos, q, objects = _camera()
    spec = {"sensor_type": "depth", "resolution": RES, "render_backend": "xla",
            "trace_mode": "march"}
    for objs in (None, objects):
        jobj = None if objs is None else tuple(jnp.asarray(x) for x in objs)
        tobj = None if objs is None else tuple(torch.from_numpy(x) for x in objs)
        sid, jp, jq = jnp.asarray([0, 0, 1, 1]), jnp.asarray(pos), jnp.asarray(q)
        tp, tq = torch.from_numpy(pos), torch.from_numpy(q)
        ref = _np(jst.render_camera(jsc, sid, jp, jq, spec, objects=jobj)["depth"])
        out = tst.render_camera(sc, tp, tq, spec, objects=tobj)["depth"].numpy()
        f32 = dict(spec, render_dtype="float32")
        ref32 = _np(jst.render_camera(jsc, sid, jp, jq, f32, objects=jobj)["depth"])
        out32 = tst.render_camera(sc, tp, tq, f32, objects=tobj)["depth"].numpy()
        assert ((out < 20.0) != (ref < 20.0)).sum(axis=(1, 2, 3)).max() <= 2
        diff = np.abs(out - ref)
        assert np.median(diff) <= 1e-3 and np.percentile(diff, 95) <= TOL_BF16_P99
        assert abs(np.percentile(np.abs(out - out32), 99)
                   - np.percentile(np.abs(ref - ref32), 99)) <= 0.01


def test_render_backend_picks_the_route(monkeypatch):
    """Only ``"xla"`` takes the XLA route; no value, or another, keeps the
    kernel route (``trace_diff``)."""
    _, sc, pos, q, _ = _camera()
    calls = {"kernel": 0, "xla": 0}
    kernel, xla = tst.trace_diff, tst.trace_grouped

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tst, "trace_diff", count("kernel", kernel))
    monkeypatch.setattr(tst, "trace_grouped", count("xla", xla))
    for backend, want in ((None, (1, 0)), ("pallas", (2, 0)), ("xla", (2, 1)),
                          ("grid", (3, 1))):
        spec = {"sensor_type": "depth", "resolution": RES, "trace_mode": "march", "tile": 4}
        if backend is not None:
            spec["render_backend"] = backend
        tst.render_camera(sc, torch.from_numpy(pos), torch.from_numpy(q), spec)
        assert (calls["kernel"], calls["xla"]) == want, (backend, calls)


def test_xla_route_is_differentiable():
    """A rollout's depth differentiates through the XLA route, as JAX's does
    through its ``fori_loop``: the gradient w.r.t. the camera positions
    equals JAX's."""
    jsc, sc, pos, q, _ = _camera()
    spec = {"sensor_type": "depth", "resolution": RES, "render_backend": "xla"}
    sid = jnp.asarray([0, 0, 1, 1])
    g_ref = _np(jax.grad(lambda p: jnp.sum(jst.render_camera(
        jsc, sid, p, jnp.asarray(q), spec)["depth"]))(jnp.asarray(pos)))
    x = torch.from_numpy(pos).requires_grad_(True)
    tst.render_camera(sc, x, torch.from_numpy(q), spec)["depth"].sum().backward()
    assert np.abs(g_ref).max() > 1.0
    np.testing.assert_allclose(x.grad.numpy(), g_ref, atol=1e-4 * np.abs(g_ref).max(), rtol=0)


# ---------------------------------------------------------------------------
# pytree save and load
# ---------------------------------------------------------------------------

Tree = namedtuple("Tree", ["a", "b", "nested"])


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return Tree(a=torch.randn(3, 4, generator=g),
                b=torch.randint(0, 9, (5,), generator=g),
                nested={"mask": torch.rand(2, generator=g) > 0.5,
                        "x64": torch.randn(2, 2, generator=g, dtype=torch.float64),
                        "pair": (torch.arange(3, dtype=torch.int32), 7),
                        "gen": torch.Generator().manual_seed(seed + 100)})


def test_save_and_load_pytree_round_trip(tmp_path):
    tree = _tree(0)
    path = save_pytree(str(tmp_path / "tree"), tree)
    assert path.endswith(".pt")
    template = _tree(1)
    out = load_pytree(str(tmp_path / "tree"), template)
    assert isinstance(out, Tree) and isinstance(out.nested["pair"], tuple)
    for got, want, tmpl in ((out.a, tree.a, template.a), (out.b, tree.b, template.b),
                            (out.nested["mask"], tree.nested["mask"], template.nested["mask"]),
                            (out.nested["x64"], tree.nested["x64"], template.nested["x64"]),
                            (out.nested["pair"][0], tree.nested["pair"][0],
                             template.nested["pair"][0])):
        assert got.dtype == tmpl.dtype and got.device == tmpl.device
        assert torch.equal(got, want) and got is not tmpl
    assert out.nested["pair"][1] == 7
    torch.testing.assert_close(torch.rand(4, generator=out.nested["gen"]),
                               torch.rand(4, generator=tree.nested["gen"]))
    # the template is not written, but for a tensor that requires a gradient,
    # which is restored in place (a module keeps its parameters)
    assert not torch.equal(template.a, tree.a)
    w = torch.nn.Parameter(torch.zeros(3, 4))
    out = load_pytree(path, Tree(w, template.b, template.nested))
    assert out.a is w and torch.equal(w.detach(), tree.a)
    with pytest.raises(ValueError):
        load_pytree(path, Tree(torch.zeros(2), template.b, template.nested))


def test_asarray_like_casts_to_the_template():
    saved = np.arange(4, dtype=np.float64)
    out = asarray_like(saved, torch.zeros(4, dtype=torch.float32))
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), saved)
    assert asarray_like(7, torch.zeros(())) == 7  # not an array: as saved
    assert asarray_like("x", 3) == "x"
