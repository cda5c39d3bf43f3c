"""The port's dynamic objects (``scene/templates.py``, ``scene/objects.py``,
the object hits of ``render/sphere_trace.py`` and the objects of
``envs/base.py``) against ``visfly_tpu``'s.

Tolerances: the templates and the path tables are host-side numpy in both
packages and equal to the bit; object stepping and the sphere queries agree
within 1e-6; the object hits within 1e-5 m in t up to 1 m and 1e-5 of t
beyond (float32 Möller–Trumbore: on the random rays of
``test_batched_scenes_and_objects_match_jax`` each package is up to 1.6e-5 m
from a float64 evaluation at t ≈ 4 m) and 1e-4 in the normal (a sphere's
normal carries the hit point's error over its radius);
renders with objects agree within 1e-3 m in depth and one count in colour on
all but 2 pixels per 1,024-pixel camera, as the port's other render parity
tests allow (grazing and silhouette rays).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace as jst_mod
from visfly_tpu import envs as jenvs
from visfly_tpu.core import quaternion as jquat
from visfly_tpu.scene import objects as jobj
from visfly_tpu.scene import templates as jtpl
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.core import quaternion as tquat
from visfly_tpu_torch.interop import (dynamic_objects_from_numpy, env_state_from_numpy,
                                      objects_state_from_numpy)
from visfly_tpu_torch.render import sphere_trace as tst_mod
from visfly_tpu_torch.scene import objects as tobj
from visfly_tpu_torch.scene import templates as ttpl

torch.set_num_threads(1)

TOL_HIT = 1e-5
TOL_NORMAL = 1e-4
TOL_DEPTH = 1e-3

CIRCLE = {"name": "mover", "path": {"class": "circle",
                                    "kwargs": {"radius": 2.0, "center": [0, 0, 2]}},
          "velocity": 1.0, "radius": 0.3}
POLYGON = {"name": "patrol", "path": {"class": "polygon", "kwargs": {
    "points": [[0, 0, 1], [4, 0, 1], [4, 4, 1]]}}, "velocity": 2.0}
CUBIC = {"name": "wander", "path": {"class": "cubic", "kwargs": {"points": {"kwargs": {
    "position": {"mean": [2, 0, 1.5], "half": [1.5, 1.5, 0.5]}, "num": 5}}}},
    "velocity": 1.5, "num": 2}
CUBIC_FREE = {"name": "drift", "path": {"class": "cubic", "kwargs": {"points": {"kwargs": {
    "position": {"mean": [0, 2, 2], "half": [1, 1, 0.5]},
    "velocity": {"half": [2, 2, 1]}}}}}, "radius": 0.2}
DRONE_OBJ = dict(CIRCLE, name="drone", model_path="drone", radius=0.35)
HUMAN_OBJ = dict(POLYGON, name="human", model_path="human", radius=0.9)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# templates and tables: host-side numpy in both packages
# ---------------------------------------------------------------------------

def _write_sphere_obj(path):
    """An icosphere of 320 triangles as an OBJ (a vertex per corner)."""
    tris = ttpl.sphere_template(1.3, subdiv=2).reshape(-1, 3, 3) + np.float32([2, 0, 1])
    with open(path, "w") as fo:
        for v in tris.reshape(-1, 3):
            fo.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for i in range(tris.shape[0]):
            fo.write(f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}\n")
    return str(path)


TEMPLATES = {
    "drone": lambda m: m.drone_template(0.25),
    "drone_wide": lambda m: m.drone_template(0.6),
    "human": lambda m: m.human_template(),
    "box": lambda m: m.box_template((0.3, 0.2, 0.1)),
    "sphere_0": lambda m: m.sphere_template(0.5, subdiv=0),
    "sphere_2": lambda m: m.sphere_template(1.0, subdiv=2),
    "decimate": lambda m: m.decimate_tris(m.sphere_template(1.0, subdiv=2), 64),
    "fit_ground": lambda m: m.fit_to_radius(m.human_template(), 0.8, ground=True),
    "object_names": lambda m: np.concatenate(
        [m.object_template(n, r) for n, r in (("uav", 0.3), ("person", 1.0), ("box", None),
                                              ("ball", 0.4), ("sphere", None))]),
    "pad": lambda m: m.pad_templates([m.human_template(), None, m.drone_template(0.2)]),
}


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_templates_equal_jax(name):
    got, want = TEMPLATES[name](ttpl), TEMPLATES[name](jtpl)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_object_template_from_file(tmp_path):
    """A model file goes through the port's own mesh loader, decimated and
    fitted as in the JAX package; an unknown name raises."""
    path = _write_sphere_obj(tmp_path / "ball.obj")
    got = ttpl.object_template(path, radius=0.7)
    np.testing.assert_array_equal(got, jtpl.object_template(path, radius=0.7))
    assert 4 <= got.shape[0] <= ttpl.MAX_TEMPLATE_TRIS < 320
    np.testing.assert_allclose(np.linalg.norm(got.reshape(-1, 3), axis=-1).max(), 0.7,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="unknown object model"):
        ttpl.object_template(str(tmp_path / "missing.obj"))


@pytest.mark.parametrize("settings", [[CIRCLE], [POLYGON], [CUBIC], [CUBIC_FREE],
                                      [CIRCLE, CUBIC, DRONE_OBJ, HUMAN_OBJ]],
                         ids=["circle", "polygon", "cubic", "cubic_free", "mixed"])
def test_build_objects_equal_jax(settings):
    """One seed gives the same tables, periods, radii, owners and templates."""
    got = tobj.build_objects(settings, num_scene=2, seed=3, device="cpu")
    want = jax.tree_util.tree_map(np.asarray, jobj.build_objects(settings, num_scene=2, seed=3))
    for f in ("table", "period", "radius"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got.scene_of.numpy(), want.scene_of)
    assert (got.mesh is None) == (want.mesh is None)
    if got.mesh is not None:
        np.testing.assert_array_equal(got.mesh.numpy(), want.mesh)
    assert got.num_objects == want.table.shape[0]


def test_load_obj_settings(tmp_path):
    import json

    path = tmp_path / "objs.json"
    path.write_text(json.dumps({"objects": [CIRCLE, POLYGON]}))
    assert tobj.load_obj_settings(str(path)) == jobj.load_obj_settings(str(path))
    assert tobj.load_obj_settings((CIRCLE,)) == [CIRCLE]


# ---------------------------------------------------------------------------
# stepping and queries
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def object_pair():
    settings = [CIRCLE, POLYGON, CUBIC]
    jo = jobj.build_objects(settings, num_scene=2, seed=0)
    return jo, dynamic_objects_from_numpy(jax.tree_util.tree_map(np.asarray, jo))


def test_step_objects_matches_jax(object_pair):
    jo, to = object_pair
    js, ts = jobj.init_objects_state(jo, 2), tobj.init_objects_state(to, 2)
    jstep = jax.jit(lambda s: jobj.step_objects(jo, s, 0.07))
    for i in range(40):
        js, ts = jstep(js), tobj.step_objects(to, ts, 0.07)
        for f in ("t", "pos", "vel"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), _np(getattr(js, f)),
                                       atol=1e-6 if f != "vel" else 1e-6 / 0.07, rtol=0,
                                       err_msg=f"step {i} {f}")


def test_dynamic_objects_step():
    """Mirror of the JAX package's test: a circle object stays on its circle
    at its speed."""
    objs = tobj.build_objects([CIRCLE, POLYGON], num_scene=2, seed=0, device="cpu")
    assert objs.num_objects == 4
    st = tobj.init_objects_state(objs, 2)
    traj = [st.pos]
    for _ in range(50):
        st = tobj.step_objects(objs, st, 0.1)
        traj.append(st.pos)
    traj = torch.stack(traj).numpy()
    np.testing.assert_allclose(np.linalg.norm(traj[:, 0, :2], axis=-1), 2.0, atol=0.05)
    spd = np.linalg.norm(np.diff(traj[:, 0], axis=0), axis=-1) / 0.1
    np.testing.assert_allclose(spd.mean(), 1.0, atol=0.1)


@pytest.mark.parametrize("query", ["sdf", "closest"])
def test_object_queries_match_jax(object_pair, query):
    jo, to = object_pair
    rng = np.random.default_rng(1)
    p = rng.uniform(-3, 5, size=(64, 3)).astype(np.float32)
    sid = rng.integers(0, 2, size=64)
    pos = np.array(jo.table[:, 7])
    if query == "sdf":
        want = _np(jobj.objects_sdf(jo, jnp.asarray(pos), jnp.asarray(sid), jnp.asarray(p)))
        got = tobj.objects_sdf(to, torch.from_numpy(pos), torch.from_numpy(sid),
                               torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        wp, wd = jobj.objects_closest(jo, jnp.asarray(pos), jnp.asarray(sid), jnp.asarray(p))
        gp, gd = tobj.objects_closest(to, torch.from_numpy(pos), torch.from_numpy(sid),
                                      torch.from_numpy(p))
        np.testing.assert_allclose(gd.numpy(), _np(wd), atol=1e-6, rtol=0)
        np.testing.assert_allclose(gp.numpy(), _np(wp), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# object hits
# ---------------------------------------------------------------------------

def _ortho_rays(n=48, extent=1.4, dist=5.0):
    """Parallel +x rays on a (y, z) grid: (1, n·n, 3) origins and dirs."""
    ys = np.linspace(-extent, extent, n)
    Y, Z = np.meshgrid(ys, ys, indexing="ij")
    o = np.stack([np.full(Y.size, -dist), Y.ravel(), Z.ravel()], -1)[None].astype(np.float32)
    d = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (Y.size, 1))[None]
    return o, d


def _objects_np(mesh, radius=1.0, pos=(0.0, 0.0, 0.0), q=None, color=110.0):
    p = np.asarray(pos, np.float32).reshape(1, 1, 3)
    objs = [p, np.full((1, 1), radius, np.float32), np.full((1, 1, 3), color, np.float32)]
    if mesh is not None:
        qq = np.asarray([1.0, 0, 0, 0] if q is None else q, np.float32).reshape(1, 1, 4)
        objs += [np.asarray(mesh, np.float32)[None, None], qq]
    return objs


def _hits_both(fn, objs, o, d, max_depth=20.0):
    """(port, JAX) outputs of an object-hit function on the same inputs."""
    got = getattr(tst_mod, fn)(tuple(torch.from_numpy(x) for x in objs),
                               torch.from_numpy(o), torch.from_numpy(d), max_depth)
    want = getattr(jst_mod, fn)(tuple(jnp.asarray(x) for x in objs), jnp.asarray(o),
                                jnp.asarray(d), max_depth)
    return [g.numpy() for g in got], [_np(w) for w in want]


def _assert_hits_close(got, want):
    t, hit, n, col = got
    np.testing.assert_array_equal(hit, want[1])
    t_ref = np.where(want[1], want[0], 0)
    err = np.abs(np.where(hit, t, 0) - t_ref)
    assert (err <= TOL_HIT * np.maximum(1.0, t_ref)).all(), err.max()
    np.testing.assert_allclose(n[hit], want[2][hit], atol=TOL_NORMAL, rtol=0)
    np.testing.assert_array_equal(col, want[3])


def _silhouette(hit, n=48):
    img = np.asarray(hit).reshape(n, n)  # [y, z]
    ys, zs = np.where(img)
    return (np.ptp(ys) + 1, np.ptp(zs) + 1) if ys.size else (0, 0)


def test_sphere_hits_match_jax():
    o, d = _ortho_rays()
    got, want = _hits_both("_object_sphere_hits", _objects_np(None, 0.8), o, d)
    _assert_hits_close(got, want)
    w, h = _silhouette(got[1])
    assert abs(w - h) <= 1 and w > 10


def test_zero_template_falls_back_to_sphere_exactly():
    o, d = _ortho_rays()
    got, want = _hits_both("_object_mesh_hits", _objects_np(np.zeros((8, 9)), 0.8), o, d)
    sphere = tst_mod._object_sphere_hits(
        tuple(torch.from_numpy(x) for x in _objects_np(None, 0.8)), torch.from_numpy(o),
        torch.from_numpy(d), 20.0)
    for g, s in zip(got, sphere):
        np.testing.assert_array_equal(g, s.numpy())
    _assert_hits_close(got, want)


def test_human_template_silhouette_matches_jax():
    o, d = _ortho_rays()
    got, want = _hits_both("_object_mesh_hits", _objects_np(ttpl.object_template("human", 1.0)),
                           o, d)
    _assert_hits_close(got, want)
    w, h = _silhouette(got[1])
    assert h > 1.6 * w
    assert (got[2][got[1]][:, 0] <= 1e-6).all()  # normals face the viewer


def test_drone_template_rotates_with_airframe():
    o, d = _ortho_rays(extent=0.4)
    mesh = ttpl.drone_template(0.25)
    got, want = _hits_both("_object_mesh_hits", _objects_np(mesh, 0.25), o, d)
    _assert_hits_close(got, want)
    w_level, h_level = _silhouette(got[1])
    assert w_level > 2.0 * h_level
    q90 = tquat.from_euler(torch.tensor([np.pi / 2]), torch.zeros(1), torch.zeros(1))
    q90_j = jquat.from_euler(jnp.asarray([np.pi / 2]), jnp.zeros(1), jnp.zeros(1))
    np.testing.assert_allclose(q90.numpy(), _np(q90_j), atol=1e-7)
    got, want = _hits_both("_object_mesh_hits", _objects_np(mesh, 0.25, q=q90.numpy()), o, d)
    _assert_hits_close(got, want)
    w_roll, h_roll = _silhouette(got[1])
    assert h_roll > 2.0 * w_roll
    assert float(np.linalg.norm(mesh.reshape(-1, 3), axis=-1).max()) <= 0.2501


def test_mesh_self_exclusion_origin_inside_bound():
    objs = _objects_np(ttpl.drone_template(0.3), 0.3)
    o = np.zeros((1, 1, 3), np.float32)
    d = np.asarray([[[1.0, 0.0, 0.0]]], np.float32)
    got, want = _hits_both("_object_mesh_hits", objs, o, d)
    assert not got[1][0, 0] and not want[1][0, 0]
    # and the same ray from outside sees it
    got, _ = _hits_both("_object_mesh_hits", objs, o - np.float32([[[2.0, 0, 0]]]), d)
    assert got[1][0, 0]


def test_mixed_soup_mesh_and_sphere_objects():
    """A padded-out (None) template renders as its sphere in the same pass,
    with each object's colour."""
    mesh = ttpl.pad_templates([ttpl.object_template("human", 1.0), None])
    objs = [np.asarray([[[0.0, -1.6, 0.0], [0.0, 1.6, 0.0]]], np.float32),
            np.full((1, 2), 1.0, np.float32),
            np.asarray([[[200.0, 0.0, 0.0], [0.0, 200.0, 0.0]]], np.float32),
            mesh[None], np.tile(np.float32([1, 0, 0, 0]), (1, 2, 1))]
    o, d = _ortho_rays(n=64, extent=3.2)
    got, want = _hits_both("_object_mesh_hits", objs, o, d)
    _assert_hits_close(got, want)
    img = got[1].reshape(64, 64)
    colr = got[3].reshape(64, 64, 3)
    ys = np.linspace(-3.2, 3.2, 64)
    left, right = img[ys < -0.5], img[ys > 0.5]
    assert 0 < left.sum() < 0.6 * right.sum()
    assert (colr[ys < -0.5][left][:, 0] == 200.0).all()
    assert (colr[ys > 0.5][right][:, 1] == 200.0).all()


def test_batched_scenes_and_objects_match_jax():
    """Two scenes, three objects each (mesh, sphere fallback, rotated mesh),
    random rays from inside and outside the objects."""
    rng = np.random.default_rng(4)
    mesh = ttpl.pad_templates([ttpl.drone_template(0.5), None, ttpl.human_template()])
    pos = rng.uniform(-1, 1, size=(2, 3, 3)).astype(np.float32)
    q = rng.normal(size=(2, 3, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    objs = [pos, np.full((2, 3), 0.9, np.float32), rng.uniform(0, 255, (2, 3, 3)).astype(
        np.float32), np.broadcast_to(mesh, (2, 3, *mesh.shape[1:])).copy(), q]
    o = rng.uniform(-3, 3, size=(2, 2048, 3)).astype(np.float32)
    aim = pos[:, rng.integers(0, 3, 2048)] + rng.normal(0, 0.4, (2, 2048, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got, want = _hits_both("_object_mesh_hits", objs, o, d.astype(np.float32), 6.0)
    _assert_hits_close(got, want)
    assert 0.2 < got[1].mean() < 0.95


# ---------------------------------------------------------------------------
# renders and env steps with objects
# ---------------------------------------------------------------------------

N = 4
SENSORS = [{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 16]},
           {"uuid": "color", "sensor_type": "color", "resolution": [16, 16]},
           {"uuid": "semantic", "sensor_type": "semantic", "resolution": [16, 16]}]
NEAR = {"name": "near", "path": {"class": "circle",
                                 "kwargs": {"radius": 0.8, "center": [2.5, 0, 1.5]}},
        "velocity": 1.5, "radius": 0.4}


def _room_obj(path):
    """A 12×8×3 m room of six slabs and two pillars (96 triangles)."""
    boxes = [((4, 0, -0.25), (6, 4, 0.25)), ((4, 0, 3.25), (6, 4, 0.25)),
             ((-2.25, 0, 1.5), (0.25, 4, 1.5)), ((10.25, 0, 1.5), (0.25, 4, 1.5)),
             ((4, -4.25, 1.5), (6, 0.25, 1.5)), ((4, 4.25, 1.5), (6, 0.25, 1.5)),
             ((6, 1, 1.5), (0.3, 0.3, 1.5)), ((7, -1.5, 1.5), (0.3, 0.3, 1.5))]
    faces = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
             [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    with open(path, "w") as fo:
        for c, h in boxes:
            for x in (-h[0], h[0]):
                for y in (-h[1], h[1]):
                    for z in (-h[2], h[2]):
                        fo.write(f"v {c[0] + x} {c[1] + y} {c[2] + z}\n")
        for i in range(len(boxes)):
            for f in faces:
                fo.write("f " + " ".join(str(8 * i + v + 1) for v in f) + "\n")
    return str(path)


def _dyn_kwargs(scene_kwargs, obj_settings):
    return dict(num_agent_per_scene=N, visual=True, max_episode_steps=256,
                scene_kwargs=dict(scene_kwargs, obj_settings=obj_settings),
                sensor_kwargs=SENSORS,
                random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                    {"position": {"mean": [0.5, 0.0, 1.5], "half": [0.3, 0.5, 0.3]}}]}},
                dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})


def _assert_depth_close(out, ref, msg):
    off = np.abs(out - ref) > TOL_DEPTH
    assert off.sum(axis=(1, 2, 3)).max() <= 2, (msg, np.argwhere(off))


def _assert_uint8_close(out, ref, msg):
    diff = np.abs(out.astype(int) - ref.astype(int)).max(axis=1)
    assert (diff > 1).sum(axis=(1, 2)).max() <= 2, (msg, np.argwhere(diff > 1))


SCENES = {
    "primitive_spheres": ({"path": "box15_wall_empty"}, [NEAR, CIRCLE]),
    "primitive_templates": ({"path": "garage_simple_l_medium"},
                            [NEAR, dict(NEAR, model_path="drone", radius=0.5,
                                        path={"class": "circle", "kwargs": {
                                            "radius": 0.6, "center": [2.0, 0.5, 1.6]}}),
                             dict(HUMAN_OBJ, path={"class": "polygon", "kwargs": {
                                 "points": [[3, -1, 0.2], [3, 1, 0.2]]}})]),
    "mesh": (None, [NEAR, dict(NEAR, model_path="drone", radius=0.5)]),
}


@pytest.mark.parametrize("case", list(SCENES))
def test_dyn_env_with_objects_matches_jax(case, tmp_path):
    """``DynEnv`` with objects (spheres in the kernel's scene, templates
    after it, and objects in a triangle scene), from the JAX reset's state:
    3 steps, the depth observation, reward, collisions and the objects'
    state; then depth, colour and semantic renders of the last state."""
    scene_kwargs, objs = SCENES[case]
    if scene_kwargs is None:
        scene_kwargs = {"path": _room_obj(tmp_path / "room.obj"), "backend": "grid"}
    jenv = jenvs.DynEnv(**_dyn_kwargs(scene_kwargs, objs))
    tenv = tenvs.DynEnv(device="cpu", **_dyn_kwargs(scene_kwargs, objs))
    assert (tenv.objects.mesh is None) == (case == "primitive_spheres")
    jst, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    jstep = jax.jit(lambda s, a: jenv.step(s, a, is_test=True))
    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        _assert_depth_close(tout.obs["depth"].numpy(), _np(jout.obs["depth"]), f"step {i}")
        np.testing.assert_allclose(tout.reward.numpy(), _np(jout.reward), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tst.collision.dis.numpy(), _np(jst.collision.dis),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(tst.objects.pos.numpy(), _np(jst.objects.pos), atol=1e-6,
                                   rtol=0)
    ref = {k: _np(v) for k, v in jenv.sensor_observations(jst).items()}
    out = {k: v.numpy() for k, v in tenv.sensor_observations(tst).items()}
    _assert_depth_close(out["depth"], ref["depth"], "depth")
    obj_px = out["semantic"] == 255  # the objects are in view
    assert obj_px.any()
    if case == "primitive_spheres":
        # spheres in the kernel's scene: the port shades their pixels as the
        # TPU kernel path does (grey 110 × 0.75, id 255); the JAX CPU path
        # shades every pixel by its nearest primitive. The rest must agree.
        assert (out["color"][np.broadcast_to(obj_px, out["color"].shape)] == 82).all()
        for k in ("color", "semantic"):
            ref[k] = np.where(obj_px, out[k], ref[k])
    _assert_uint8_close(out["color"], ref["color"], "color")
    _assert_uint8_close(out["semantic"], ref["semantic"], "semantic")


def test_dyn_env_with_objects():
    """Mirror of the JAX package's test: the moving obstacle changes the
    depth image over 10 steps."""
    env = tenvs.DynEnv(device="cpu", **dict(_dyn_kwargs(
        {"path": "box15_wall_empty"},
        [{"name": "mover", "path": {"class": "circle",
                                    "kwargs": {"radius": 2.0, "center": [1, 0, 1.5]}},
          "velocity": 1.5, "radius": 0.4}]), sensor_kwargs=[
        {"sensor_type": "depth", "uuid": "depth", "resolution": [32, 32]}]))
    state, obs = env.reset(torch.Generator().manual_seed(0))
    d0 = obs["depth"]
    for _ in range(10):
        state, out = env.step(state, torch.zeros(N, 4))
    assert float((d0 - out.obs["depth"]).abs().max()) > 0.05
    assert torch.isfinite(out.reward).all()
    assert isinstance(state.objects, tobj.ObjectsState)
    torch.testing.assert_close(state.objects.t, torch.full((1,), 10 * 0.03))


def test_objects_state_crosses_over():
    jo = jobj.build_objects([CIRCLE], num_scene=1, seed=0)
    js = jax.tree_util.tree_map(np.asarray, jobj.step_objects(jo, jobj.init_objects_state(jo, 1),
                                                              0.1))
    ts = objects_state_from_numpy(js)
    assert isinstance(ts, tobj.ObjectsState)
    np.testing.assert_array_equal(ts.pos.numpy(), js.pos)
    assert objects_state_from_numpy(()) == ()
