"""Mesh → primitive decomposition in the port (``scene/decompose.py`` and
the default backend of a mesh file) against ``visfly_tpu``.

Both packages bake the same mesh with the same C++ baker and cover its
occupancy with the same host numpy code, so the primitives are equal, not
close. The decomposed scene then renders through each package's analytic
trace: depth within 1e-3 m on all but 2 pixels per 1,024 (silhouettes,
ROADMAP Queue C). The contracts of ``tests/test_mesh_native.py`` hold too:
primitives inside the occupancy, the cover met, cylinders on round columns,
depth within two cells of the exact mesh.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.render import render_camera as jrender_camera
from visfly_tpu.scene import decompose as jdec
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.interop import env_state_from_numpy
from visfly_tpu_torch.render import render_camera
from visfly_tpu_torch.scene import decompose as tdec
from visfly_tpu_torch.scene import mesh as tmesh
from visfly_tpu_torch.scene.prim_scene import PrimitiveScene, pack_scenes
from visfly_tpu_torch.scene.scene import SceneData

torch.set_num_threads(1)

DEPTH_TOL = 1e-3
_CUBE_FACES = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                          [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                         np.int32)


def cube(center, half):
    v = np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                   np.float32) * half + np.asarray(center, np.float32)
    return v, _CUBE_FACES.copy()


def cylinder(cx, cy, radius, z0, z1, n=24):
    """A closed n-gon prism around a vertical axis."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([cx + radius * np.cos(ang), cy + radius * np.sin(ang)], 1)
    verts = np.concatenate([np.concatenate([ring, np.full((n, 1), z0)], 1),
                            np.concatenate([ring, np.full((n, 1), z1)], 1),
                            [[cx, cy, z0], [cx, cy, z1]]]).astype(np.float32)
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + j], [i, n + j, n + i], [2 * n, j, i], [2 * n + 1, n + i, n + j]]
    return verts, np.asarray(faces, np.int32)


def ramp(x0, x1, y0, y1, h):
    verts = np.asarray([[x0, y0, 0], [x1, y0, 0], [x1, y0, h], [x0, y1, 0], [x1, y1, 0],
                        [x1, y1, h]], np.float32)
    faces = np.asarray([[0, 1, 2], [3, 5, 4], [0, 2, 5], [0, 5, 3], [0, 3, 4], [0, 4, 1],
                        [1, 4, 5], [1, 5, 2]], np.int32)
    return verts, faces


def merge(*meshes):
    vs, fs, base = [], [], 0
    for v, f in meshes:
        vs.append(v)
        fs.append(f + base)
        base += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def write_obj(path, v, f):
    with open(path, "w") as fo:
        for p in v:
            fo.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in f:
            fo.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return str(path)


def assert_specs_equal(a, b):
    np.testing.assert_array_equal(a.bounds_min, b.bounds_min)
    np.testing.assert_array_equal(a.bounds_max, b.bounds_max)
    assert a.name == b.name and a.primitives == b.primitives


def depth_of(data, pos, q, res, n_steps, max_depth):
    cam = {"sensor_type": "depth", "resolution": [res, res]}
    return render_camera(data, torch.tensor(pos), torch.tensor(q), cam, n_steps=n_steps,
                         max_depth=max_depth)["depth"]


def jdepth_of(data, pos, q, res, n_steps, max_depth):
    cam = {"sensor_type": "depth", "resolution": [res, res]}
    return np.asarray(jrender_camera(data, jnp.zeros(1, jnp.int32), jnp.asarray(pos),
                                     jnp.asarray(q), cam, n_steps=n_steps,
                                     max_depth=max_depth)["depth"])


def assert_depth_close(got, ref):
    off = np.abs(got.numpy() - ref) > DEPTH_TOL
    assert off.sum() <= 2 * -(-off[0, 0].size // 1024), (int(off.sum()), np.argwhere(off)[:6])


@pytest.mark.parametrize("fit_cylinders,max_prims,min_cover", [
    (True, 48, 0.98), (False, 48, 0.98), (True, 4, 0.98), (True, 96, 0.995)])
def test_sdf_grid_to_boxes_equals_jax(fit_cylinders, max_prims, min_cover):
    """The greedy cover of one grid (two cubes, a column, a ramp) in both
    packages: the same primitives in the same order."""
    v, f = merge(cube((0, 0, 1), 1.0), cube((4, 0, 0.8), 0.8), cylinder(2.0, 2.5, 0.45, 0, 3),
                 ramp(5.5, 7.0, -1.0, 1.0, 1.2))
    lo = v.min(0) - 0.5
    dims = tuple(int(d) for d in np.ceil((v.max(0) + 0.5 - lo) / 0.1).astype(int) + 1)
    grid = tmesh.mesh_to_sdf_grid(v, f, lo, 0.1, dims)
    got = tdec.sdf_grid_to_boxes(grid, lo, 0.1, max_prims=max_prims, min_cover=min_cover,
                                 fit_cylinders=fit_cylinders)
    ref = jdec.sdf_grid_to_boxes(grid, lo, 0.1, max_prims=max_prims, min_cover=min_cover,
                                 fit_cylinders=fit_cylinders)
    assert got == ref
    assert 0 < len(got) <= max_prims
    kinds = {p["type"] for p in got}
    assert ("cylinder" in kinds) == fit_cylinders or max_prims < 8, kinds
    assert tdec.sdf_grid_to_boxes(np.ones((4, 4, 4), np.float32), lo, 0.1) == []


def test_mesh_decomposition_boxes(tmp_path):
    """``test_mesh_native.py::test_mesh_decomposition_boxes`` on the port:
    two cubes → a handful of boxes inside the occupancy, equal to the JAX
    spec, rendering within two cells of the exact mesh and equal to the JAX
    render of the same spec."""
    p = write_obj(tmp_path / "two.obj", *merge(cube((0, 0, 0), 1.0), cube((4, 0, 0), 0.8)))
    spacing = 0.1
    spec = tdec.decompose_mesh_scene(p, spacing=spacing, margin=1.5, max_prims=16,
                                     min_cover=0.97)
    assert_specs_equal(spec, jdec.decompose_mesh_scene(p, spacing=spacing, margin=1.5,
                                                       max_prims=16, min_cover=0.97))
    assert 2 <= len(spec.primitives) <= 6 and spec.name == "two_boxes"
    for prm in spec.primitives:
        c, h = np.asarray(prm["center"]), np.asarray(prm["half_extents"])
        assert (np.all(np.abs(c) + h <= 1.0 + 1.5 * spacing)
                or np.all(np.abs(c - [4, 0, 0]) + h <= 0.8 + 1.5 * spacing)), (c, h)
    pos, q = [[-2.5, 0.0, 0.0]], [[1.0, 0.0, 0.0, 0.0]]
    prim = pack_scenes([spec])
    d_prim = depth_of(prim, pos, q, 32, 64, 10.0)
    d_grid = depth_of(tmesh.bake_mesh_scene(p, spacing=spacing, margin=1.5), pos, q, 32, 64,
                      10.0)
    assert abs(float(d_prim[0, 0, 16, 16]) - 1.5) <= 2 * spacing
    both = (d_grid < 9.9) & (d_prim < 9.9)
    assert both.float().mean() > 0.1
    assert np.percentile((d_grid - d_prim).abs()[both].numpy(), 95) < 2 * spacing
    from visfly_tpu.scene.prim_scene import pack_scenes as jpack

    assert_depth_close(d_prim, jdepth_of(jpack([spec]), pos, q, 32, 64, 10.0))


def test_mesh_decomposition_curved_fidelity(tmp_path):
    """Two round columns and a ramp: the cylinder fit engages, ≤ 2% of the
    exact mesh's pixels see through, the 95th percentile of the depth error
    is within two cells; equal to the JAX spec."""
    p = write_obj(tmp_path / "curved.obj",
                  *merge(cylinder(1.5, -0.8, 0.4, 0.0, 3.0), cylinder(2.5, 0.9, 0.3, 0.0, 3.0),
                         ramp(3.5, 5.0, -1.5, 1.5, 1.5)))
    spacing = 0.08
    kw = dict(spacing=spacing, margin=1.0, max_prims=96, min_cover=0.995)
    spec = tdec.decompose_mesh_scene(p, **kw)
    assert_specs_equal(spec, jdec.decompose_mesh_scene(p, **kw))
    assert "cylinder" in [prm["type"] for prm in spec.primitives]
    pos, q = [[-1.5, 0.0, 1.2]], [[1.0, 0.0, 0.0, 0.0]]
    d_prim = depth_of(pack_scenes([spec]), pos, q, 48, 96, 12.0)[0, 0]
    d_grid = depth_of(tmesh.bake_mesh_scene(p, spacing=spacing, margin=1.0), pos, q, 48, 96,
                      12.0)[0, 0]
    g_hit, p_hit = d_grid < 11.9, d_prim < 11.9
    assert (g_hit & ~p_hit).float().mean() <= 0.02
    both = g_hit & p_hit
    assert both.float().mean() > 0.08
    assert np.percentile((d_grid - d_prim).abs()[both].numpy(), 95) <= 2 * spacing


def test_mesh_file_env_uses_primitive_backend(tmp_path):
    """An env pointed at a mesh file decomposes it by default (the analytic
    trace's scene, equal to the JAX env's, the same depth from the same
    state); ``backend: "grid"`` bakes the exact mesh; swapping a scene of a
    mesh file changes nothing."""
    p = write_obj(tmp_path / "room.obj", *cube((0.0, 0.0, 2.0), 1.0))

    def kw(**scene):
        return dict(num_agent_per_scene=2, num_scene=2, visual=True,
                    scene_kwargs={"path": p, "margin": 3.0, **scene},
                    sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth",
                                    "resolution": [16, 16]}],
                    random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                        {"position": {"mean": [-2.5, 0.0, 2.0], "half": [0.1, 0.1, 0.1]}}]}},
                    dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=16)

    jenv = jenvs.NavigationEnv(**kw())
    tenv = tenvs.NavigationEnv(device="cpu", **kw())
    assert isinstance(tenv.scene, PrimitiveScene)
    for f in ("params", "colors", "semantic", "bbox", "boxes", "capsules"):
        np.testing.assert_array_equal(getattr(tenv.scene, f).numpy(),
                                      np.asarray(getattr(jenv.scene, f)), err_msg=f)
    jst, _ = jenv.reset(jax.random.PRNGKey(0))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    depth = tenv.sensor_observations(tst)["depth"]
    assert torch.isfinite(depth).all() and (depth < 20.0).any()
    assert_depth_close(depth, np.asarray(jenv.sensor_observations(jst)["depth"]))
    before = tenv.scene
    tst2 = tenv.reset_env_by_id(tst, 1)
    assert tenv.scene is before and tst2.step_count.tolist() == [0, 0, 0, 0]
    grid = tenvs.NavigationEnv(device="cpu", **kw(backend="grid"))
    assert isinstance(grid.scene, SceneData) and grid.scene.num_scene == 2
