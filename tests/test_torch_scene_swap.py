"""Scene swaps, scene files and the flat-ray trace in the port against
``visfly_tpu``: ``reset_env_by_id`` (``scene/scene.py::swap_scene_for_env``)
on presets, directories of scene JSONs and habitat datasets at both
backends, with the swarm env's replan; ``save_scene_spec`` /
``load_scene_spec`` and ``bake_scenes``; ``trace_rays``, the grid backend
render, ``approaching_point`` and the global view's approaching overlay.

Scenes are host numpy in both packages and equal, not close. Respawns draw
from each package's own random stream, so only their extent is compared.
Traces: t within 1e-3 m and hit flags equal on all but 2 rays (pixels) per
1,024 (grazing rays and silhouettes, ROADMAP Queue C); colour within 1 per
channel, semantic ids equal, on the same share.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.render import sphere_trace as jsp
from visfly_tpu.render.global_view import render_global as jrender_global
from visfly_tpu.scene import mesh as jmesh
from visfly_tpu.scene import scene as jscene
from visfly_tpu.utils import path_finder as jpf
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.interop import env_state_from_numpy, scene_data_from_numpy
from visfly_tpu_torch.render import global_view as gv
from visfly_tpu_torch.render import sphere_trace as tsp
from visfly_tpu_torch.scene import mesh as tmesh
from visfly_tpu_torch.scene import scene as tscene
from visfly_tpu_torch.scene.prim_scene import PrimitiveScene
from visfly_tpu_torch.scene.scene import SceneData
from visfly_tpu_torch.utils import path_finder as tpf

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_habitat import layout, write_config, write_cuboid_obj  # noqa: E402

torch.set_num_threads(1)

T_TOL = 1e-3


def nav_kwargs(path="garage_crossing", num_scene=2, n=2, sensors=None, **scene):
    return dict(num_agent_per_scene=n, num_scene=num_scene, visual=True,
                scene_kwargs={"path": path, **scene},
                sensor_kwargs=sensors or [{"sensor_type": "depth", "uuid": "depth",
                                           "resolution": [16, 16]}],
                random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                    {"position": {"mean": [0.0, 0.0, 2.0], "half": [1.0, 1.0, 0.5]}}]}},
                dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})


def swap_pair(**kw):
    """Both envs and the port's state after a reset and one step (every
    step count 1). The JAX env swaps through ``swap_scene_for_env``, the
    asset half of its ``reset_env_by_id``."""
    jenv = jenvs.NavigationEnv(**kw)
    tenv = tenvs.NavigationEnv(device="cpu", **kw)
    tst, _ = tenv.reset(torch.Generator().manual_seed(0))
    return jenv, tenv, tenv.step(tst, torch.full((tenv.num_envs, 4), 0.2))[0]


@pytest.fixture(scope="module")
def garage():
    """Both garage envs with moving agents, the JAX reset state and its port
    twin (one scene: the JAX global view renders a multi-scene env only on
    its card)."""
    kw = nav_kwargs("garage_simple_l_medium", num_scene=1, n=4)
    kw["random_kwargs"]["state_generator"]["kwargs"][0].update(
        position={"mean": [2.0, 0.0, 1.5], "half": [1.0, 2.0, 0.5]},
        velocity={"mean": [1.0, 0.0, 0.0], "half": [1.0, 1.0, 0.3]})
    jenv = jenvs.NavigationEnv(**kw)
    tenv = tenvs.NavigationEnv(device="cpu", **kw)
    jst, _ = jenv.reset(jax.random.PRNGKey(0))
    return jenv, jst, tenv, env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))


def assert_scene_equal(tscene_, jscene_):
    for f in type(tscene_)._fields:
        got, ref = getattr(tscene_, f), getattr(jscene_, f)
        if isinstance(got, tuple):
            assert isinstance(ref, tuple) and not ref, f
        elif f == "eps":
            assert float(got) == pytest.approx(float(ref))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f)


def assert_close(got, ref, tol):
    """Within ``tol`` on all but 2 of each 1,024 pixels of every image."""
    got, ref = got.numpy().astype(np.float64), np.asarray(ref).astype(np.float64)
    assert got.shape == ref.shape
    off = np.abs(got - ref) > tol
    off = off.reshape(off.shape[0], -1, *off.shape[-2:]).any(axis=1)
    assert off.sum(axis=(1, 2)).max() <= 2 * -(-off[0].size // 1024), int(off.sum())


def assert_swapped(tenv, before, st_before, st_after, scene_id):
    """Scene ``scene_id``'s rows changed and only its agents respawned."""
    A = tenv.num_agent_per_scene
    mine = slice(scene_id * A, (scene_id + 1) * A)
    others = torch.ones(tenv.num_agent, dtype=torch.bool)
    others[mine] = False
    assert (st_after.step_count[mine] == 0).all()
    assert torch.equal(st_after.step_count[others], st_before.step_count[others])
    assert torch.equal(st_after.dyn.pos[others], st_before.dyn.pos[others])
    return before, others


@pytest.mark.parametrize("backend", ["primitive", "grid"])
def test_reset_env_by_id_swaps_single_scene(backend):
    """``tests/test_scene_rotation.py::test_reset_env_by_id_swaps_single_scene``
    on a preset: scene 0 takes the JAX package's next seed (equal scenes);
    scene 1's rows, agents and images at fixed poses stay as they were."""
    jenv, tenv, tst = swap_pair(**nav_kwargs(backend=backend, sdf_spacing=0.2))
    depth_before = tenv.sensor_observations(tst)["depth"]
    before = tenv.scene
    tst2 = tenv.reset_env_by_id(tst, 0)
    jscene.swap_scene_for_env(jenv, 0)
    assert_scene_equal(tenv.scene, jenv.scene)
    assert_swapped(tenv, before, tst, tst2, 0)
    for f in (("params", "boxes", "capsules") if backend == "primitive" else ("sdf",)):
        a, b = getattr(before, f), getattr(tenv.scene, f)
        assert a.shape == b.shape and torch.equal(a[1], b[1])
    f = "params" if backend == "primitive" else "sdf"
    assert not torch.equal(getattr(before, f)[0], getattr(tenv.scene, f)[0])
    depth_fixed = tenv.sensor_observations(tst)["depth"]
    assert (depth_fixed[:2] - depth_before[:2]).abs().max() > 0.05
    assert torch.equal(depth_fixed[2:], depth_before[2:])
    tst2, out = tenv.step(tst2, torch.zeros(4, 4))
    assert torch.isfinite(out.obs["depth"]).all()


def test_scene_dataset_roundtrip_and_directory_swaps(tmp_path):
    """``test_scene_rotation.py::test_scene_dataset_roundtrip``: the written
    files equal the JAX package's and read back as the preset; a directory
    of them drives the env's scenes and swaps as in the JAX env."""
    paths = tscene.generate_scene_dataset(str(tmp_path / "t"), "garage_crossing", 3, seed=7)
    jpaths = jscene.generate_scene_dataset(str(tmp_path / "j"), "garage_crossing", 3, seed=7)
    assert [os.path.basename(p) for p in paths] == [os.path.basename(p) for p in jpaths]
    for p, q in zip(paths, jpaths):
        assert json.load(open(p)) == json.load(open(q))
    spec = tscene.load_scene_spec(paths[0])
    orig = tscene.make_scene("garage_crossing", seed=7)
    assert len(spec.primitives) == len(orig.primitives)
    np.testing.assert_allclose(spec.bounds_min, orig.bounds_min)
    ref = jscene.load_scene_spec(paths[0])
    for a, b in zip(spec.primitives, ref.primitives):
        assert sorted(a) == sorted(b)
        for k in a:
            assert type(a[k]) is type(b[k]) and np.array_equal(a[k], b[k]), k
    jenv, tenv, tst = swap_pair(**nav_kwargs(str(tmp_path / "t")))
    assert_scene_equal(tenv.scene, jenv.scene)
    tst2 = tenv.reset_env_by_id(tst, 1)
    jscene.swap_scene_for_env(jenv, 1)
    assert_scene_equal(tenv.scene, jenv.scene)
    assert_swapped(tenv, None, tst, tst2, 1)


def hab_dataset(root):
    """Three habitat scenes in one garage stage; the third places a cube
    far outside the first two's grid frame."""
    layout(root)
    t = 0.2
    write_cuboid_obj(root / "meshes" / "garage.obj", [0.0, -t / 2, -4.0], [3 + t, t / 2, 4 + t],
                     extra=[([0.0, 1.5, -(8 + t / 2)], [3 + t, 1.5, t / 2])])
    write_cuboid_obj(root / "meshes" / "cube.obj", [0, 0, 0], [0.3, 0.3, 0.3])
    (root / "configs/stages/garage.stage_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/garage.obj"}))
    (root / "configs/objects/cube.object_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/cube.obj"}))
    for name, trans in (("a", [0.0, 1.0, -4.0]), ("b", [1.0, 0.5, -6.0]),
                        ("c", [0.0, 1.0, -14.0])):
        (root / "configs/scenes" / f"{name}.scene_instance.json").write_text(json.dumps({
            "stage_instance": {"template_name": "garage"},
            "object_instances": [{"template_name": "cube", "translation": trans},
                                 {"template_name": "cube", "translation": [1.5, 0.3, -2.0],
                                  "uniform_scale": 0.5}]}))
    write_config(root)
    return str(root / "configs" / "scenes")


def test_habitat_swaps_at_both_backends(tmp_path):
    """The default backend swaps as the JAX env does. On the grid backend
    (where the JAX package has no swap) a scene that fits the grid frame is
    baked into it alone: the other scene's grids, triangles and texture
    tables stay bit for bit, and the new scene's equal a bake of its mesh in
    that frame; one that does not fit re-bakes every scene as a fresh load
    would."""
    path = hab_dataset(tmp_path)
    kw = nav_kwargs(path, n=1, spacing=0.15)
    kw["random_kwargs"]["state_generator"]["kwargs"][0]["position"] = {
        "mean": [1.0, 0.0, 1.5], "half": [0.0, 0.5, 0.3]}
    jenv, tenv, tst = swap_pair(**kw)
    for sid in (0, 1):
        tst = tenv.reset_env_by_id(tst, sid)
        jscene.swap_scene_for_env(jenv, sid)
        assert_scene_equal(tenv.scene, jenv.scene)
    genv = tenvs.NavigationEnv(device="cpu", **dict(kw, scene_kwargs=dict(
        kw["scene_kwargs"], backend="grid", sdf_spacing=0.15)))
    gst, _ = genv.reset(torch.Generator().manual_seed(0))
    order = list(genv._scene_loader._order)
    files = sorted(os.listdir(path))
    far = files.index("c.scene_instance.json")
    for step in range(3):
        before = genv.scene
        sid = step % 2
        nxt = genv._scene_loader._order[genv._scene_loader._pos] if (
            genv._scene_loader._pos < len(order)) else None
        gst2 = genv.reset_env_by_id(gst, sid)
        assert_swapped(genv, before, gst, gst2, sid)
        gst = gst2
        after = genv.scene
        refit = torch.equal(after.origin, before.origin) and after.sdf.shape == before.sdf.shape
        if nxt is not None and nxt != far:
            assert refit
        if refit:
            other = 1 - sid
            T = before.triangles.shape[1]
            for f in ("sdf", "albedo", "semantic"):
                assert torch.equal(getattr(after, f)[other], getattr(before, f)[other]), f
            assert torch.equal(after.triangles[other, :T], before.triangles[other])
            assert torch.equal(after.atlas[other, :before.atlas.shape[1], :before.atlas.shape[2]],
                               before.atlas[other])
            ref = jmesh.bake_scenes_from_meshes([genv._scene_meshes[sid]], spacing=0.15)
            v = genv._scene_meshes[sid][0]
            lo = after.origin.numpy()
            ref_sdf = jmesh.mesh_to_sdf_grid(v, genv._scene_meshes[sid][1], lo,
                                             float(after.spacing), tuple(after.sdf.shape[1:]))
            np.testing.assert_array_equal(after.sdf[sid].numpy(), ref_sdf)
            n_t = ref.triangles.shape[1]
            np.testing.assert_array_equal(after.triangles[sid, :n_t].numpy(),
                                          np.asarray(ref.triangles[0]))
            np.testing.assert_array_equal(after.tri_uv[sid, :n_t].numpy(),
                                          np.asarray(ref.tri_uv[0]))
        else:
            fresh = jmesh.bake_scenes_from_meshes(genv._scene_meshes, spacing=0.15)
            assert_scene_equal(after, fresh)
        assert isinstance(after, SceneData) and after.num_scene == 2
    depth = genv.sensor_observations(gst)["depth"]
    assert torch.isfinite(depth).all()


def test_swarm_env_replans_the_swapped_scene():
    """``MultiNavigationEnv.reset_env_by_id`` replans the swapped scene's
    agents from their new positions (the paths the JAX planner finds from
    them) and keeps the other scene's paths."""
    kw = dict(num_agent_per_scene=2, num_scene=2, visual=True,
              sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [16, 16]}],
              scene_kwargs={"path": "garage_simple_l_medium", "is_find_path": True},
              random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                  {"position": {"mean": [2.0, 0.0, 1.5], "half": [0.5, 1.0, 0.3]}}]}})
    tenv = tenvs.MultiNavigationEnv(device="cpu", **kw)
    st, _ = tenv.reset(torch.Generator().manual_seed(1))
    old = list(tenv.path)
    st2 = tenv.reset_env_by_id(st, 1)
    assert tenv.path[:2] == old[:2]
    jenv = jenvs.MultiNavigationEnv(**kw)
    jscene.swap_scene_for_env(jenv, 1)
    ref = jpf.find_paths(jenv, st2.dyn.pos.numpy(), tenv.target.numpy(), indices=[2, 3])
    for i, p in zip((2, 3), ref):
        assert p is not None and tenv.path[i] is not None
        np.testing.assert_array_equal(tenv.path[i], p)
        np.testing.assert_allclose(tenv.path[i][0], st2.dyn.pos[i].numpy(), atol=1e-5)
        np.testing.assert_array_equal(
            tenv.path[i], tpf.find_paths(tenv, st2.dyn.pos, tenv.target, indices=[i])[0])


def test_bake_scenes_equals_jax():
    specs = [jscene.make_scene("garage_crossing", seed=s) for s in (3, 4)]
    tspecs = [tscene.make_scene("garage_crossing", seed=s) for s in (3, 4)]
    for with_color in (True, False):
        got = tscene.bake_scenes(tspecs, spacing=0.2, with_color=with_color)
        ref = jscene.bake_scenes(specs, spacing=0.2, with_color=with_color)
        assert_scene_equal(got, ref)
        assert not got.has_triangles
    got = tscene.bake_scenes(tspecs[:1], spacing=0.05, max_cells=64)
    assert_scene_equal(got, jscene.bake_scenes(specs[:1], spacing=0.05, max_cells=64))


def random_rays(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


def test_trace_rays_equals_jax():
    """The flat-batch sphere trace over a primitive scene and over a grid
    scene: t and hit as the JAX trace gives them."""
    tspecs = [tscene.make_scene("garage_simple_l_medium", seed=s) for s in (1, 2)]
    jspecs = [jscene.make_scene("garage_simple_l_medium", seed=s) for s in (1, 2)]
    from visfly_tpu.scene.prim_scene import pack_scenes as jpack
    from visfly_tpu_torch.scene.prim_scene import pack_scenes as tpack

    o, d = random_rays(2048, [-1.5, -5.5, 0.3], [17.5, 5.5, 4.5], 0)
    sid = np.repeat(np.arange(2), 1024)
    for tdata, jdata, steps in ((tpack(tspecs), jpack(jspecs), 48),
                                (tscene.bake_scenes(tspecs, spacing=0.2),
                                 jscene.bake_scenes(jspecs, spacing=0.2), 40)):
        t, hit = tsp.trace_rays(tdata, torch.from_numpy(sid), torch.from_numpy(o),
                                torch.from_numpy(d), n_steps=steps, max_depth=30.0)
        jt, jhit = jsp.trace_rays(jdata, jnp.asarray(sid), jnp.asarray(o), jnp.asarray(d),
                                  n_steps=steps, max_depth=30.0)
        off = (np.abs(t.numpy() - np.asarray(jt)) > T_TOL) | (hit.numpy() != np.asarray(jhit))
        assert off.sum() <= 4, int(off.sum())
        assert 0.5 < float(hit.float().mean()) <= 1.0
        assert float(t.max()) <= 30.0


def objects_for(n_scene, pos):
    """One sphere object a scene, in front of its first agent."""
    c = pos.reshape(n_scene, -1, 3)[:, :1] + np.asarray([1.2, 0.0, 0.0], np.float32)
    r = np.full((n_scene, 1), 0.3, np.float32)
    col = np.full((n_scene, 1, 3), [200.0, 40.0, 40.0], np.float32)
    return ((torch.from_numpy(c), torch.from_numpy(r), torch.from_numpy(col)),
            (jnp.asarray(c), jnp.asarray(r), jnp.asarray(col)))


@pytest.mark.parametrize("scene_kind", ["grid_only", "mesh_grid_opt_out"])
def test_grid_backend_render_equals_jax(scene_kind, tmp_path):
    """Depth, colour and semantic sphere-traced through the trilinear grid
    (a preset baked by ``bake_scenes``, and a mesh scene with
    ``render_backend: "grid"``), with and without an object composed after
    it: as the JAX render."""
    if scene_kind == "grid_only":
        specs = [jscene.make_scene("garage_simple_l_medium", seed=s) for s in (1, 2)]
        jdata = jscene.bake_scenes(specs, spacing=0.15)
        tdata = scene_data_from_numpy(jax.tree_util.tree_map(np.asarray, jdata))
    else:
        write_cuboid_obj(tmp_path / "box.obj", [8.0, 0.0, 1.0], [1.0, 4.0, 1.0],
                         extra=[([4.0, 2.5, 1.5], [0.4, 0.4, 1.5])])
        tdata = tscene._tile_scene_data(tmesh.bake_mesh_scene(str(tmp_path / "box.obj"),
                                                              spacing=0.1, margin=1.0), 2)
        jdata = jscene._tile_scene_data(jmesh.bake_mesh_scene(str(tmp_path / "box.obj"),
                                                              spacing=0.1, margin=1.0), 2)
    n = 4
    rng = np.random.default_rng(1)
    pos = (np.asarray([[1.0, 0.0, 1.5]]) + rng.uniform(-0.3, 0.3, (n, 3))).astype(np.float32)
    q = np.tile(np.asarray([[1.0, 0.0, 0.0, 0.0]], np.float32), (n, 1))
    sid = jnp.asarray(np.repeat(np.arange(2), n // 2), jnp.int32)
    t_obj, j_obj = objects_for(2, pos)
    for stype, tol in (("depth", T_TOL), ("color", 1.0), ("semantic", 0.0)):
        spec = {"sensor_type": stype, "resolution": [16, 24], "render_backend": "grid"}
        for objs, jobjs in ((None, None), (t_obj, j_obj)):
            out = tsp.render_camera(tdata, torch.from_numpy(pos), torch.from_numpy(q), spec,
                                    n_steps=40, objects=objs, num_scene=2)[stype]
            ref = jsp.render_camera(jdata, sid, jnp.asarray(pos), jnp.asarray(q), spec,
                                    n_steps=40, objects=jobjs, num_scene=2)[stype]
            assert_close(out, ref, tol)
            if stype == "depth":
                assert (out < 20.0).float().mean() > 0.25
            if objs is not None and stype == "semantic":
                assert (out == 255).any()


def test_approaching_point(garage):
    """``test_aux_subsystems.py::test_approaching_point``: flying +x in the
    ±30 m box meets the wall at x = 30; in the garage, with the JAX state's
    velocities, the points are the JAX ones."""
    kw = nav_kwargs("box15_wall_empty", num_scene=1)
    kw["random_kwargs"]["state_generator"]["kwargs"][0] = {
        "position": {"mean": [0.0, 0.0, 2.0], "half": [0.0, 0.0, 0.0]},
        "velocity": {"mean": [1.0, 0.0, 0.0], "half": [0.0, 0.0, 0.0]}}
    env = tenvs.NavigationEnv(device="cpu", **kw)
    st, _ = env.reset(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(env.approaching_point(st)[:, 0].numpy(), 30.0, atol=0.3)
    jenv, jst, tenv, tst = garage
    got = tenv.approaching_point(tst).numpy()
    ref = np.asarray(jenv.approaching_point(jst))
    assert np.abs(got - ref).max() <= T_TOL * 10, np.abs(got - ref).max()
    assert (np.linalg.norm(got - tst.dyn.pos.numpy(), axis=1) < 100.0).all()
    hover = tenvs.HoverEnv(device="cpu", num_agent_per_scene=2)
    hst, _ = hover.reset(torch.Generator().manual_seed(0))
    assert hover.approaching_point(hst, max_distance=5.0).shape == (2, 3)


def test_global_view_approaching_overlay(garage):
    """``render_global(approaching=True)`` draws the JAX overlay: the frame
    equals the JAX frame, and the lines change pixels."""
    jenv, jst, tenv, tst = garage
    res = [96, 128]
    out = gv.render_global(tenv, tst, view="near", resolution=res, approaching=True)
    ref = jrender_global(jenv, jst, view="near", resolution=res, approaching=True)
    off = np.abs(out.astype(int) - ref.astype(int)).max(axis=-1) > 1
    assert off.sum() <= 2 * -(-out.shape[0] * out.shape[1] // 1024), int(off.sum())
    base = gv.render_global(tenv, tst, view="near", resolution=res)
    assert (base != out).any()
    assert isinstance(tenv.scene, PrimitiveScene)
