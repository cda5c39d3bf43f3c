"""Habitat-format composite scenes in the port (``scene/habitat_dataset.py``,
``utils/dataloader.py``, the habitat branches of ``scene/scene.py``) against
``visfly_tpu``: the ten cases of ``tests/test_habitat_dataset.py``, each
through both packages on a dataset this file writes.

Both packages read the same files with the same host numpy code and bake
with the same C++ baker, so indexes, decomposed specs, baked grids,
triangles and texture tables are equal, not close. Renders of one state
(the JAX env's, carried over with ``interop``) agree as the port's other
render tests hold them: depth within 1e-3 m, colour within 1 per channel and
semantic ids equal, each on all but 2 pixels per 1,024 (silhouettes and id
ties, ROADMAP Queue C).
"""
import io
import json
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.scene import habitat_dataset as jhab
from visfly_tpu.scene import mesh as jmesh
from visfly_tpu.utils.dataloader import SimpleDataLoader as JLoader
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.interop import env_state_from_numpy
from visfly_tpu_torch.render import render_camera
from visfly_tpu_torch.scene import habitat_dataset as thab
from visfly_tpu_torch.scene import mesh as tmesh
from visfly_tpu_torch.scene.png import encode_png
from visfly_tpu_torch.scene.scene import SceneData
from visfly_tpu_torch.utils.dataloader import SimpleDataLoader as TLoader

torch.set_num_threads(1)

DEPTH_TOL = 1e-3


def write_cuboid_obj(path, center, half, extra=None, mtl=None):
    """Axis-aligned cuboids as an OBJ (habitat-frame coordinates), with an
    optional material library and material."""
    lines = [f"mtllib {mtl[0]}", f"usemtl {mtl[1]}"] if mtl else []
    faces, base = [], 0
    for c, h in [(center, half)] + (extra or []):
        c, h = np.asarray(c, float), np.asarray(h, float)
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    p = c + h * np.array([sx, sy, sz])
                    lines.append(f"v {p[0]} {p[1]} {p[2]}")
        for a, b, cc, d in [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
                            (0, 2, 6, 4), (1, 5, 7, 3)]:
            faces.append(f"f {base + a + 1} {base + b + 1} {base + cc + 1}")
            faces.append(f"f {base + a + 1} {base + cc + 1} {base + d + 1}")
        base += 8
    path.write_text("\n".join(lines + faces) + "\n")


def write_glb_textured(path, verts, faces, uvs, png):
    """A GLB with TEXCOORD_0 and an embedded PNG baseColorTexture."""
    pos, idx, uv = (verts.astype(np.float32).tobytes(), faces.astype(np.uint32).tobytes(),
                    uvs.astype(np.float32).tobytes())
    views, off = [], 0
    for b in (pos, idx, uv, png):
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
        off += len(b)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 2},
                                    "indices": 1, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}], "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": faces.size, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5126, "count": len(uvs), "type": "VEC2"}],
        "bufferViews": views, "buffers": [{"byteLength": off}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    bin_ = pos + idx + uv + png
    bin_ += b"\0" * (-len(bin_) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bin_)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(bin_), 0x004E4942) + bin_)


def checker_png(cells=8, px=8):
    g = ((np.indices((cells, cells)).sum(0) % 2) * 160 + 60).astype(np.uint8)
    img = np.kron(g, np.ones((px, px), np.uint8))
    return encode_png(np.stack([img] * 3, -1), filters=(0, 1, 2, 3, 4))


def write_config(root, name="test", scenes=True):
    cfg = {"stages": {"paths": {".json": ["configs/stages/*.json"]}},
           "objects": {"paths": {".json": ["configs/objects/*.json"]}}}
    if scenes:
        cfg["scene_instances"] = {"paths": {".json": ["configs/scenes/*.json"]}}
    (root / f"{name}.scene_dataset_config.json").write_text(json.dumps(cfg))


def layout(root):
    for d in ("configs/stages", "configs/objects", "configs/scenes", "meshes"):
        os.makedirs(root / d, exist_ok=True)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The dataset of ``tests/test_habitat_dataset.py``: a garage stage (std
    x∈[0,8], y∈[-3,3], z∈[0,3]), a cube object, two scenes; authored in the
    habitat frame."""
    root = tmp_path_factory.mktemp("habdata")
    layout(root)
    t = 0.2
    write_cuboid_obj(root / "meshes" / "garage.obj", [0.0, -t / 2, -4.0], [3 + t, t / 2, 4 + t],
                     extra=[([-(3 + t / 2), 1.5, -4.0], [t / 2, 1.5, 4 + t]),
                            ([+(3 + t / 2), 1.5, -4.0], [t / 2, 1.5, 4 + t]),
                            ([0.0, 1.5, t / 2], [3 + t, 1.5, t / 2]),
                            ([0.0, 1.5, -(8 + t / 2)], [3 + t, 1.5, t / 2])])
    write_cuboid_obj(root / "meshes" / "cube.obj", [0, 0, 0], [0.3, 0.3, 0.3])
    (root / "configs/stages/garage.stage_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/garage.obj"}))
    (root / "configs/objects/cube.object_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/cube.obj"}))
    s2, c2 = np.sin(np.pi / 8), np.cos(np.pi / 8)
    scenes = {
        "garage_a": [{"template_name": "cube", "translation": [0.0, 1.0, -4.0],
                      "rotation": [1.0, 0.0, 0.0, 0.0]}],
        "garage_b": [{"template_name": "cube", "translation": [1.0, 1.0, -4.0],
                      "rotation": [c2, 0.0, s2, 0.0]},
                     {"template_name": "cube", "translation": [-1.0, 0.5, -6.0],
                      "non_uniform_scale": [1.0, 1.5, 1.0]}],
    }
    for name, objs in scenes.items():
        (root / "configs/scenes" / f"{name}.scene_instance.json").write_text(json.dumps(
            {"stage_instance": {"template_name": "garage"}, "object_instances": objs}))
    write_config(root)
    return root


def scenes_dir(root):
    return str(root / "configs" / "scenes")


def env_kwargs(path, n=1, num_scene=2, half=(0.0, 0.5, 0.5), sensors=None, **scene):
    return dict(num_agent_per_scene=n, num_scene=num_scene, visual=True,
                random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                    {"position": {"mean": [1.0, 0.0, 1.5], "half": list(half)}}]}},
                scene_kwargs={"path": path, **scene},
                sensor_kwargs=sensors or [{"uuid": "depth", "sensor_type": "depth",
                                           "resolution": [16, 16]}],
                target=[7.0, 0.0, 1.0])


def pair(kw):
    """Both envs, the JAX reset state and its port twin."""
    jenv = jenvs.NavigationEnv(**kw)
    tenv = tenvs.NavigationEnv(device="cpu", **kw)
    jst, _ = jenv.reset(jax.random.PRNGKey(0))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    return jenv, jst, tenv, tst


def assert_scene_equal(tscene, jscene):
    for f in type(tscene)._fields:
        got, ref = getattr(tscene, f), getattr(jscene, f)
        if isinstance(got, tuple):
            assert isinstance(ref, tuple) and not ref, f
            continue
        if f == "eps":
            assert float(got) == pytest.approx(float(ref)), f
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f)


def assert_images_close(got, ref, tol=0.0):
    """Equal within ``tol`` on all but 2 pixels per 1,024 of each image."""
    got = got.numpy().astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    assert got.shape == ref.shape
    off = (np.abs(got - ref) > tol).any(axis=1)
    allowed = 2 * -(-off[0].size // 1024)
    assert off.sum(axis=(1, 2)).max() <= allowed, (int(off.sum()), np.argwhere(off)[:6])


def assert_specs_equal(a, b):
    np.testing.assert_array_equal(a.bounds_min, b.bounds_min)
    np.testing.assert_array_equal(a.bounds_max, b.bounds_max)
    assert a.name == b.name and len(a.primitives) == len(b.primitives)
    for pa, pb in zip(a.primitives, b.primitives):
        assert sorted(pa) == sorted(pb)
        for k in pa:
            np.testing.assert_array_equal(np.asarray(pa[k]), np.asarray(pb[k]), err_msg=k)


def test_dataset_index_and_scene_list(dataset):
    cfg = str(dataset / "test.scene_dataset_config.json")
    td, jd = thab.HabitatDataset(cfg), jhab.HabitatDataset(cfg)
    assert td.stages == jd.stages and td.objects == jd.objects and td.scenes == jd.scenes
    assert "garage" in td.stages and "cube" in td.objects and len(td.scenes) == 2
    for p in (scenes_dir(dataset), cfg, td.scenes[0], str(dataset / "meshes"),
              str(dataset / "nothing.scene_instance.json")):
        assert thab.is_habitat_scene_path(p) == jhab.is_habitat_scene_path(p), p
    assert thab.list_habitat_scenes(scenes_dir(dataset)) == jhab.list_habitat_scenes(
        scenes_dir(dataset))
    assert thab.find_dataset_config(td.scenes[0]) == jhab.find_dataset_config(td.scenes[0])
    assert td.resolve_template("cube", "object") == jd.resolve_template("cube", "object")


def test_composite_scene_geometry(dataset):
    """The decomposed scene: equal specs; the cube at std (4, 0, 1), the
    stage's bounds as the flight volume."""
    f = str(dataset / "configs/scenes/garage_a.scene_instance.json")
    spec = thab.load_habitat_scene(f, spacing=0.1)
    assert_specs_equal(spec, jhab.load_habitat_scene(f, spacing=0.1))
    np.testing.assert_allclose(spec.bounds_min, [-0.2, -3.2, -0.2], atol=0.05)
    np.testing.assert_allclose(spec.bounds_max, [8.2, 3.2, 3.0], atol=0.05)
    centers = np.array([p["center"] for p in spec.primitives])
    halves = np.array([p.get("half_extents", [p.get("radius", 0)] * 3)
                       for p in spec.primitives])
    assert np.all(np.abs(centers - [4.0, 0.0, 1.0]) <= halves + 0.15, axis=1).any()
    v_t, f_t, b_t = thab.load_habitat_scene_mesh(f)
    v_j, f_j, b_j = jhab.load_habitat_scene_mesh(f)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)
    np.testing.assert_array_equal(b_t[0], b_j[0])


def test_env_renders_habitat_scene(dataset):
    """The default backend: both envs load the same two scenes from the
    loader, pack them equally and render the same depth."""
    jenv, jst, tenv, tst = pair(env_kwargs(scenes_dir(dataset), n=2, spacing=0.1))
    assert_scene_equal(tenv.scene, jenv.scene)
    assert tenv._pack_floor == jenv._pack_floor
    depth = tenv.sensor_observations(tst)["depth"]
    assert depth.shape == (4, 1, 16, 16) and torch.isfinite(depth).all()
    assert_images_close(depth, jenv.sensor_observations(jst)["depth"], DEPTH_TOL)
    centre = depth[:, 0, 8, 8]
    assert ((centre <= 9.0) & (centre >= 0.3)).all(), centre
    tst, out = tenv.step(tst, torch.zeros(4, 4))
    assert torch.isfinite(out.reward).all()


def test_scene_swap_rotates_habitat_scenes(dataset):
    """``reset_env_by_id`` takes the loader's next file; the swapped scene
    equals the JAX env's and keeps its shapes."""
    jenv, jst, tenv, tst = pair(env_kwargs(scenes_dir(dataset), num_scene=1, spacing=0.1))
    before = tenv.scene.params.clone()
    tst = tenv.reset_env_by_id(tst, 0)
    jenv.reset_env_by_id(jst, 0)
    assert tenv.scene.params.shape == before.shape
    assert not torch.equal(tenv.scene.params, before)
    assert_scene_equal(tenv.scene, jenv.scene)
    assert tst.step_count.tolist() == [0]


def test_habitat_exact_backend_renders_triangles(dataset):
    """``backend: "grid"``: both envs bake the same grids, triangles and
    texture tables (flat instance colours are 1×1 textures) and render the
    same exact depth; a centre ray meets the far wall at exactly 7 m or the
    top of a cube."""
    jenv, jst, tenv, tst = pair(env_kwargs(scenes_dir(dataset), half=(0.0, 0.0, 0.0),
                                           backend="grid", sdf_spacing=0.1))
    assert isinstance(tenv.scene, SceneData) and tenv.scene.num_scene == 2
    assert_scene_equal(tenv.scene, jenv.scene)
    depth = tenv.sensor_observations(tst)["depth"]
    assert_images_close(depth, jenv.sensor_observations(jst)["depth"], DEPTH_TOL)
    centres = depth[:, 0, 8, 8].numpy()
    assert ((np.abs(centres - 7.0) < 0.05) | ((centres > 2.5) & (centres < 3.5))).all()
    assert (np.abs(centres - 7.0) < 0.05).any(), centres


def test_habitat_exact_backend_instance_semantics(dataset):
    """Per-instance semantic ids (stage 1, objects 2..) and the id-keyed
    palette colours render as in the JAX package."""
    sensors = [{"uuid": "semantic", "sensor_type": "semantic", "resolution": [32, 32]},
               {"uuid": "color", "sensor_type": "color", "resolution": [32, 32]}]
    jenv, jst, tenv, tst = pair(env_kwargs(scenes_dir(dataset), half=(0.0, 0.0, 0.0),
                                           sensors=sensors, backend="grid", sdf_spacing=0.1))
    out = tenv.sensor_observations(tst)
    ref = jenv.sensor_observations(jst)
    assert_images_close(out["semantic"], ref["semantic"])
    assert_images_close(out["color"], ref["color"], tol=1.0)
    sem = out["semantic"].numpy()[:, 0]
    for s in range(2):
        ids = set(np.unique(sem[s])) - {0}
        assert 1 in ids and any(i >= 2 for i in ids), ids
    assert any(len(set(np.unique(sem[s])) - {0, 1}) >= 2 for s in range(2))
    rgb = out["color"].numpy()
    for s in range(2):
        c_obj = rgb[s, :, sem[s] >= 2].mean(axis=0)
        c_stage = rgb[s, :, sem[s] == 1].mean(axis=0)
        assert np.abs(c_obj - c_stage).max() > 20.0


def test_habitat_primitive_backend_instance_semantics(dataset):
    f = str(dataset / "configs/scenes/garage_b.scene_instance.json")
    spec = thab.load_habitat_scene(f)
    assert_specs_equal(spec, jhab.load_habitat_scene(f))
    sems = {p["semantic"] for p in spec.primitives}
    assert 1 in sems and {2, 3} <= sems, sems
    c = np.asarray([p for p in spec.primitives if p["semantic"] == 2][0]["center"])
    assert np.linalg.norm(c - np.asarray([4.0, -1.0, 1.0])) < 1.0, c


def test_mesh_base_color_parsers(tmp_path):
    """OBJ-MTL Kd and glTF baseColorFactor, face- and index-count weighted;
    None without a material; equal in both packages."""
    (tmp_path / "red.mtl").write_text("newmtl a\nKd 1.0 0.0 0.0\nnewmtl b\nKd 0.0 0.0 1.0\n")
    (tmp_path / "two.obj").write_text(
        "mtllib red.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl a\nf 1 2 3\nf 1 2 3\nf 1 2 3\n"
        "usemtl b\nf 1 2 3\n")
    gltf = {"asset": {"version": "2.0"},
            "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.0, 1.0, 0.0, 1.0]}}],
            "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                        "material": 0}]}],
            "accessors": [{"count": 3, "componentType": 5126, "type": "VEC3"},
                          {"count": 3, "componentType": 5125, "type": "SCALAR"}]}
    (tmp_path / "green.gltf").write_text(json.dumps(gltf))
    (tmp_path / "plain.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    (tmp_path / "broken.gltf").write_text("{not json")
    expect = {"two.obj": [191, 0, 63], "green.gltf": [0, 255, 0], "plain.obj": None,
              "broken.gltf": None, "missing.glb": None}
    for name, want in expect.items():
        got = tmesh.mesh_base_color(str(tmp_path / name))
        ref = jmesh.mesh_base_color(str(tmp_path / name))
        if want is None:
            assert got is None and ref is None, name
        else:
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.uint8


def material_dataset(root):
    """A floor stage and a red-material cube (``test_habitat_dataset``'s)."""
    layout(root)
    write_cuboid_obj(root / "meshes" / "floor.obj", [0.0, -0.1, -2.0], [2.2, 0.1, 2.2])
    (root / "meshes" / "red.mtl").write_text("newmtl r\nKd 1 0 0\n")
    write_cuboid_obj(root / "meshes" / "cube.obj", [0, 0, 0], [0.3, 0.3, 0.3],
                     mtl=("red.mtl", "r"))
    (root / "configs/stages/floor.stage_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/floor.obj"}))
    (root / "configs/objects/cube.object_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/cube.obj"}))
    path = root / "configs/scenes/s.scene_instance.json"
    path.write_text(json.dumps({"stage_instance": {"template_name": "floor"},
                                "object_instances": [{"template_name": "cube",
                                                      "translation": [0.0, 1.0, -2.0]}]}))
    write_config(root, "t")
    return str(path)


def test_habitat_material_colors_reach_render(tmp_path):
    """A red-material cube: its primitives carry the material colour, and
    the grid bake's albedo keys it by instance, as in the JAX package."""
    f = material_dataset(tmp_path)
    spec = thab.load_habitat_scene(f)
    assert_specs_equal(spec, jhab.load_habitat_scene(f))
    cube = [p for p in spec.primitives if p["semantic"] == 2]
    assert cube and np.asarray(cube[0]["color"]).tolist() == [255, 0, 0]
    got = thab.load_habitat_scene_mesh(f, return_instances=True)
    ref = jhab.load_habitat_scene_mesh(f, return_instances=True)
    for a, b in zip(got[3:], ref[3:]):
        np.testing.assert_array_equal(a, b)
    t_data = tmesh.bake_scenes_from_meshes([(got[0], got[1], got[3], got[4])], spacing=0.1,
                                           device="cpu")
    j_data = jmesh.bake_scenes_from_meshes([(ref[0], ref[1], ref[3], ref[4])], spacing=0.1)
    assert_scene_equal(t_data, j_data)
    assert (t_data.albedo.reshape(-1, 3) == torch.tensor([255, 0, 0],
                                                         dtype=torch.uint8)).all(-1).any()


def test_habitat_textured_glb_object_renders_texture(tmp_path):
    """A textured GLB object beside an untextured stage: merged texture
    tables equal to the JAX ones, the bake equal, and the exact-triangle
    colour render equal to the JAX render, with both checker colours."""
    root = tmp_path
    layout(root)
    t = 0.2
    write_cuboid_obj(root / "meshes" / "room.obj", [0.0, -t / 2, -4.0], [3 + t, t / 2, 4 + t],
                     extra=[([0.0, 1.5, -(8 + t / 2)], [3 + t, 1.5, t / 2])])
    verts = np.asarray([[-2, 0, 0], [2, 0, 0], [2, 3, 0], [-2, 3, 0]], np.float32)
    write_glb_textured(root / "meshes" / "wall.glb", verts,
                       np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32),
                       np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32), checker_png())
    (root / "configs/stages/room.stage_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/room.obj"}))
    (root / "configs/objects/wall.object_config.json").write_text(
        json.dumps({"render_asset": "../../meshes/wall.glb"}))
    f = root / "configs/scenes/s1.scene_instance.json"
    f.write_text(json.dumps({"stage_instance": {"template_name": "room"},
                             "object_instances": [{"template_name": "wall",
                                                   "translation": [0.0, 0.0, -4.0]}]}))
    write_config(root, "demo", scenes=False)
    got = thab.load_habitat_scene_mesh(str(f), return_instances=True, return_textures=True)
    ref = jhab.load_habitat_scene_mesh(str(f), return_instances=True, return_textures=True)
    for a, b in zip(got[:2] + got[3:5], ref[:2] + ref[3:5]):
        np.testing.assert_array_equal(a, b)
    tex, jtex = got[-1], ref[-1]
    np.testing.assert_array_equal(tex["uv"], jtex["uv"])
    np.testing.assert_array_equal(tex["tex"], jtex["tex"])
    assert len(tex["images"]) == len(jtex["images"]) >= 2
    for a, b in zip(tex["images"], jtex["images"]):
        np.testing.assert_array_equal(a, b)
    v, fc, _b, inst, cols, tx = got
    data = tmesh.bake_scenes_from_meshes([(v, fc, inst, cols, tx)], spacing=0.15, device="cpu")
    jdata = jmesh.bake_scenes_from_meshes([ref[:2] + ref[3:]], spacing=0.15)
    assert_scene_equal(data, jdata)
    cam = {"uuid": "color", "sensor_type": "color", "resolution": [32, 32]}
    pos, q = torch.tensor([[1.0, 0.0, 1.5]]), torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    rgb = render_camera(data, pos, q, cam, max_depth=12.0)["color"]
    from visfly_tpu.render import render_camera as jrender_camera

    jrgb = jrender_camera(jdata, jnp.zeros(1, jnp.int32), jnp.asarray(pos.numpy()),
                          jnp.asarray(q.numpy()), cam, max_depth=12.0)["color"]
    assert_images_close(rgb, jrgb, tol=1.0)
    g = rgb.numpy()[0, 0].astype(np.int32)
    vals = g[g > 0]
    assert vals.size > 200 and vals.max() > 2.2 * max(np.percentile(vals, 10), 1)


def test_rotation_order(dataset):
    """The scenes an env loads and rotates through are the files a
    ``SimpleDataLoader`` of the env's seed gives, in both packages:
    ``reset_scenes`` takes the next two."""
    files = thab.list_habitat_scenes(scenes_dir(dataset))
    tl, jl = TLoader(files, seed=42), JLoader(files, seed=42)
    order = tl.next(7)
    assert order == jl.next(7)
    kw = env_kwargs(scenes_dir(dataset), spacing=0.1)
    jenv = jenvs.NavigationEnv(**kw)
    tenv = tenvs.NavigationEnv(device="cpu", **kw)
    specs = {f: thab.load_habitat_scene(f, spacing=0.1).primitives for f in files}
    seen = [[len(p) for p in (s.primitives for s in tenv._scene_specs)]]
    for _ in range(2):
        tenv.reset_scenes()
        jenv.reset_scenes()
        assert_scene_equal(tenv.scene, jenv.scene)
        seen.append([len(s.primitives) for s in tenv._scene_specs])
    assert seen == [[len(specs[f]) for f in order[i:i + 2]] for i in (0, 2, 4)]
