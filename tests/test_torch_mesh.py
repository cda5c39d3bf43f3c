"""The port's mesh import and mesh-scene queries (``scene/mesh.py``,
``scene/scene.py::SceneData``, the grid and triangle branches of
``scene/queries.py``) against ``visfly_tpu``.

Both packages load the same OBJ or GLB written by the test and bake it with
the same C++ baker (each from its own build of ``native/mesh_sdf.cpp``), so
grids, frames and packed triangles are equal, not close. The queries get the
same numpy points in both packages; SDF samples and distances agree within
1e-5, closest points within 1e-4 (an edge parameter is a ratio of two dot
products over 10 m coordinates, which amplifies their last-place difference).
"""
import json
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.scene import mesh as jmesh
from visfly_tpu.scene import queries as jq
from visfly_tpu_torch import build as tbuild
from visfly_tpu_torch.interop import scene_data_from_numpy
from visfly_tpu_torch.scene import mesh as tmesh
from visfly_tpu_torch.scene import queries as tq
from visfly_tpu_torch.scene.scene import SceneData, _tile_scene_data, scene_data_from_arrays

torch.set_num_threads(1)

TOL = 1e-5
TOL_POINT = 1e-4
_CUBE_FACES = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                          [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                         np.int32)


def box(center, half):
    c, h = np.asarray(center, np.float32), np.asarray(half, np.float32)
    v = np.asarray([[x, y, z] for x in (-h[0], h[0]) for y in (-h[1], h[1])
                    for z in (-h[2], h[2])], np.float32) + c
    return v, _CUBE_FACES.copy()


def room_mesh():
    """A 12×8×3 m room of six slabs with two pillars: 96 triangles."""
    parts = [((4, 0, -0.25), (6, 4, 0.25)), ((4, 0, 3.25), (6, 4, 0.25)),
             ((-2.25, 0, 1.5), (0.25, 4, 1.5)), ((10.25, 0, 1.5), (0.25, 4, 1.5)),
             ((4, -4.25, 1.5), (6, 0.25, 1.5)), ((4, 4.25, 1.5), (6, 0.25, 1.5)),
             ((4, 1, 1.5), (0.3, 0.3, 1.5)), ((6, -1.5, 1.5), (0.3, 0.3, 1.5))]
    verts, faces = [], []
    for c, h in parts:
        v, f = box(c, h)
        faces.append(f + sum(len(x) for x in verts))
        verts.append(v)
    return np.concatenate(verts), np.concatenate(faces)


def write_obj(path, v, f, quads=False):
    with open(path, "w") as fo:
        fo.write("# a comment\nmtllib none.mtl\n")
        for p in v:
            fo.write(f"v {p[0]} {p[1]} {p[2]}\n")
        fo.write("vn 0 0 1\n")
        if quads:  # a fan-triangulated polygon with v/vt/vn tokens
            fo.write("f 1/1/1 2/1/1 4/1/1 3/1/1\n")
        for t in f:
            fo.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return str(path)


def write_glb(path, v, f, material=False):
    """A one-node binary glTF with a translation and a non-uniform scale."""
    vb, ib = v.astype(np.float32).tobytes(), f.astype(np.uint32).tobytes()
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [1.0, -2.0, 0.5], "scale": [1.0, 2.0, 1.0],
                   "rotation": [0.0, 0.0, 0.38268343, 0.92387953]}],
        "meshes": [{"primitives": [dict({"attributes": {"POSITION": 0}, "indices": 1},
                                        **({"material": 0} if material else {}))]}],
        "buffers": [{"byteLength": len(vb) + len(ib)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(vb)},
                        {"buffer": 0, "byteOffset": len(vb), "byteLength": len(ib)}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(v), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": f.size, "type": "SCALAR"}],
    }
    if material:
        gltf["materials"] = [{"pbrMetallicRoughness": {"baseColorFactor": [1, 0, 0, 1]}}]
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    bin_ = vb + ib
    bin_ += b"\0" * (-len(bin_) % 4)
    with open(path, "wb") as fo:
        fo.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bin_)))
        fo.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        fo.write(struct.pack("<II", len(bin_), 0x004E4942) + bin_)
    return str(path)


@pytest.fixture(scope="module")
def baked(tmp_path_factory):
    """The room baked by both packages: (port SceneData, JAX SceneData as
    numpy, the JAX SceneData)."""
    path = write_obj(tmp_path_factory.mktemp("mesh") / "room.obj", *room_mesh())
    jdata = jmesh.bake_mesh_scene(path, spacing=0.1, margin=0.5)
    tdata = tmesh.bake_mesh_scene(path, spacing=0.1, margin=0.5, device="cpu")
    return tdata, jax.tree_util.tree_map(np.asarray, jdata), jdata


def points(n=256, seed=0):
    """Points all over the room's grid frame, some outside the bounds."""
    rng = np.random.default_rng(seed)
    return rng.uniform([-3.0, -5.0, -1.0], [11.0, 5.0, 4.0], (n, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# loaders and the bake
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quads", [False, True])
def test_load_obj_bitwise(tmp_path, quads):
    path = write_obj(tmp_path / "m.obj", *room_mesh(), quads=quads)
    v_t, f_t = tmesh.load_obj(path)
    v_j, f_j = jmesh.load_obj(path)
    assert v_t.dtype == np.float32 and f_t.dtype == np.int32
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)
    assert len(f_t) == 96 + (2 if quads else 0)
    v_m, f_m = tmesh.load_mesh(path)
    np.testing.assert_array_equal(f_m, f_t)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        tmesh.load_mesh(str(tmp_path / "m.stl"))


def test_load_glb_geometry_bitwise(tmp_path):
    v, f = box((0, 0, 0), (1, 0.5, 0.25))
    path = write_glb(tmp_path / "m.glb", v, f)
    v_t, f_t = tmesh.load_glb(path)
    v_j, f_j = jmesh.load_glb(path)
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_array_equal(f_t, f_j)
    assert np.abs(v_t - v).max() > 0.5  # the node transform was applied
    assert tmesh.load_glb_textured(path)[2] is None  # no material, no texture tables
    data = tmesh.bake_mesh_scene(path, spacing=0.2, device="cpu")
    assert data.triangles.shape == (1, 16, 9)  # 12 faces padded to 8s
    with pytest.raises(ValueError, match="not a GLB"):
        tmesh.load_glb(write_obj(tmp_path / "fake.glb", v, f))


def test_bake_equals_jax_bake(baked):
    tdata, jnp_data, _ = baked
    assert isinstance(tdata, SceneData) and tdata.num_scene == 1 and tdata.has_triangles
    for name in ("sdf", "albedo", "semantic", "origin", "spacing", "bbox", "triangles"):
        got, ref = getattr(tdata, name).numpy(), getattr(jnp_data, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert tdata.sdf.shape == (1, 141, 101, 51)
    assert float(tdata.sdf.min()) < -0.1 < 0.5 < float(tdata.sdf.max())
    assert tdata.tri_uv == () and tdata.atlas == ()


def test_sdf_grid_signed_and_unsigned():
    v, f = box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    origin = np.asarray([-2.0, -2.0, -2.0], np.float32)
    for signed in (True, False):
        got = tmesh.mesh_to_sdf_grid(v, f, origin, 0.5, (9, 9, 9), signed=signed)
        ref = jmesh.mesh_to_sdf_grid(v, f, origin, 0.5, (9, 9, 9), signed=signed)
        np.testing.assert_array_equal(got, ref)
        assert got[4, 4, 4] == (-1.0 if signed else 1.0) and got[0, 4, 4] == 1.0
    with pytest.raises(ValueError, match="face indices"):
        tmesh.mesh_to_sdf_grid(v, f + 1, origin, 0.5, (9, 9, 9))
    with pytest.raises(RuntimeError, match="mesh_to_sdf failed"):
        tmesh.mesh_to_sdf_grid(v, f[:0], origin, 0.5, (9, 9, 9))


def test_two_meshes_share_a_frame():
    """Two soups stack on the union of their bounds, the shorter one
    zero-padded, as in the JAX package."""
    m1, m2 = room_mesh(), box((20.0, 0.0, 1.0), (1.0, 1.0, 1.0))
    tdata = tmesh.bake_scenes_from_meshes([m1, m2], spacing=0.25, device="cpu")
    jdata = jmesh.bake_scenes_from_meshes([m1, m2], spacing=0.25)
    for name in ("sdf", "origin", "spacing", "bbox", "triangles"):
        np.testing.assert_array_equal(getattr(tdata, name).numpy(),
                                      np.asarray(getattr(jdata, name)), err_msg=name)
    assert tdata.triangles.shape == (2, 96, 9) and float(tdata.triangles[1, 16:].abs().max()) == 0
    one = tmesh.bake_scene_from_arrays(*m1, spacing=0.25, device="cpu")
    tiled = _tile_scene_data(one, 3)
    assert tiled.sdf.shape[0] == 3 and tiled.triangles.shape == (3, 96, 9)
    assert tiled.spacing.dim() == 0 and torch.equal(tiled.origin, one.origin)
    assert torch.equal(tiled.sdf[2], one.sdf[0]) and torch.equal(tiled.albedo[1], one.albedo[0])


def test_interop_carries_a_jax_scene(baked):
    tdata, jnp_data, _ = baked
    crossed = scene_data_from_numpy(jnp_data)
    for a, b in zip(crossed, tdata):
        assert (a == b) if isinstance(a, tuple) else torch.equal(a, b)
    arrays = {k: getattr(jnp_data, k) for k in ("sdf", "albedo", "semantic", "origin",
                                                "spacing", "bbox")}
    assert not scene_data_from_arrays(arrays).has_triangles
    # texture tables cross over too
    tables = dict(tri_uv=np.ones((1, 96, 6), np.float32), tri_rect=np.ones((1, 96, 4), np.float32),
                  atlas=np.full((1, 2, 3, 3), 7, np.uint8))
    crossed = scene_data_from_numpy(jnp_data._replace(**tables))
    for k, v in tables.items():
        np.testing.assert_array_equal(getattr(crossed, k).numpy(), v)


def test_unported_mesh_features_raise(tmp_path):
    """Materials, instance ids and textures, which named their ROADMAP item
    until they were ported: a GLB's flat material bakes into texture tables
    and per-instance ids label the semantic grid, as in the JAX package."""
    v, f = box((0, 0, 0), (1, 1, 1))
    path = write_glb(tmp_path / "red.glb", v, f, material=True)
    got, ref = tmesh.load_glb_textured(path), jmesh.load_glb_textured(path)
    assert [im.tolist() for im in got[2]["images"]] == [[[[255, 0, 0]]]]
    for a, b in zip(tmesh.build_atlas(got[2]), jmesh.build_atlas(ref[2])):
        np.testing.assert_array_equal(a, b)
    tdata = tmesh.bake_mesh_scene(path, spacing=0.25, device="cpu")
    jdata = jmesh.bake_mesh_scene(path, spacing=0.25)
    two = [(np.concatenate([v, v + 3.0]), np.concatenate([f, f + 8]),
            np.repeat(np.arange(2, dtype=np.int32), 12), None)]
    for t, j in ((tdata, jdata),
                 (tmesh.bake_scenes_from_meshes(two, spacing=0.25, device="cpu"),
                  jmesh.bake_scenes_from_meshes(two, spacing=0.25))):
        for name in ("sdf", "albedo", "semantic", "triangles", "tri_uv", "tri_rect", "atlas"):
            if isinstance(getattr(j, name), tuple):
                assert getattr(t, name) == (), name
            else:
                np.testing.assert_array_equal(getattr(t, name).numpy(),
                                              np.asarray(getattr(j, name)), err_msg=name)
    assert set(torch.unique(tmesh.bake_scenes_from_meshes(
        two, spacing=0.25, device="cpu").semantic).tolist()) == {1, 2}


def test_baker_builds_into_build_dir_and_raises_without_a_compiler(tmp_path, monkeypatch):
    """The baker lands under ``build/native`` and nothing is written under
    ``native/``; a compiler that fails raises, nothing stands in."""
    lib = tbuild.build_native("mesh_sdf")
    assert lib.startswith(tbuild.NATIVE_ROOT) and "/build/native/" in lib
    monkeypatch.setattr(tbuild, "NATIVE_ROOT", str(tmp_path / "native"))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed for mesh_sdf"):
        tbuild.build_native("mesh_sdf")
    assert not (tmp_path / "native").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "native").rglob("*"))


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def test_grid_samples_match_jax(baked):
    tdata, _, jdata = baked
    p = points(512)
    sid = np.zeros(len(p), np.int32)
    tp, tsid = torch.from_numpy(p), torch.zeros(len(p), dtype=torch.long)
    np.testing.assert_allclose(tq.sample_sdf(tdata, tsid, tp).numpy(),
                               np.asarray(jq.sample_sdf(jdata, jnp.asarray(sid), jnp.asarray(p))),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(
        tq.sample_sdf_nearest(tdata, tsid, tp).numpy(),
        np.asarray(jq.sample_sdf_nearest(jdata, jnp.asarray(sid), jnp.asarray(p))))
    got = tq.sdf_normal(tdata, tsid, tp).numpy()
    ref = np.asarray(jq.sdf_normal(jdata, jnp.asarray(sid), jnp.asarray(p)))
    # a central difference of ~0 normalises rounding noise: compare where
    # the field has a slope
    slope = np.abs(ref).max(-1) > 0.5
    assert slope.mean() > 0.9
    np.testing.assert_allclose(got[slope], ref[slope], atol=1e-3, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got[slope], axis=-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(
        tq.sdf_normal(tdata, tsid, tp, eps=0.2).numpy()[slope],
        np.asarray(jq.sdf_normal(jdata, jnp.asarray(sid), jnp.asarray(p), eps=0.2))[slope],
        atol=1e-3, rtol=0)


@pytest.mark.parametrize("chunk", [4096, 40])
def test_tri_closest_point_matches_jax(baked, chunk):
    tdata, _, jdata = baked
    p = points(256, seed=1)
    sid = np.zeros(len(p), np.int32)
    pt_t, d_t = tq.tri_closest_point(tdata.triangles, torch.zeros(len(p), dtype=torch.long),
                                     torch.from_numpy(p), chunk=chunk)
    pt_j, d_j = jq.tri_closest_point(jdata.triangles, jnp.asarray(sid), jnp.asarray(p),
                                     chunk=chunk)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=TOL, rtol=0)
    np.testing.assert_allclose(pt_t.numpy(), np.asarray(pt_j), atol=TOL_POINT, rtol=0)
    # the returned point lies at the returned distance
    np.testing.assert_allclose(np.linalg.norm(pt_t.numpy() - p, axis=-1), d_t.numpy(), atol=TOL)


def test_closest_point_query_is_exact_and_grid_error_bounded(baked):
    """On a mesh scene the distance is exact (against the analytic distance
    to the pillar's faces), where the grid answer is off by up to a cell."""
    tdata, _, jdata = baked
    p = points(256, seed=2)
    tp, tsid = torch.from_numpy(p), torch.zeros(len(p), dtype=torch.long)
    point, dis, out = tq.closest_point_query(tdata, tsid, tp)
    jpoint, jdis, jout = jq.closest_point_query(jdata, jnp.zeros(len(p), jnp.int32),
                                                jnp.asarray(p))
    np.testing.assert_allclose(dis.numpy(), np.asarray(jdis), atol=TOL, rtol=0)
    np.testing.assert_allclose(point.numpy(), np.asarray(jpoint), atol=TOL_POINT, rtol=0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert out.any() and not out.all() and (dis == 0).any()
    # exactness: points beside the first pillar, (4, 1) ± 0.3
    q = np.asarray([[3.0, 1.0, 1.5], [4.0, 2.0, 1.0], [4.9, 1.05, 2.0]], np.float32)
    _, d_q, _ = tq.closest_point_query(tdata, torch.zeros(3, dtype=torch.long),
                                       torch.from_numpy(q))
    np.testing.assert_allclose(d_q.numpy(), [0.7, 0.7, 0.6], atol=1e-6)
    grid_only = tdata._replace(triangles=())
    _, d_g, _ = tq.closest_point_query(grid_only, torch.zeros(3, dtype=torch.long),
                                       torch.from_numpy(q))
    assert np.abs(d_g.numpy() - [0.7, 0.7, 0.6]).max() < 0.1


def test_point_is_collision_on_a_grid_matches_jax(baked):
    tdata, _, jdata = baked
    p = points(512, seed=3)
    for radius in (1.0, 0.3):
        got = tq.point_is_collision(tdata, torch.from_numpy(p), radius=radius)
        ref = jq.point_is_collision(jdata, jnp.asarray(p), radius=radius)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any() and not got.all()


def test_queries_read_each_points_own_scene():
    m1, m2 = room_mesh(), box((4.0, 0.0, 1.5), (2.0, 2.0, 1.0))
    tdata = tmesh.bake_scenes_from_meshes([m1, m2], spacing=0.2, device="cpu")
    p = torch.tensor([[4.0, 0.0, 1.5], [4.0, 0.0, 1.5]])
    sid = torch.tensor([0, 1])
    d = tq.sample_sdf(tdata, sid, p)
    assert float(d[0]) > 0.5 and float(d[1]) < -0.5  # free space / inside the box
    _, dis, _ = tq.closest_point_query(tdata, sid, p)
    assert float(dis[1]) == 0.0 and abs(float(dis[0]) - 0.7) < 0.05
