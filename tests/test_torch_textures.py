"""Textures and shadow rays in the port (``scene/png.py``,
``scene/mesh.py::load_glb_textured``/``build_atlas``, the textured and
shadowed branches of ``render/sphere_trace.py``) against ``visfly_tpu``.

The loaders and the atlas are host numpy in both packages: their arrays are
equal. The port decodes PNG itself where the JAX package asks PIL; on every
colour type and filter the two decodes are equal. Renders of the same scene
and cameras agree within 1 per channel on all but 2 pixels per 1,024
(silhouettes and ties, ROADMAP Queue C). ``shadow_visibility`` is an
any-hit test: equal to the JAX function everywhere on these inputs, and
chunked equal to unchunked bit for bit.
"""
import io
import json
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from visfly_tpu.render import sphere_trace as jst
from visfly_tpu.scene import mesh as jmesh
from visfly_tpu.scene.scene import _tile_scene_data as jtile
from visfly_tpu_torch.render import sphere_trace as tst
from visfly_tpu_torch.scene import mesh as tmesh
from visfly_tpu_torch.scene.png import decode_png, encode_png
from visfly_tpu_torch.scene.scene import _tile_scene_data

torch.set_num_threads(1)

WALL = np.asarray([[2, -2, -2], [2, 2, -2], [2, 2, 2], [2, -2, 2]], np.float32)
QUAD = np.asarray([[0, 1, 2], [0, 2, 3]], np.uint32)
QUAD_UV = np.asarray([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)


def checker(cells=8, px=8, lo=60, hi=220):
    g = ((np.indices((cells, cells)).sum(0) % 2) * (hi - lo) + lo).astype(np.uint8)
    return np.stack([np.kron(g, np.ones((px, px), np.uint8))] * 3, -1)


def write_glb(path, prims, images, materials):
    """A GLB of several primitives. ``prims``: (verts, faces, uvs or None,
    material or None, uv componentType); ``images``: PNG bytes, embedded,
    or a file name, referenced by uri; ``materials``: glTF material dicts."""
    blobs, views, accessors = [], [], []

    def view(b):
        off = sum(len(x) for x in blobs)
        blobs.append(b + b"\0" * (-len(b) % 4))
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
        return len(views) - 1

    def accessor(arr, ctype, kind, **extra):
        accessors.append(dict({"bufferView": view(arr.tobytes()), "componentType": ctype,
                               "count": len(arr) if kind != "SCALAR" else arr.size,
                               "type": kind}, **extra))
        return len(accessors) - 1

    meshes = []
    for verts, faces, uvs, mat, uv_type in prims:
        attrs = {"POSITION": accessor(verts.astype(np.float32), 5126, "VEC3")}
        if uvs is not None:
            if uv_type == 5121:
                attrs["TEXCOORD_0"] = accessor(np.round(uvs * 255).astype(np.uint8), 5121,
                                               "VEC2", normalized=True)
            else:
                attrs["TEXCOORD_0"] = accessor(uvs.astype(np.float32), 5126, "VEC2")
        prim = {"attributes": attrs, "indices": accessor(faces.astype(np.uint32), 5125,
                                                         "SCALAR")}
        if mat is not None:
            prim["material"] = mat
        meshes.append({"primitives": [prim]})
    imgs = [{"bufferView": view(im), "mimeType": "image/png"} if isinstance(im, bytes)
            else {"uri": im} for im in images]
    gltf = {"asset": {"version": "2.0"}, "scene": 0,
            "scenes": [{"nodes": list(range(len(meshes)))}],
            "nodes": [{"mesh": i, "translation": [0.0, 0.0, 0.1 * i]} for i in range(len(meshes))],
            "meshes": meshes, "materials": materials,
            "textures": [{"source": i} for i in range(len(images))], "images": imgs,
            "accessors": accessors, "bufferViews": views}
    bin_ = b"".join(blobs)
    gltf["buffers"] = [{"byteLength": len(bin_)}]
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bin_)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(bin_), 0x004E4942) + bin_)
    return str(path)


def checker_glb(path):
    return write_glb(path, [(WALL, QUAD, QUAD_UV, 0, 5126)], [encode_png(checker(), (4, 1))],
                     [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}])


def assert_images_close(got, ref, tol=1.0):
    got, ref = got.numpy().astype(int), np.asarray(ref).astype(int)
    assert got.shape == ref.shape
    off = (np.abs(got - ref) > tol).any(axis=1)
    assert off.sum(axis=(1, 2)).max() <= 2 * -(-off[0].size // 1024), int(off.sum())


def render_both(data, jdata, pos, cam, max_depth=10.0, lighting=None):
    n = len(pos)
    q = np.tile(np.asarray([[1.0, 0.0, 0.0, 0.0]], np.float32), (n, 1))
    pos = np.asarray(pos, np.float32)
    t_light = None if lighting is None else tst.bake_lighting(lighting)
    j_light = None if lighting is None else jst.bake_lighting(lighting)
    out = tst.render_camera(data, torch.from_numpy(pos), torch.from_numpy(q), cam,
                            max_depth=max_depth, lighting=t_light)
    ref = jst.render_camera(jdata, jnp.arange(n, dtype=jnp.int32) // (n // data.num_scene),
                            jnp.asarray(pos), jnp.asarray(q), cam, max_depth=max_depth,
                            lighting=j_light)
    return out, ref


@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4),
                                           ("P", 1)])
def test_png_decoder_equals_pil(mode, channels):
    """Random images of each colour type, every row filter and mixes of
    them, from the port's encoder and from PIL's: equal to PIL's decode."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (29, 37, channels), dtype=np.uint8)
    palette = rng.integers(0, 256, (20, 3), dtype=np.uint8) if mode == "P" else None
    if mode == "P":
        img = img % 20
    for filters in ((0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 3, 1)):
        raw = encode_png(img[..., 0] if channels == 1 else img, filters, palette=palette)
        ref = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(raw), ref, err_msg=str(filters))
    im = Image.fromarray(img[..., 0] if channels == 1 else img, mode)
    if mode == "P":
        im.putpalette(palette.reshape(-1).tolist())
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()),
                                  np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))


def test_png_decoder_refuses_what_it_does_not_take():
    """16-bit and interlaced PNGs are left to PIL (None); broken bytes
    raise."""
    import zlib

    buf = io.BytesIO()
    Image.fromarray(np.arange(16, dtype=np.uint16).reshape(4, 4) * 4000).save(buf, format="PNG")
    assert decode_png(buf.getvalue()) is None
    assert tmesh.decode_image(buf.getvalue()).shape == (4, 4, 3)  # through PIL
    raw = encode_png(checker(2, 4))
    ihdr = raw[12:29][:-1] + b"\x01"  # the same header, interlaced
    laced = raw[:8] + raw[8:12] + ihdr + struct.pack(">I", zlib.crc32(ihdr)) + raw[33:]
    assert decode_png(laced) is None
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + raw[6:])
    with pytest.raises(ValueError):
        decode_png(raw[:40] + raw[60:])


def test_load_glb_textured_and_atlas_equal_jax(tmp_path):
    """Five primitives: an embedded checker, a flat colour, no material, an
    external palette PNG with normalized uint8 texcoords, and a texture too
    large for ``max_tex`` (halved): equal texinfo, atlas and per-packed-face
    tables in both packages."""
    (tmp_path / "ext.png").write_bytes(
        encode_png(np.arange(48, dtype=np.uint8).reshape(6, 8) % 5, (2, 3),
                   palette=np.asarray([[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 9, 9],
                                       [200, 100, 0]], np.uint8)))
    rng = np.random.default_rng(3)
    big = rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)
    quad2 = WALL + np.asarray([1.0, 0.0, 0.0], np.float32)
    path = write_glb(tmp_path / "many.glb", [
        (WALL, QUAD, QUAD_UV, 0, 5126),
        (quad2, QUAD, None, 1, 5126),
        (quad2 + 1.0, QUAD, None, None, 5126),
        (quad2 + 2.0, QUAD, QUAD_UV * 0.5 + 0.25, 2, 5121),
        (quad2 + 3.0, QUAD, QUAD_UV * 3.0 - 1.0, 3, 5126),
    ], [encode_png(checker(), (4,)), "ext.png", encode_png(big, (1, 4))], [
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}},
        {"pbrMetallicRoughness": {"baseColorFactor": [0.2, 0.4, 0.6, 1.0]}},
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 1}}},
        {"pbrMetallicRoughness": {"baseColorTexture": {"index": 2}}},
    ])
    got = tmesh.load_glb_textured(path, max_tex=32)
    ref = jmesh.load_glb_textured(path, max_tex=32)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    for k in ("uv", "tex"):
        np.testing.assert_array_equal(got[2][k], ref[2][k], err_msg=k)
    assert [im.shape for im in got[2]["images"]] == [(32, 32, 3), (1, 1, 3), (6, 8, 3),
                                                     (32, 20, 3)]
    for a, b in zip(got[2]["images"], ref[2]["images"]):
        np.testing.assert_array_equal(a, b)
    assert got[2]["tex"].tolist() == [0, 0, 1, 1, -1, -1, 2, 2, 3, 3]
    from visfly_tpu_torch.render.tri_trace import pack_triangles

    _, order = pack_triangles(got[0], got[1], return_order=True)
    for face_order in (None, order):
        for a, b in zip(tmesh.build_atlas(got[2], face_order),
                        jmesh.build_atlas(ref[2], face_order)):
            np.testing.assert_array_equal(a, b)
    plain = write_glb(tmp_path / "plain.glb", [(WALL, QUAD, None, None, 5126)], [], [])
    assert tmesh.load_glb_textured(plain)[2] is None and jmesh.load_glb_textured(plain)[2] is None


def test_textured_glb_renders_checkerboard(tmp_path):
    """``test_mesh_native.py::test_textured_glb_renders_checkerboard``: the
    bake carries equal tables, and the textured render equals the JAX render
    and shows alternating cells, not a flat mean."""
    p = checker_glb(tmp_path / "checker.glb")
    data = tmesh.bake_mesh_scene(p, spacing=0.25, margin=2.5, device="cpu")
    jdata = jmesh.bake_mesh_scene(p, spacing=0.25, margin=2.5)
    for f in ("sdf", "triangles", "tri_uv", "tri_rect", "atlas"):
        np.testing.assert_array_equal(getattr(data, f).numpy(), np.asarray(getattr(jdata, f)))
    cam = {"sensor_type": "color", "resolution": [64, 64]}
    out, ref = render_both(data, jdata, [[-0.5, 0.0, 0.0]], cam)
    assert_images_close(out["color"], ref["color"])
    rgb = out["color"][0].permute(1, 2, 0).numpy()
    hit = rgb.sum(-1) > 0
    assert hit.mean() > 0.5
    g = rgb[..., 0].astype(np.int32)[hit.any(1)][:, hit.any(0)]
    mid = (g.max() + g.min()) / 2
    assert g.max() > 2.5 * max(g.min(), 1)
    row = g[g.shape[0] // 2]
    assert int((np.abs(np.diff((row > mid).astype(int))) > 0).sum()) >= 4
    assert 0.2 < float((g < mid).mean()) < 0.8


def test_tiled_scene_data_keeps_textures(tmp_path):
    """Tiling a textured scene tiles its tables: scene 1 renders as scene 0,
    and as the JAX tiled scene."""
    p = checker_glb(tmp_path / "checker.glb")
    data = _tile_scene_data(tmesh.bake_mesh_scene(p, spacing=0.25, margin=2.5, device="cpu"), 2)
    jdata = jtile(jmesh.bake_mesh_scene(p, spacing=0.25, margin=2.5), 2)
    assert data.atlas.shape[0] == data.tri_uv.shape[0] == data.tri_rect.shape[0] == 2
    for f in ("tri_uv", "tri_rect", "atlas"):
        np.testing.assert_array_equal(getattr(data, f).numpy(), np.asarray(getattr(jdata, f)))
    out, ref = render_both(data, jdata, [[-0.5, 0.0, 0.0]] * 2,
                           {"sensor_type": "color", "resolution": [32, 32]})
    assert torch.equal(out["color"][0], out["color"][1])
    assert_images_close(out["color"], ref["color"])


def shadow_case():
    """A floor triangle and a blocker quad 2 m above the origin, with points
    on the floor; a sun overhead and a point light below the blocker."""
    tri = np.asarray([[[-9, -9, 0, 9, -9, 0, 0, 9, 0], [-.5, -.5, 2, .5, -.5, 2, -.5, .5, 2],
                       [.5, -.5, 2, .5, .5, 2, -.5, .5, 2]]], np.float32)
    rng = np.random.default_rng(0)
    p = np.concatenate([[[0.0, 0.0, 0.0], [4.0, 0.0, 0.0]],
                        np.c_[rng.uniform(-1.5, 1.5, (62, 2)), np.zeros(62)]])[None]
    nrm = np.broadcast_to(np.asarray([0.0, 0.0, 1.0]), p.shape)
    cfg = {"shadows": True, "lights": [
        {"type": "directional", "direction": [0, 0, -1]},
        {"type": "directional", "direction": [0.3, -0.2, -1.0], "intensity": 0.5},
        {"type": "point", "position": [0.0, 0.0, 1.0]},
        {"type": "point", "position": [0.2, 0.1, 3.0]}]}
    return tri, p.astype(np.float32), nrm.astype(np.float32), cfg


def test_shadow_visibility_equals_jax_and_chunks_change_nothing():
    tri, p, nrm, cfg = shadow_case()
    vis = tst.shadow_visibility(torch.from_numpy(tri), torch.from_numpy(p), torch.from_numpy(nrm),
                                tst.bake_lighting(cfg))
    ref = np.asarray(jst.shadow_visibility(jnp.asarray(tri), jnp.asarray(p), jnp.asarray(nrm),
                                           jst.bake_lighting(cfg)))
    np.testing.assert_array_equal(vis.numpy(), ref)
    assert vis[0, 0, 0] == 0 and vis[0, 1, 0] == 1 and vis[0, 0, 2] == 1
    assert 0 < float(vis[0, :, 0].mean()) < 1 and 0 < float(vis[0, :, 3].mean()) < 1
    for slab, chunk in ((1, 1), (2, 7), (3, 1 << 22), (512, 40)):
        got = tst.shadow_visibility(torch.from_numpy(tri), torch.from_numpy(p),
                                    torch.from_numpy(nrm), tst.bake_lighting(cfg), slab=slab,
                                    chunk_elems=chunk)
        assert torch.equal(got, vis), (slab, chunk)


def test_shadowed_render_matches_jax(tmp_path):
    """A wall and a blocker, lit from the side: the shadowed colour equals
    the JAX render, shadows only remove light and darken some pixels."""
    v = np.asarray([[5, -6, -6], [5, 6, -6], [5, 6, 6], [5, -6, 6], [2.5, -2.8, -0.4],
                    [2.5, -2.0, -0.4], [2.5, -2.0, 0.4], [2.5, -2.8, 0.4]], np.float32)
    f = np.asarray([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    data = tmesh.bake_scene_from_arrays(v, f, spacing=0.25, margin=1.0, device="cpu")
    jdata = jmesh.bake_scene_from_arrays(v, f, spacing=0.25, margin=1.0)
    cam = {"uuid": "color", "sensor_type": "color", "resolution": [32, 32]}
    cfg = {"ambient": 0.15, "lights": [{"type": "directional", "direction": [1.0, 1.0, 0.0],
                                        "intensity": 1.2}]}
    plain, _ = render_both(data, jdata, [[0.0, 0.0, 0.0]], cam, lighting=cfg)
    shad, ref = render_both(data, jdata, [[0.0, 0.0, 0.0]], cam,
                            lighting={**cfg, "shadows": True})
    assert_images_close(shad["color"], ref["color"])
    a, b = plain["color"].int(), shad["color"].int()
    assert (b <= a).all() and ((a - b) > 20).any()
