"""Triangle-mesh scene import: OBJ/GLB → SDF grid plus the exact triangles
(counterpart of ``visfly_tpu/scene/mesh.py``).

Host-side and numpy until the last step: a minimal OBJ / binary-glTF parser
extracts triangles, the native BVH baker (``native/mesh_sdf.cpp``, built on
demand by ``visfly_tpu_torch.build`` with the host compiler into ``build/``)
computes a signed distance grid, and the result is a ``SceneData`` of tensors
on the caller's device that carries the grid (collision sign, spawn
rejection, albedo and semantic lookups) and the packed triangle soup (exact
cameras and exact closest-point queries).

A GLB's materials bring textures (``load_glb_textured``: embedded or
external images, decoded by :func:`decode_image`; a flat
``baseColorFactor`` becomes a 1×1 image), packed into per-face UV and atlas
tables (``build_atlas``) that the exact-triangle camera samples. A habitat
scene's meshes carry instance ids and material colours
(``mesh_base_color``), which label the semantic grid per instance and key
its albedo.

A baker that does not build or load raises: there is no numpy stand-in.
"""
from __future__ import annotations

import ctypes
import functools
import json
import struct
from typing import NamedTuple, Tuple

import numpy as np

@functools.lru_cache(maxsize=None)
def _baker() -> ctypes.CDLL:
    from ..build import load_native

    lib = load_native("mesh_sdf")
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.mesh_to_sdf.restype = ctypes.c_int
    lib.mesh_to_sdf.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int, fp, ctypes.c_float, ip,
                                ctypes.c_int, fp]
    return lib


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Vertices (V, 3) float32 and fan-triangulated faces (F, 3) int32."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


_COMPONENT_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
                     5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def _read_glb(path: str) -> Tuple[dict, bytes]:
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or struct.unpack("<I", head[:4])[0] != 0x46546C67:
            raise ValueError(f"{path} is not a GLB file")
        chunks = {}
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            clen, ctype = struct.unpack("<II", header)
            chunks[ctype] = f.read(clen)
    return json.loads(chunks[0x4E4F534A].decode("utf-8")), chunks.get(0x004E4942, b"")


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m = m @ np.diag([*node["scale"], 1.0])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        rm = np.eye(4)
        rm[:3, :3] = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m = rm @ m
    if "translation" in node:
        tm = np.eye(4)
        tm[:3, 3] = node["translation"]
        m = tm @ m
    return m


def _glb_primitives(gltf: dict, read_accessor):
    """Every mesh primitive with positions, in the scene's node order: (the
    primitive's dict, its vertices in world coordinates (V, 3) float64, its
    faces (F, 3) int64), node transforms applied."""
    out = []

    def visit(node_idx, parent):
        node = gltf["nodes"][node_idx]
        m = parent @ _node_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                if "POSITION" not in prim["attributes"]:
                    continue
                pos = read_accessor(prim["attributes"]["POSITION"]).astype(np.float64)
                pos_h = np.concatenate([pos, np.ones((len(pos), 1))], axis=1)
                if "indices" in prim:
                    idx = read_accessor(prim["indices"]).reshape(-1).astype(np.int64)
                else:
                    idx = np.arange(len(pos))
                out.append((prim, (m @ pos_h.T).T[:, :3], idx.reshape(-1, 3)))
        for child in node.get("children", []):
            visit(child, m)

    for node_idx in gltf["scenes"][gltf.get("scene", 0)]["nodes"]:
        visit(node_idx, np.eye(4))
    return out


def _merge(prims):
    """The primitives' vertices and faces as one soup (float32, int32)."""
    offsets = np.cumsum([0] + [len(v) for _, v, _ in prims])
    return (np.concatenate([v for _, v, _ in prims]).astype(np.float32),
            np.concatenate([f + o for (_, _, f), o in zip(prims, offsets)]).astype(np.int32))


def load_glb(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal binary-glTF triangle extractor: positions and indices of
    every mesh primitive, node transforms applied; geometry only. Accessors
    are assumed tightly packed (no byteStride)."""
    gltf, bin_data = _read_glb(path)
    return _merge(_glb_primitives(gltf, _accessor_reader(gltf, bin_data)))


def _accessor_reader(gltf: dict, bin_data: bytes):
    """accessor index → (count, components) array; integer accessors marked
    ``normalized`` read as floats in [0, 1]."""
    def read(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        count = acc["count"] * _TYPE_COUNTS[acc["type"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        arr = np.frombuffer(bin_data, dtype=dtype, count=count,
                            offset=offset).reshape(acc["count"], -1)
        if acc.get("normalized") and dtype in (np.uint8, np.uint16):
            arr = arr.astype(np.float32) / np.iinfo(dtype).max
        return arr

    return read


def _halve(img: np.ndarray) -> np.ndarray:
    """An RGB image at half its width and height: PIL's ``resize`` where PIL
    imports (what the JAX package does), else the mean of each 2×2 block."""
    h, w = max(img.shape[0] // 2, 1), max(img.shape[1] // 2, 1)
    try:
        from PIL import Image
    except ImportError:
        blocks = img[:2 * h, :2 * w].astype(np.float32).reshape(h, 2, w, 2, 3)
        return np.round(blocks.mean(axis=(1, 3))).astype(np.uint8)
    return np.asarray(Image.fromarray(img).resize((w, h)), np.uint8)


def decode_image(raw: bytes, max_tex: int = 1024):
    """Image bytes → (h, w, 3) uint8 RGB, halved until neither side exceeds
    ``max_tex``; or None. An 8-bit PNG decodes with :mod:`.png` (whether or
    not PIL is installed); any other image through PIL where it imports, and
    is None where PIL is missing or refuses it, the JAX package's rule."""
    import io

    from .png import decode_png, is_png

    img = decode_png(raw) if is_png(raw) else None
    if img is None:
        try:
            from PIL import Image
        except ImportError:
            return None
        try:
            img = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.uint8)
        except (OSError, ValueError):  # bytes PIL cannot read
            return None
    while img.shape[0] > max_tex or img.shape[1] > max_tex:
        img = _halve(img)
    return img


def load_glb_textured(path: str, max_tex: int = 1024):
    """GLB triangles and their textures: ``(verts, faces, texinfo)``.

    ``texinfo`` is None for an asset without materials, else a dict of
    per-face ``uv`` (F, 3, 2) (TEXCOORD_0 at each corner, v down), ``tex``
    (F,) int (the face's image, −1 for none) and ``images``, a list of
    (h, w, 3) uint8 arrays (:func:`decode_image`). A material without a
    decodable ``baseColorTexture`` gives a 1×1 image of its
    ``baseColorFactor``, so every face samples the same way. Accessors are
    assumed tightly packed (no byteStride), as in :func:`load_glb`."""
    import os

    gltf, bin_data = _read_glb(path)
    read_accessor = _accessor_reader(gltf, bin_data)
    images = []

    def image_of(img_idx):
        img = gltf["images"][img_idx]
        if "bufferView" in img:
            view = gltf["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            raw = bin_data[off:off + view["byteLength"]]
        elif "uri" in img and not img["uri"].startswith("data:"):
            with open(os.path.join(os.path.dirname(path), img["uri"]), "rb") as fh:
                raw = fh.read()
        else:
            return None
        return decode_image(raw, max_tex)

    image_slot = {}  # glTF image → images[] slot, −1 where it did not decode
    flat_slot = {}  # material → slot of its 1×1 flat colour

    def material_slot(mat_idx):
        if mat_idx is None:
            return -1
        pbr = gltf.get("materials", [{}])[mat_idx].get("pbrMetallicRoughness", {})
        tex = pbr.get("baseColorTexture")
        if tex is not None:
            src = gltf["textures"][tex["index"]].get("source")
            if src is not None:
                if src not in image_slot:
                    arr = image_of(src)
                    if arr is None:
                        image_slot[src] = -1
                    else:
                        images.append(arr)
                        image_slot[src] = len(images) - 1
                if image_slot[src] >= 0:
                    return image_slot[src]
        if mat_idx not in flat_slot:
            base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
            images.append(np.asarray(np.clip(np.asarray(base[:3]) * 255, 0, 255),
                                     np.uint8).reshape(1, 1, 3))
            flat_slot[mat_idx] = len(images) - 1
        return flat_slot[mat_idx]

    prims = _glb_primitives(gltf, read_accessor)
    uv_all, tex_all = [], []
    for prim, _, fcs in prims:
        slot = material_slot(prim.get("material"))
        if "TEXCOORD_0" in prim["attributes"] and slot >= 0:
            uv_v = read_accessor(prim["attributes"]["TEXCOORD_0"]).astype(np.float32)
            uv_all.append(uv_v[fcs.reshape(-1)].reshape(-1, 3, 2))
        else:
            uv_all.append(np.full((len(fcs), 3, 2), 0.5, np.float32))
        tex_all.append(np.full(len(fcs), slot, np.int32))
    verts, faces = _merge(prims)
    if not images:
        return verts, faces, None
    return verts, faces, {"uv": np.concatenate(uv_all), "tex": np.concatenate(tex_all),
                          "images": images}


def build_atlas(texinfo, face_order=None):
    """texinfo (:func:`load_glb_textured`) → the exact-triangle camera's
    tables ``(uv (T, 6) f32, rect (T, 4) f32 [tw th y0 x0] in texels,
    atlas (AH, AW, 3) uint8)``: the images stacked top to bottom.
    ``face_order`` is ``pack_triangles``'s packed row → original face map,
    so the rows follow the packed order; padding rows (−1) get tw = 0."""
    images = texinfo["images"]
    aw = max(im.shape[1] for im in images)
    ah = sum(im.shape[0] for im in images)
    atlas = np.zeros((ah, aw, 3), np.uint8)
    rects = np.zeros((len(images), 4), np.float32)
    y = 0
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        atlas[y:y + h, :w] = im
        rects[i] = (w, h, y, 0)
        y += h
    uv_f = texinfo["uv"].reshape(-1, 6).astype(np.float32)
    rect_f = rects[np.clip(texinfo["tex"], 0, len(images) - 1)]
    rect_f[texinfo["tex"] < 0] = 0
    if face_order is None:
        return uv_f, rect_f, atlas
    uv_o = np.zeros((len(face_order), 6), np.float32)
    rect_o = np.zeros((len(face_order), 4), np.float32)
    valid = face_order >= 0
    uv_o[valid] = uv_f[face_order[valid]]
    rect_o[valid] = rect_f[face_order[valid]]
    return uv_o, rect_o, atlas


def mesh_base_color(path: str):
    """A mesh asset's representative colour, (3,) uint8, or None without a
    material: the face-weighted mean of a glTF's ``baseColorFactor`` or an
    OBJ's MTL ``Kd``. The instance colour of the baked albedo and of the
    decomposed primitives."""
    import os

    ext = os.path.splitext(path)[1].lower()
    try:
        if ext in (".glb", ".gltf"):
            return _glb_base_color(path)
        if ext == ".obj":
            return _obj_base_color(path)
    except (OSError, ValueError, KeyError, json.JSONDecodeError):
        return None
    return None


def _glb_base_color(path: str):
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) == 12 and struct.unpack("<I", head[:4])[0] == 0x46546C67:
            clen, ctype = struct.unpack("<II", f.read(8))
            if ctype != 0x4E4F534A:
                return None
            gltf = json.loads(f.read(clen).decode("utf-8"))
        else:  # a plain-JSON .gltf
            f.seek(0)
            gltf = json.loads(f.read().decode("utf-8"))
    mats = gltf.get("materials", [])
    if not mats:
        return None
    total_w, acc = 0.0, np.zeros(3)
    for mesh in gltf.get("meshes", []):
        for prim in mesh.get("primitives", []):
            mi = prim.get("material")
            if mi is None:
                continue
            ai = prim.get("indices", prim.get("attributes", {}).get("POSITION"))
            w = float(gltf["accessors"][ai]["count"]) if ai is not None else 1.0
            factor = mats[mi].get("pbrMetallicRoughness", {}).get(
                "baseColorFactor", [1.0, 1.0, 1.0, 1.0])
            acc += w * np.asarray(factor[:3])
            total_w += w
    if total_w == 0.0:
        return None
    return np.clip(acc / total_w * 255.0, 0, 255).astype(np.uint8)


def _obj_base_color(path: str):
    import os

    mtl_kd, mtl_files, counts, cur = {}, [], {}, None
    with open(path) as f:
        for line in f:
            if line.startswith("mtllib"):
                mtl_files += line.split()[1:]
            elif line.startswith("usemtl"):
                cur = line.split(None, 1)[1].strip()
            elif line.startswith("f ") and cur is not None:
                counts[cur] = counts.get(cur, 0) + 1
    for m in mtl_files:
        mp = os.path.join(os.path.dirname(path), m)
        if not os.path.isfile(mp):
            continue
        name = None
        with open(mp) as f:
            for line in f:
                if line.startswith("newmtl"):
                    name = line.split(None, 1)[1].strip()
                elif line.startswith("Kd ") and name is not None:
                    mtl_kd[name] = np.asarray([float(x) for x in line.split()[1:4]])
    # only the materials faces use count (a shared library may define many)
    pairs = [(counts[n], kd) for n, kd in mtl_kd.items() if counts.get(n)]
    if not pairs:
        return None
    w = np.asarray([p[0] for p in pairs], float)
    kds = np.stack([p[1] for p in pairs])
    return np.clip((w[:, None] * kds).sum(0) / w.sum() * 255.0, 0, 255).astype(np.uint8)


def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    if path.endswith(".obj"):
        return load_obj(path)
    if path.endswith((".glb", ".gltf")):
        return load_glb(path)
    raise ValueError(f"unsupported mesh format: {path}")


# ---------------------------------------------------------------------------
# SDF baking
# ---------------------------------------------------------------------------


def instance_palette(n: int) -> np.ndarray:
    """(n, 3) uint8 instance colours: golden-angle hues at two lightness
    bands. Row 0 (the stage) is the neutral 180 grey of plain imported
    meshes."""
    import colorsys

    out = np.full((max(n, 1), 3), 180, np.uint8)
    for i in range(1, n):
        h = (i * 0.381966) % 1.0
        light = 0.55 if i % 2 else 0.4
        out[i] = np.asarray(colorsys.hls_to_rgb(h, light, 0.9)) * 255
    return out


def mesh_to_sdf_grid(verts: np.ndarray, faces: np.ndarray, origin: np.ndarray, spacing: float,
                     dims: Tuple[int, int, int], signed: bool = True) -> np.ndarray:
    """(X, Y, Z) float32 signed distance grid of the mesh, by the native
    baker (exact distances from a BVH, sign by ray parity)."""
    lib = _baker()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    origin = np.ascontiguousarray(origin, np.float32)
    dims_arr = np.ascontiguousarray(dims, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or faces.ndim != 2 or faces.shape[1] != 3:
        raise ValueError(f"a mesh is verts (V, 3) and faces (F, 3); got {verts.shape} and "
                         f"{faces.shape}")
    if len(faces) and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError("face indices outside the vertex array")
    out = np.empty(int(np.prod(dims)), np.float32)
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    rc = lib.mesh_to_sdf(verts.ctypes.data_as(fp), len(verts), faces.ctypes.data_as(ip),
                         len(faces), origin.ctypes.data_as(fp), ctypes.c_float(spacing),
                         dims_arr.ctypes.data_as(ip), ctypes.c_int(1 if signed else 0),
                         out.ctypes.data_as(fp))
    if rc != 0:
        raise RuntimeError(f"mesh_to_sdf failed rc={rc}")
    return out.reshape(dims)




def bake_mesh_scene(path: str, spacing: float = 0.1, margin: float = 0.5,
                    max_cells: int = 384, device=None):
    """Load a mesh file and bake it into a single-scene ``SceneData``; a GLB
    with materials brings its texture tables."""
    if path.endswith((".glb", ".gltf")):
        verts, faces, texinfo = load_glb_textured(path)
        return bake_scenes_from_meshes([(verts, faces, None, None, texinfo)], spacing=spacing,
                                       margin=margin, max_cells=max_cells, device=device)
    verts, faces = load_mesh(path)
    return bake_scene_from_arrays(verts, faces, spacing=spacing, margin=margin,
                                  max_cells=max_cells, device=device)


def bake_scene_from_arrays(verts: np.ndarray, faces: np.ndarray, spacing: float = 0.1,
                           margin: float = 0.5, max_cells: int = 384, device=None):
    """Triangle soup → ``SceneData`` with the exact triangles attached."""
    return bake_scenes_from_meshes([(verts, faces)], spacing=spacing, margin=margin,
                                   max_cells=max_cells, device=device)


class _Frame(NamedTuple):
    """The grid frame baked scenes share: origin, cell size, cell counts and
    the world bounds (the meshes' union, without the margin)."""

    lo: np.ndarray
    spacing: float
    dims: Tuple[int, int, int]
    bbox: np.ndarray


def _frame_of(meshes, spacing: float, margin: float, max_cells: int) -> _Frame:
    lo = np.stack([m[0].min(axis=0) for m in meshes]).min(axis=0) - margin
    hi = np.stack([m[0].max(axis=0) for m in meshes]).max(axis=0) + margin
    dims = np.minimum(np.ceil((hi - lo) / spacing).astype(int) + 1, max_cells)
    spacing = float(np.max((hi - lo) / (dims - 1)))
    return _Frame(lo, spacing, tuple(int(d) for d in dims),
                  np.stack([lo + margin, hi - margin]).astype(np.float32))


def _instance_grids(verts, faces, inst, colors, frame: _Frame):
    """Per-instance semantic ids (the nearest instance's id + 1, wrapping at
    255) and the id-keyed albedo (``colors``, else :func:`instance_palette`):
    a running argmin over one unsigned distance grid per instance, in
    instance order. The bakes run in a thread pool (the baker releases the
    interpreter lock; where it has no OpenMP each bake is single-threaded)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    ids = np.unique(inst)
    best = np.full(frame.dims, np.inf, np.float32)
    win = np.zeros(frame.dims, np.int32)

    def bake(iid):
        return mesh_to_sdf_grid(verts, faces[inst == iid], frame.lo, frame.spacing,
                                frame.dims, signed=False)

    with ThreadPoolExecutor(max_workers=min(len(ids), os.cpu_count() or 1)) as pool:
        for iid, d in zip(ids, pool.map(bake, ids)):
            m = d < best
            best = np.where(m, d, best)
            win = np.where(m, int(iid), win)
    pal = (np.asarray(colors, np.uint8) if colors is not None
           else instance_palette(int(win.max()) + 1))
    return (win % 255 + 1).astype(np.uint8), pal[win]


def _bake_one(mesh, frame: _Frame) -> dict:
    """One scene ``(verts, faces[, face_inst_ids[, inst_colors[, texinfo]]])``
    in ``frame`` → its numpy arrays: sdf, albedo, semantic, the packed
    triangles and, for a textured mesh, its uv, rect and atlas tables."""
    from ..render.tri_trace import pack_triangles

    v, f, inst, colors, texinfo = tuple(mesh) + (None,) * (5 - len(mesh))
    out = {"sdf": mesh_to_sdf_grid(v, f, frame.lo, frame.spacing, frame.dims)}
    out["triangles"], order = pack_triangles(v, f, return_order=True)
    if inst is None or len(np.unique(inst)) < 2:
        out["semantic"] = np.ones(frame.dims, np.uint8)
        out["albedo"] = np.full((*frame.dims, 3), 180, np.uint8)
    else:
        out["semantic"], out["albedo"] = _instance_grids(v, f, inst, colors, frame)
    out["tex"] = None if texinfo is None else build_atlas(texinfo, order)
    return out


def _stack(bakes, frame: _Frame, device, min_t: int = 0):
    """Per-scene bakes → one ``SceneData``: the soups zero-padded to one
    triangle count (at least ``min_t``). Where any scene is textured every
    scene gets tables; an untextured one samples a 1×1 grey 180 texel for
    every face."""
    from .scene import scene_data_from_arrays

    S = len(bakes)
    t_max = max([min_t] + [b["triangles"].shape[0] for b in bakes])
    tris = np.zeros((S, t_max, 9), np.float32)
    for i, b in enumerate(bakes):
        tris[i, :b["triangles"].shape[0]] = b["triangles"]
    arrays = {
        "sdf": np.stack([b["sdf"] for b in bakes]),
        "albedo": np.stack([b["albedo"] for b in bakes]),
        "semantic": np.stack([b["semantic"] for b in bakes]),
        "origin": frame.lo.astype(np.float32),
        "spacing": np.float32(frame.spacing),
        "bbox": frame.bbox,
        "triangles": tris,
    }
    if any(b["tex"] is not None for b in bakes):
        uvs = np.zeros((S, t_max, 6), np.float32)
        rects = np.zeros((S, t_max, 4), np.float32)
        atlases = []
        for i, b in enumerate(bakes):
            if b["tex"] is None:
                atlases.append(np.full((1, 1, 3), 180, np.uint8))
                rects[i, :, :2] = 1.0
                continue
            uv_i, rect_i, atlas_i = b["tex"]
            uvs[i, :len(uv_i)] = uv_i
            rects[i, :len(rect_i)] = rect_i
            atlases.append(atlas_i)
        atlas = np.zeros((S, max(a.shape[0] for a in atlases),
                          max(a.shape[1] for a in atlases), 3), np.uint8)
        for i, a in enumerate(atlases):
            atlas[i, :a.shape[0], :a.shape[1]] = a
        arrays.update(tri_uv=uvs, tri_rect=rects, atlas=atlas)
    return scene_data_from_arrays(arrays, device)


def bake_scenes_from_meshes(meshes, spacing: float = 0.1, margin: float = 0.5,
                            max_cells: int = 384, device=None):
    """Triangle soups → one stacked ``SceneData`` on ``device``: every scene
    in one grid frame (the union of their bounds), the soups zero-padded to
    one triangle count.

    A mesh is ``(verts, faces[, face_inst_ids[, inst_colors[, texinfo]]])``.
    With instance ids (two or more distinct) its semantic grid labels every
    cell with the nearest instance's id + 1, wrapping at 255, and its albedo
    is keyed by that id (``inst_colors`` (K, 3) uint8, else
    :func:`instance_palette`); otherwise grey 180 and id 1 throughout. A
    :func:`load_glb_textured` texinfo attaches the texture tables, and the
    exact-triangle camera then renders textured colour."""
    meshes = [tuple(m) for m in meshes]
    frame = _frame_of(meshes, spacing, margin, max_cells)
    return _stack([_bake_one(m, frame) for m in meshes], frame, device)


def rebake_scene(data, scene_id: int, mesh, margin: float = 0.5):
    """``data`` with scene ``scene_id`` replaced by ``mesh``, baked in
    ``data``'s grid frame; None where the mesh and its margin do not fit
    that frame (the caller bakes every scene anew). The other scenes keep
    their rows bit for bit; the soups and the atlas pad to the larger of the
    old and the new sizes."""
    import torch

    lo = data.origin.cpu().numpy().astype(np.float64)
    spacing = float(data.spacing)
    dims = tuple(int(d) for d in data.sdf.shape[1:])
    hi = lo + (np.asarray(dims) - 1) * spacing
    if (np.any(mesh[0].min(axis=0) - margin < lo - 1e-6)
            or np.any(mesh[0].max(axis=0) + margin > hi + 1e-6)):
        return None
    frame = _Frame(data.origin.cpu().numpy(), spacing, dims, data.bbox.cpu().numpy())
    new = _stack([_bake_one(tuple(mesh), frame)], frame, data.sdf.device,
                 min_t=data.triangles.shape[1])
    textured = isinstance(data.tri_uv, torch.Tensor) or isinstance(new.tri_uv, torch.Tensor)

    def tables(d):
        """uv, rect and atlas of ``d``, the grey texel where it has none."""
        if isinstance(d.tri_uv, torch.Tensor):
            return d.tri_uv, d.tri_rect, d.atlas
        S, T = d.triangles.shape[:2]
        rect = torch.zeros((S, T, 4), device=d.sdf.device)
        rect[..., :2] = 1.0
        return (torch.zeros((S, T, 6), device=d.sdf.device), rect,
                torch.full((S, 1, 1, 3), 180, dtype=torch.uint8, device=d.sdf.device))

    def put(old, row):
        """``old`` with scene ``scene_id`` set to ``row`` (1, ...), both
        zero-padded to their larger size."""
        size = [max(a, b) for a, b in zip(old.shape[1:], row.shape[1:])]
        out = old.new_zeros((old.shape[0], *size))
        out[(slice(None),) + tuple(slice(0, n) for n in old.shape[1:])] = old
        out[scene_id] = 0
        out[(scene_id,) + tuple(slice(0, n) for n in row.shape[1:])] = row[0]
        return out

    fields = {name: put(getattr(data, name), getattr(new, name))
              for name in ("sdf", "albedo", "semantic", "triangles")}
    if textured:
        old_t, new_t = tables(data), tables(new)
        for name, a, b in zip(("tri_uv", "tri_rect", "atlas"), old_t, new_t):
            fields[name] = put(a, b)
    return data._replace(**fields)
