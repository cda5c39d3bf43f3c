"""Triangle-mesh scene import: OBJ/GLB → SDF grid plus the exact triangles
(counterpart of ``visfly_tpu/scene/mesh.py``).

Host-side and numpy until the last step: a minimal OBJ / binary-glTF parser
extracts triangles, the native BVH baker (``native/mesh_sdf.cpp``, built on
demand by ``visfly_tpu_torch.build`` with the host compiler into ``build/``)
computes a signed distance grid, and the result is a ``SceneData`` of tensors
on the caller's device that carries the grid (collision sign, spawn
rejection, albedo and semantic lookups) and the packed triangle soup (exact
cameras and exact closest-point queries).

A baker that does not build or load raises: there is no numpy stand-in.
Not ported yet, each raising ``NotImplementedError``: per-instance semantic
ids and material colours, textures (``load_glb_textured``, ``build_atlas``).
"""
from __future__ import annotations

import ctypes
import functools
import json
import struct
from typing import Tuple

import numpy as np

_ITEM_18 = "Queue A item 18, imported meshes: textures, atlases and instances"


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {_ITEM_18})")


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
        magic, _version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:
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


def load_glb(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal binary-glTF triangle extractor: positions and indices of
    every mesh primitive, node transforms applied; geometry only. Accessors
    are assumed tightly packed (no byteStride)."""
    gltf, bin_data = _read_glb(path)

    def read_accessor(idx):
        acc = gltf["accessors"][idx]
        view = gltf["bufferViews"][acc["bufferView"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        count = acc["count"] * _TYPE_COUNTS[acc["type"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        arr = np.frombuffer(bin_data, dtype=dtype, count=count, offset=offset)
        return arr.reshape(acc["count"], -1)

    verts_all, faces_all = [], []
    offset = 0

    def visit(node_idx, parent):
        nonlocal offset
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
                faces_all.append(idx.reshape(-1, 3) + offset)
                verts_all.append((m @ pos_h.T).T[:, :3])
                offset += len(pos)
        for child in node.get("children", []):
            visit(child, m)

    for node_idx in gltf["scenes"][gltf.get("scene", 0)]["nodes"]:
        visit(node_idx, np.eye(4))
    return (np.concatenate(verts_all).astype(np.float32),
            np.concatenate(faces_all).astype(np.int32))


def glb_has_materials(path: str) -> bool:
    """True when a primitive of the GLB names a material: the JAX package
    then renders it textured (flat materials become 1×1 textures)."""
    gltf, _ = _read_glb(path)
    return any(prim.get("material") is not None for mesh in gltf.get("meshes", [])
               for prim in mesh.get("primitives", []))


def load_glb_textured(path: str, max_tex: int = 1024):
    raise _unported("load_glb_textured (GLB textures and materials)")


def build_atlas(texinfo, face_order=None):
    raise _unported("build_atlas (texture atlases)")


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
    """Load a mesh file and bake it into a single-scene ``SceneData``."""
    if path.endswith((".glb", ".gltf")) and glb_has_materials(path):
        raise _unported("a GLB with materials or textures")
    verts, faces = load_mesh(path)
    return bake_scene_from_arrays(verts, faces, spacing=spacing, margin=margin,
                                  max_cells=max_cells, device=device)


def bake_scene_from_arrays(verts: np.ndarray, faces: np.ndarray, spacing: float = 0.1,
                           margin: float = 0.5, max_cells: int = 384, device=None):
    """Triangle soup → ``SceneData`` with the exact triangles attached."""
    return bake_scenes_from_meshes([(verts, faces)], spacing=spacing, margin=margin,
                                   max_cells=max_cells, device=device)


def bake_scenes_from_meshes(meshes, spacing: float = 0.1, margin: float = 0.5,
                            max_cells: int = 384, device=None):
    """Triangle soups ``(verts, faces)`` → one stacked ``SceneData`` on
    ``device``: all scenes share one grid frame (the union of their bounds),
    the soups are zero-padded to one triangle count, albedo is a flat grey
    180 and the semantic id 1 throughout."""
    from ..render.tri_trace import pack_triangles
    from .scene import scene_data_from_arrays

    meshes = [tuple(m) for m in meshes]
    if any(len(m) > 2 and any(x is not None for x in m[2:]) for m in meshes):
        raise _unported("per-instance ids, material colours and textures on a baked mesh")
    los = np.stack([m[0].min(axis=0) for m in meshes])
    his = np.stack([m[0].max(axis=0) for m in meshes])
    lo = los.min(axis=0) - margin
    hi = his.max(axis=0) + margin
    dims = np.minimum(np.ceil((hi - lo) / spacing).astype(int) + 1, max_cells)
    spacing = float(np.max((hi - lo) / (dims - 1)))
    dims_t = tuple(int(d) for d in dims)
    grids = [mesh_to_sdf_grid(m[0], m[1], lo, spacing, dims_t) for m in meshes]
    packed = [pack_triangles(m[0], m[1]) for m in meshes]
    t_max = max(p.shape[0] for p in packed)
    tris = np.zeros((len(packed), t_max, 9), np.float32)
    for i, p in enumerate(packed):
        tris[i, : p.shape[0]] = p
    shape = (len(meshes), *grids[0].shape)
    return scene_data_from_arrays({
        "sdf": np.stack(grids),
        "albedo": np.full((*shape, 3), 180, np.uint8),
        "semantic": np.ones(shape, np.uint8),
        "origin": lo.astype(np.float32),
        "spacing": np.float32(spacing),
        "bbox": np.stack([lo + margin, hi - margin]).astype(np.float32),
        "triangles": tris,
    }, device)
