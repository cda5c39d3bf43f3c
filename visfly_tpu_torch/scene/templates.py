"""Low-poly triangle templates for dynamic objects and drone bodies
(counterpart of ``visfly_tpu/scene/templates.py``, a numpy copy: importing
the JAX package's module would pull in JAX).

Templates are small local-frame triangle soups, ``(K, 9)`` rows of
``[ax ay az bx by bz cx cy cz]``, that the camera tracers pose at each
object's position (and, for drone bodies, attitude) every frame; collision
keeps the bounding-sphere proxy. They are procedural (a quadrotor, a standing
human figure, a box, an icosphere) or loaded from an OBJ/GLB file and
decimated to a triangle budget by vertex clustering. Everything here is
host-side numpy, built once per env.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

MAX_TEMPLATE_TRIS = 64


def _pack(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    return verts[faces.reshape(-1)].reshape(-1, 9).astype(np.float32)


def _box(center, half) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box: 8 verts, 12 tris, outward winding."""
    cx, cy, cz = center
    hx, hy, hz = half
    v = np.array(
        [[sx * hx + cx, sy * hy + cy, sz * hz + cz]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    # index = sx*4 + sy*2 + sz (0/1)
    f = np.array([
        [0, 1, 3], [0, 3, 2],          # -x
        [4, 7, 5], [4, 6, 7],          # +x
        [0, 4, 5], [0, 5, 1],          # -y
        [2, 3, 7], [2, 7, 6],          # +y
        [0, 2, 6], [0, 6, 4],          # -z
        [1, 5, 7], [1, 7, 3],          # +z
    ], np.int32)
    return v, f


def _disc(center, radius, n=6) -> Tuple[np.ndarray, np.ndarray]:
    """Flat horizontal n-gon fan (a rotor seen from any side is a thin
    blur — one n-gon reads right at 64×64)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rim = np.stack([center[0] + radius * np.cos(ang),
                    center[1] + radius * np.sin(ang),
                    np.full(n, center[2])], -1).astype(np.float32)
    v = np.concatenate([np.asarray(center, np.float32)[None], rim])
    f = np.stack([np.zeros(n, np.int32), 1 + np.arange(n, dtype=np.int32),
                  1 + (np.arange(n, dtype=np.int32) + 1) % n], -1)
    return v, f


def _merge(parts) -> np.ndarray:
    tris = []
    for v, f in parts:
        tris.append(_pack(v, f))
    return np.concatenate(tris, axis=0)


def drone_template(radius: float = 0.25) -> np.ndarray:
    """Procedural quadrotor fitting a bounding sphere of ``radius``: a flat
    central body, four diagonal arms, four rotor discs. The stand-in for
    the upstream simulator's DJI-Mavic model: the
    silhouette is what matters for swarm vision: wide and flat, not a
    ball. 60 triangles."""
    r = float(radius)
    arm = 0.72 * r  # rotor centers at ±arm on both diagonals
    rot_r = 0.26 * r
    body_h = 0.16 * r
    parts = [_box((0.0, 0.0, 0.0), (0.42 * r, 0.30 * r, body_h))]
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        ax, ay = dx * arm * c, dy * arm * s
        # arm: thin box from body to rotor hub (axis-aligned approx of the
        # diagonal strut — at template scale the stair-step is subpixel)
        parts.append(_box((ax / 2, ay / 2, 0.0),
                          (abs(ax) / 2 + 0.05 * r, 0.06 * r, 0.05 * r)))
        parts.append(_disc((ax, ay, body_h + 0.04 * r), rot_r))
    return _merge(parts)


def human_template(height: float = 1.7) -> np.ndarray:
    """Low-poly standing figure (the ``model_path: "human"``
    target object): legs, torso, head — 36 triangles, feet at z=0."""
    h = float(height)
    parts = [
        _box((0.0, 0.0, 0.70 * h), (0.14 * h, 0.09 * h, 0.22 * h)),  # torso
        _box((0.0, 0.0, 0.925 * h), (0.065 * h, 0.065 * h, 0.075 * h)),  # head
        _box((0.0, -0.07 * h, 0.24 * h), (0.055 * h, 0.055 * h, 0.24 * h)),
        _box((0.0, 0.07 * h, 0.24 * h), (0.055 * h, 0.055 * h, 0.24 * h)),
    ]
    return _merge(parts)


def box_template(half=(0.25, 0.25, 0.25)) -> np.ndarray:
    return _pack(*_box((0.0, 0.0, 0.0), half))


def sphere_template(radius: float = 0.25, subdiv: int = 1) -> np.ndarray:
    """Icosphere — for objects whose true shape IS a ball (the sphere
    analytic fallback is cheaper; this exists for mixed soups)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int32)
    for _ in range(max(0, subdiv)):
        mids = {}
        nv = list(v)
        nf = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = v[a] + v[b]
                m = m / np.linalg.norm(m)
                mids[key] = len(nv)
                nv.append(m)
            return mids[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(nv, np.float32), np.asarray(nf, np.int32)
    return _pack(v * radius, f)


def decimate_tris(tris: np.ndarray, max_tris: int) -> np.ndarray:
    """Vertex-clustering decimation of a (K, 9) soup: snap vertices to a
    uniform grid, drop degenerate triangles, coarsen until under budget."""
    if tris.shape[0] <= max_tris:
        return tris
    verts = tris.reshape(-1, 3)
    lo, hi = verts.min(0), verts.max(0)
    extent = float(np.max(hi - lo)) or 1.0
    for cells in (24, 16, 12, 8, 6, 4, 3, 2):
        cell = extent / cells
        q = np.round((verts - lo) / cell)
        snapped = (q * cell + lo).reshape(-1, 3, 3)
        a, b, c = snapped[:, 0], snapped[:, 1], snapped[:, 2]
        area2 = np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        keep = snapped[area2 > 1e-12]
        # dedupe identical snapped triangles (vertex-order insensitive)
        key = np.sort(keep.round(6).reshape(-1, 3, 3), axis=1).reshape(-1, 9)
        _, idx = np.unique(key, axis=0, return_index=True)
        keep = keep[np.sort(idx)]
        if keep.shape[0] <= max_tris:
            return keep.reshape(-1, 9).astype(np.float32)
    return keep.reshape(-1, 9)[:max_tris].astype(np.float32)


def fit_to_radius(tris: np.ndarray, radius: Optional[float],
                  ground: bool = False) -> np.ndarray:
    """Uniformly scale a soup so it fits inside a bounding sphere of
    ``radius`` about the origin (the pose/collision proxy every consumer
    assumes). ``ground=True`` keeps the model's feet at its bottom
    (centered at origin, not re-centered vertically)."""
    if radius is None:
        return tris
    v = tris.reshape(-1, 3)
    center = (v.min(0) + v.max(0)) / 2.0
    if ground:
        center = center * np.array([1.0, 1.0, 0.0], np.float32)
    v = v - center
    rmax = float(np.linalg.norm(v, axis=-1).max()) or 1.0
    return (v * (float(radius) / rmax)).reshape(-1, 9).astype(np.float32)


def object_template(model: str, radius: Optional[float] = None,
                    max_tris: int = MAX_TEMPLATE_TRIS) -> np.ndarray:
    """Resolve an obj-setting ``model_path`` to a (K, 9) local-frame soup,
    scaled to the setting's bounding ``radius``. Known procedural names
    (drone / human / box / sphere) need no asset on disk; anything else is
    loaded from the filesystem (OBJ/GLB) and decimated to ``max_tris``."""
    name = str(model).lower()
    if name in ("drone", "quad", "dji_mavic", "uav"):
        tris = drone_template(radius or 0.25)
        return tris
    if name in ("human", "person", "object_target"):
        tris = human_template()
    elif name == "box":
        tris = box_template()
    elif name in ("sphere", "ball"):
        tris = sphere_template(radius or 0.25)
        return tris if radius is None else fit_to_radius(tris, radius)
    elif os.path.exists(model):
        from .mesh import load_mesh

        verts, faces = load_mesh(model)
        tris = decimate_tris(_pack(np.asarray(verts, np.float32),
                                   np.asarray(faces, np.int32)), max_tris)
    else:
        raise ValueError(
            f"unknown object model {model!r}: not a procedural template "
            "(drone/human/box/sphere) and no such file")
    return fit_to_radius(tris, radius)


def pad_templates(templates, k: Optional[int] = None) -> np.ndarray:
    """Stack variable-size (Ki, 9) soups into (M, K, 9), zero rows padding
    (degenerate triangles never intersect). ``None`` entries become all-zero
    rows — the tracer's per-object has-mesh flag then falls back to the
    analytic bounding sphere for them."""
    sizes = [0 if t is None else t.shape[0] for t in templates]
    K = k or max(max(sizes), 1)
    out = np.zeros((len(templates), K, 9), np.float32)
    for i, t in enumerate(templates):
        if t is not None:
            out[i, : t.shape[0]] = t[:K]
    return out
