"""Synthetic triangle-mesh assets for the mesh-import examples (counterpart
of ``examples/mesh_assets.py``): a garage-like mesh (floor, ceiling, walls
and pillars) written as an OBJ, fed through the real import pipeline
(``scene/mesh.py``). The same arguments write the same file as the JAX
example's.
"""
import os

import numpy as np


def _add_box(verts, faces, center, half):
    c = np.asarray(center, np.float32)
    h = np.asarray(half, np.float32)
    base = len(verts)
    v = np.asarray(
        [[x, y, z] for x in (-h[0], h[0]) for y in (-h[1], h[1])
         for z in (-h[2], h[2])], np.float32) + c
    f = np.asarray(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
        np.int32) + base
    verts.extend(v.tolist())
    faces.extend(f.tolist())


def make_garage_obj(path: str, n_pillars: int = 8, seed: int = 0) -> str:
    """Write a garage-like OBJ (interior ~16×8×3.5 m, ``n_pillars`` pillars
    at x from 2 to 14 m, y drawn from ``seed``) and return its path."""
    verts, faces = [], []
    _add_box(verts, faces, [8, 0, -0.25], [9, 5, 0.25])    # floor
    _add_box(verts, faces, [8, 0, 3.75], [9, 5, 0.25])     # ceiling
    _add_box(verts, faces, [-0.75, 0, 1.75], [0.25, 5, 2])
    _add_box(verts, faces, [16.75, 0, 1.75], [0.25, 5, 2])
    _add_box(verts, faces, [8, -4.75, 1.75], [9, 0.25, 2])
    _add_box(verts, faces, [8, 4.75, 1.75], [9, 0.25, 2])
    rng = np.random.RandomState(seed)
    for i in range(n_pillars):
        x = 2.0 + 12.0 * (i / max(n_pillars - 1, 1))
        y = rng.uniform(-3, 3)
        _add_box(verts, faces, [x, y, 1.75], [0.3, 0.3, 1.75])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return path
