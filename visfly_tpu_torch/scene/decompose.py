"""Mesh → primitive decomposition (counterpart of
``visfly_tpu/scene/decompose.py``, host-side numpy with ``scipy.ndimage``).

An imported mesh's baked SDF occupancy is covered greedily with axis-aligned
boxes and vertical cylinders, which then ride the same analytic trace kernel
(B1, B1-kid) as the procedural scenes: the default backend of a mesh file or
a habitat scene. The cost is paid once on the host, at load.

Approximation contract: every emitted primitive lies inside the mesh
occupancy dilated by half a cell (primitives protrude at most spacing/2), and
extraction stops once ``min_cover`` of the interior cells are covered (or at
``max_prims``). Collision queries and cameras both see the decomposed
geometry.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .scene import SceneSpec


def _largest_box_at(occ: np.ndarray, seed: Tuple[int, int, int], r0: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedily grow an axis-aligned box of fully-occupied cells around
    ``seed``, starting from the guaranteed cube of radius ``r0``."""
    shape = np.asarray(occ.shape)
    lo = np.maximum(np.asarray(seed) - r0, 0)
    hi = np.minimum(np.asarray(seed) + r0, shape - 1)

    def slab_full(ax: int, idx: int) -> bool:
        sl = [slice(lo[0], hi[0] + 1), slice(lo[1], hi[1] + 1),
              slice(lo[2], hi[2] + 1)]
        sl[ax] = slice(idx, idx + 1)
        return bool(occ[tuple(sl)].all())

    improved = True
    while improved:
        improved = False
        for ax in range(3):
            if lo[ax] > 0 and slab_full(ax, lo[ax] - 1):
                lo[ax] -= 1
                improved = True
            if hi[ax] < shape[ax] - 1 and slab_full(ax, hi[ax] + 1):
                hi[ax] += 1
                improved = True
    return lo, hi


def _fit_vertical_cylinder(occ: np.ndarray, seed: Tuple[int, int, int],
                           r_cells: float) -> Optional[Tuple[int, int, float,
                                                             int, int]]:
    """Try a z-axis cylinder at ``seed``: radius from the interior depth,
    grown along z while the full disk stays occupied. Returns
    (ix, iy, radius_cells, z_lo, z_hi) or None. Cylinders cover curved
    columns (the common curved geometry) with ~zero surface error where
    greedy axis-aligned boxes square them off."""
    ix, iy, iz = seed

    def make_disk(rc):
        r_int = int(np.floor(rc))
        xs = np.arange(max(ix - r_int, 0), min(ix + r_int + 1, occ.shape[0]))
        ys = np.arange(max(iy - r_int, 0), min(iy + r_int + 1, occ.shape[1]))
        dx = (xs - ix)[:, None]
        dy = (ys - iy)[None, :]
        return xs, ys, (dx * dx + dy * dy) <= rc * rc

    def disk_occupied(xs, ys, disk, z: int) -> bool:
        sl = occ[xs[0]:xs[-1] + 1, ys[0]:ys[-1] + 1, z]
        return bool(sl[disk].all())

    # the SDF at the seed only lower-bounds the column radius (the seed sits
    # off the medial axis by up to half a cell, and the occupancy is dilated
    # by half a cell) — search in half-cell steps for the LARGEST disk that
    # fits, starting below the estimate
    r_max = max(occ.shape[0], occ.shape[1]) / 2.0
    found = False
    rc = max(r_cells - 1.0, 1.0)
    while rc <= r_max:
        xs_t, ys_t, disk_t = make_disk(rc)
        if disk_t.any() and disk_occupied(xs_t, ys_t, disk_t, iz):
            xs, ys, disk = xs_t, ys_t, disk_t
            r_cells = float(rc)
            found = True
            rc += 0.5
        else:
            break
    if not found:
        return None
    z_lo = z_hi = iz
    while z_lo > 0 and disk_occupied(xs, ys, disk, z_lo - 1):
        z_lo -= 1
    while z_hi < occ.shape[2] - 1 and disk_occupied(xs, ys, disk, z_hi + 1):
        z_hi += 1
    if (z_hi - z_lo + 1) < 2 * r_cells:  # squat disk — a box fits better
        return None
    return ix, iy, float(r_cells), z_lo, z_hi


def sdf_grid_to_boxes(
    sdf: np.ndarray,
    origin: np.ndarray,
    spacing: float,
    max_prims: int = 48,
    min_cover: float = 0.98,
    fit_cylinders: bool = True,
) -> List[dict]:
    """Greedy maximal-primitive covering of the SDF's occupied region
    (``sdf <= 0``). Returns ``{"type": "box"|"cylinder", ...}`` primitive
    dicts in world coordinates. At each seed both a maximal box and (for
    tall round regions) a vertical cylinder are grown; whichever covers more
    uncovered cells wins. Primitives may overlap (min-union SDF semantics
    make overlap free); each contains only occupied cells."""
    from scipy import ndimage

    sdf = np.asarray(sdf)
    # expansion set: half-a-cell dilation — robust to ±float noise on
    # surface cells, boxes protrude ≤ spacing/2 past the true surface
    occ = sdf <= 0.5 * spacing
    # coverage set: strictly interior cells — surface-shell cells must not
    # spawn sliver boxes of their own
    interior = sdf <= -0.45 * spacing
    total = int(interior.sum())
    if total == 0:
        interior = occ
        total = int(occ.sum())
    if total == 0:
        return []
    covered = np.zeros_like(occ)
    origin = np.asarray(origin, np.float64)
    prims: List[dict] = []
    # occupancy never changes inside the loop — one distance transform,
    # re-masked per iteration
    dt_full = ndimage.distance_transform_cdt(occ, metric="chessboard")
    while len(prims) < max_prims:
        uncovered = interior & ~covered
        if uncovered.sum() <= (1.0 - min_cover) * total:
            break
        # seed where the occupancy is thickest (chebyshev distance to free
        # space) among still-uncovered cells — big slabs come out first
        dt = np.where(uncovered, dt_full, 0)
        seed = np.unravel_index(int(np.argmax(dt)), occ.shape)
        r0 = max(int(dt[seed]) - 1, 0)
        lo, hi = _largest_box_at(occ, seed, r0)
        box_sl = (slice(lo[0], hi[0] + 1), slice(lo[1], hi[1] + 1),
                  slice(lo[2], hi[2] + 1))
        box_gain = int(uncovered[box_sl].sum())

        cyl = None
        if fit_cylinders:
            # radius from the true interior depth at the seed (−sdf is the
            # distance to the surface) → protrusion ≤ spacing/2, same
            # contract as the half-cell box dilation
            r_cells = max(-float(sdf[seed]) / spacing, 0.0) + 0.5
            cyl = _fit_vertical_cylinder(occ, seed, r_cells)
        if cyl is not None:
            ix, iy, rc, z_lo, z_hi = cyl
            r_int = int(np.floor(rc))
            xs = slice(max(ix - r_int, 0), min(ix + r_int + 1, occ.shape[0]))
            ys = slice(max(iy - r_int, 0), min(iy + r_int + 1, occ.shape[1]))
            gx = np.arange(xs.start, xs.stop)[:, None, None] - ix
            gy = np.arange(ys.start, ys.stop)[None, :, None] - iy
            disk3 = (gx * gx + gy * gy) <= rc * rc
            region = uncovered[xs, ys, z_lo:z_hi + 1]
            cyl_gain = int((region & disk3).sum())
        else:
            cyl_gain = -1

        # near-ties go to the cylinder: for a round column both candidates
        # cover ~the same interior cells (±few % from the half-cell seed
        # offset), but the box squares off the silhouette — its corners
        # protrude past the true surface and its faces fall 1−1/√2 of the
        # radius short of it. Cells a slightly-smaller cylinder leaves
        # uncovered are picked up by later primitives.
        if cyl_gain >= 0.85 * box_gain and cyl_gain > 0:
            covered[xs, ys, z_lo:z_hi + 1] |= np.broadcast_to(
                disk3, covered[xs, ys, z_lo:z_hi + 1].shape)
            center = origin + np.array([ix, iy, (z_lo + z_hi) / 2.0]) * spacing
            half_h = (z_hi - z_lo + 1) / 2.0 * spacing
            prims.append({
                "type": "cylinder",
                "center": center.astype(np.float32).tolist(),
                "radius": float(rc * spacing),
                "half_height": float(half_h),
                "semantic": 1,
            })
        else:
            covered[box_sl] = True
            # cells are spacing-wide: cell i spans origin + (i ± 0.5)·spacing
            center = origin + (lo + hi) / 2.0 * spacing
            half = (hi - lo + 1) / 2.0 * spacing
            prims.append({
                "type": "box",
                "center": center.astype(np.float32).tolist(),
                "half_extents": half.astype(np.float32).tolist(),
                "semantic": 1,
            })
    return prims


def decompose_verts_faces(
    verts: np.ndarray,
    faces: np.ndarray,
    name: str,
    spacing: float = 0.1,
    margin: float = 0.5,
    max_prims: int = 48,
    min_cover: float = 0.98,
    max_cells: int = 384,
) -> SceneSpec:
    """Triangle soup → box-decomposed :class:`SceneSpec` (host-side,
    one-time; the C++ BVH baker does the mesh→SDF step)."""
    from .mesh import mesh_to_sdf_grid

    lo = verts.min(axis=0) - margin
    hi = verts.max(axis=0) + margin
    dims = np.minimum(np.ceil((hi - lo) / spacing).astype(int) + 1, max_cells)
    spacing = float(np.max((hi - lo) / (dims - 1)))
    grid = mesh_to_sdf_grid(verts, faces, lo, spacing, tuple(int(d) for d in dims))
    prims = sdf_grid_to_boxes(grid, lo, spacing, max_prims=max_prims,
                              min_cover=min_cover)
    return SceneSpec(
        bounds_min=(lo + margin).astype(np.float32),
        bounds_max=(hi - margin).astype(np.float32),
        primitives=prims,
        name=name,
    )


def decompose_mesh_scene(
    path: str,
    spacing: float = 0.1,
    margin: float = 0.5,
    max_prims: int = 48,
    min_cover: float = 0.98,
    max_cells: int = 384,
) -> SceneSpec:
    """GLB/OBJ file → box-decomposed :class:`SceneSpec`."""
    from .mesh import load_mesh

    verts, faces = load_mesh(path)
    import os

    return decompose_verts_faces(
        verts, faces,
        name=os.path.splitext(os.path.basename(path))[0] + "_boxes",
        spacing=spacing, margin=margin, max_prims=max_prims,
        min_cover=min_cover, max_cells=max_cells,
    )
