"""Scene queries (counterpart of ``visfly_tpu/scene/queries.py``): the SDF,
its normal, the closest-point collision query and the spawn-rejection point
test, on packed primitive scenes (``PrimitiveScene``, analytic) and on baked
mesh scenes (``SceneData``: trilinear grid samples, and exact closest points
on the triangle soup where the scene carries one).

Points are a flat batch ``p (N, 3)`` with per-point scene ids ``sid (N,)``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from .prim_scene import PrimitiveScene, scene_sdf_flat
from .scene import SceneData


def _outside_bbox(data, p: Tensor) -> Tensor:
    lo, hi = data.bbox[0], data.bbox[1]
    return torch.any(p < lo, dim=-1) | torch.any(p > hi, dim=-1)


def _grid_coords(data: SceneData, p: Tensor) -> Tensor:
    return (p - data.origin) / data.spacing


def sample_sdf_nearest(data: SceneData, sid: Tensor, p: Tensor) -> Tensor:
    """Nearest-cell SDF lookup: one gather a point."""
    X, Y, Z = data.sdf.shape[1:]
    g = torch.round(_grid_coords(data, p)).to(torch.int64)
    g = torch.minimum(torch.clamp(g, min=0), g.new_tensor([X - 1, Y - 1, Z - 1]))
    lin = ((sid * X + g[..., 0]) * Y + g[..., 1]) * Z + g[..., 2]
    return data.sdf.reshape(-1)[lin]


def sample_sdf(data, sid: Tensor, p: Tensor) -> Tensor:
    """Scene SDF at points p (N, 3) with scene ids sid (N,): analytic for a
    PrimitiveScene, trilinear interpolation of the grid (eight gathers a
    point, continuous and differentiable in ``p``) for a SceneData."""
    if isinstance(data, PrimitiveScene):
        return scene_sdf_flat(data, sid, p)
    X, Y, Z = data.sdf.shape[1:]
    g = _grid_coords(data, p)
    g = torch.minimum(torch.clamp(g, min=0.0), g.new_tensor([X - 1.001, Y - 1.001, Z - 1.001]))
    g0 = torch.floor(g)
    f = g - g0
    i0 = g0.to(torch.int64)
    flat = data.sdf.reshape(-1)
    base = sid * (X * Y * Z)

    def corner(dx, dy, dz):
        return flat[base + ((i0[..., 0] + dx) * Y + (i0[..., 1] + dy)) * Z + (i0[..., 2] + dz)]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = corner(0, 0, 0) * (1 - fx) + corner(1, 0, 0) * fx
    c10 = corner(0, 1, 0) * (1 - fx) + corner(1, 1, 0) * fx
    c01 = corner(0, 0, 1) * (1 - fx) + corner(1, 0, 1) * fx
    c11 = corner(0, 1, 1) * (1 - fx) + corner(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def sdf_normal(data, sid: Tensor, p: Tensor, eps: float = None) -> Tensor:
    """Outward unit normal: the autograd gradient of the SDF for a
    PrimitiveScene (differentiable in ``p`` where ``p`` asks for gradients,
    else with no gradient history), central differences
    of the trilinear field, half a cell wide unless ``eps`` says otherwise,
    for a SceneData."""
    if isinstance(data, PrimitiveScene):
        with torch.enable_grad():
            q = p if p.requires_grad else p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(sample_sdf(data, sid, q)), q,
                                       create_graph=p.requires_grad)
        return g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-9)
    h = data.spacing * 0.5 if eps is None else eps
    n = []
    for axis in range(3):
        e = torch.zeros(3, dtype=p.dtype, device=p.device)
        e[axis] = 1.0
        e = e * h
        n.append(sample_sdf(data, sid, p + e) - sample_sdf(data, sid, p - e))
    n = torch.stack(n, dim=-1)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)


def _point_tri_closest(p: Tensor, tri: Tensor) -> Tensor:
    """Closest point on triangles to query points, without branches.

    p (..., 3) broadcast against tri (..., 9) rows [a | b | c] → (..., 3).
    Ericson's seven regions (Real-Time Collision Detection §5.1.5) as a chain
    of selects in reverse priority; the denominators of regions not taken are
    guarded so that no NaN leaks into the value or its gradient."""
    a, b, c = tri[..., 0:3], tri[..., 3:6], tri[..., 6:9]
    ab, ac, ap = b - a, c - a, p - a
    d1 = torch.sum(ab * ap, -1)
    d2 = torch.sum(ac * ap, -1)
    bp = p - b
    d3 = torch.sum(ab * bp, -1)
    d4 = torch.sum(ac * bp, -1)
    cp = p - c
    d5 = torch.sum(ab * cp, -1)
    d6 = torch.sum(ac * cp, -1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(x):
        return torch.where(x.abs() > 1e-20, x, 1.0)

    r_ab = a + torch.clamp(d1 / safe(d1 - d3), 0.0, 1.0)[..., None] * ab
    r_ac = a + torch.clamp(d2 / safe(d2 - d6), 0.0, 1.0)[..., None] * ac
    w_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0.0, 1.0)
    r_bc = b + w_bc[..., None] * (c - b)
    denom = safe(va + vb + vc)
    res = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]
    res = torch.where(((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0))[..., None], r_bc, res)
    res = torch.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], r_ac, res)
    res = torch.where(((d6 >= 0) & (d5 <= d6))[..., None], c, res)
    res = torch.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], r_ab, res)
    res = torch.where(((d3 >= 0) & (d4 <= d3))[..., None], b, res)
    res = torch.where(((d1 <= 0) & (d2 <= 0))[..., None], a, res)
    return res


def tri_closest_point(tris: Tensor, sid: Tensor, p: Tensor, chunk: int = 4096
                      ) -> Tuple[Tensor, Tensor]:
    """Exact closest surface point over a triangle soup.

    tris (S, T, 9) zero-padded soup × points p (N, 3) with scene ids sid (N,)
    → (point (N, 3), unsigned distance (N,)). A loop over slabs of ``chunk``
    triangles keeps the peak at O(N × chunk); all-zero padding rows are out.
    The nearest triangle is carried by selects, so the result is
    differentiable in ``p`` (piecewise smooth)."""
    T = tris.shape[1]
    chunk = min(chunk, T)
    best_d2 = torch.full(p.shape[:1], torch.inf, dtype=p.dtype, device=p.device)
    best_pt = torch.zeros_like(p)
    for k0 in range(0, T, chunk):
        sel = tris[:, k0:k0 + chunk][sid]  # (N, chunk, 9)
        valid = torch.any(sel != 0.0, dim=-1)
        q = _point_tri_closest(p[:, None, :], sel)
        d2 = torch.where(valid, torch.sum((q - p[:, None, :]) ** 2, -1), torch.inf)
        d2_min, j = torch.min(d2, dim=-1)
        pt_min = torch.gather(q, 1, j[:, None, None].expand(-1, 1, 3))[:, 0]
        better = d2_min < best_d2
        best_d2 = torch.where(better, d2_min, best_d2)
        best_pt = torch.where(better[:, None], pt_min, best_pt)
    return best_pt, torch.sqrt(torch.clamp(best_d2, min=1e-24))


def closest_point_query(data, sid: Tensor, p: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(closest surface point, distance, out_of_bounds). A mesh scene that
    carries its triangles answers exactly by :func:`tri_closest_point`, with
    the inside/outside sign from the baked grid; other scenes use
    point = p − n̂·sdf(p). The distance is clamped at 0 inside obstacles."""
    out = _outside_bbox(data, p)
    if isinstance(data, SceneData) and data.has_triangles and data.triangles.numel():
        point, dis = tri_closest_point(data.triangles, sid, p)
        inside = sample_sdf(data, sid, p) < 0.0
        return point, torch.where(inside, 0.0, dis), out
    dis = sample_sdf(data, sid, p)
    n = sdf_normal(data, sid, p)
    point = p - n * dis[..., None]
    return point, torch.clamp(dis, min=0.0), out


def point_is_collision(data, p: Tensor, sid: Tensor = None, radius: float = 1.0) -> Tensor:
    """Spawn rejection test: True when closer than ``radius`` to any
    surface or outside the scene bounds. ``p (..., 3)``; ``sid`` broadcasts
    against its leading axes (scene 0 where it is None)."""
    if sid is None:
        sid = torch.zeros(p.shape[:-1], dtype=torch.long, device=p.device)
    return (sample_sdf(data, sid, p) < radius) | _outside_bbox(data, p)
