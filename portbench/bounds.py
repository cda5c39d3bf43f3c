"""The yardstick of the render's roofline: the chip's peaks, and the
operations and bytes a render of the cell's cameras needs, reckoned from
the rays, the scene's rows and the posed templates alone, never from the
program's own plan.

Operations follow ``chip_smoke.py``'s counts at commit
2b650bf71ac506a5b36a60b5e2300d8c3685e117 (its ``OPS`` and ``TRI_OPS``: a
division or square root counted as 8, comparisons and selects not at all):
a ray's closed form against a box row 66 and its origin terms 15, against a
capsule row 71 and 63 (origin terms once a tile, as a tile's rays share a
camera's origin), a sphere 25, a triangle test to its first gate 14
(Moeller-Trumbore). What a ray needs is what the frozen cull below leaves
it: per tile of 1,024 rays (whole image rows of one camera) the rows whose
bounds meet the tile's reach (its
rays to the camera's far depth) and that do not lie wholly outside one of
the four planes of the tile's wedge. A template's triangles are needed only
by the rays whose line meets its bounding sphere. Bytes: every input byte
read once and every output byte written once.
"""
from __future__ import annotations

import torch

PEAK_FP32_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
TILE = 1024
OPS = {"box_ray": 66, "box_origin": 15, "cap_ray": 71, "cap_origin": 63, "sphere_ray": 25,
       "tri_mt": 14}


def bound_s(ops, nbytes):
    """(seconds, "operations" or "bytes"): the least time on the chip."""
    by_ops, by_bytes = ops / PEAK_FP32_PER_S, nbytes / PEAK_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def tile_reach(o, d, max_depth):
    """Per tile: (lo, hi (tiles, 3)) bounds of every point its rays reach
    within ``max_depth``. o (tiles, 3) one origin a tile; d (tiles, 1024, 3)."""
    lo = o + max_depth * torch.clamp(d.amin(1), max=0.0)
    hi = o + max_depth * torch.clamp(d.amax(1), min=0.0)
    return lo, hi


def wedge_planes(d, img_w):
    """The four inward planes (tiles, 4, 3) through a tile's apex that bound
    its rays d (tiles, 1024, 3), whole image rows ``img_w`` wide."""
    corners = torch.stack([d[:, 0], d[:, img_w - 1], d[:, TILE - 1], d[:, TILE - img_w]], 1)
    planes = torch.linalg.cross(corners, torch.roll(corners, -1, dims=1))
    centre = corners.sum(1, keepdim=True)
    sign = torch.sign(torch.sum(planes * centre, -1, keepdim=True))
    return planes * torch.where(sign == 0, torch.ones_like(sign), sign)


def visible(points, o, d, img_w, max_depth, chunk=16):
    """(tiles, K) True where the convex hull of ``points`` (K, P, 3) may be
    seen by a tile: its bounds meet the tile's reach and not all its points
    lie outside one wedge plane."""
    lo, hi = tile_reach(o, d, max_depth)
    planes = wedge_planes(d, img_w)
    plo, phi = points.amin(1), points.amax(1)
    out = []
    for t0 in range(0, o.shape[0], chunk):
        sl = slice(t0, t0 + chunk)
        box = torch.all((lo[sl, None] <= phi[None]) & (hi[sl, None] >= plo[None]), -1)
        rel = points[None] - o[sl, None, None]  # (t, K, P, 3)
        dist = torch.einsum("tjc,tkpc->tjkp", planes[sl], rel)  # (t, 4, K, P)
        inside = torch.all(torch.any(dist >= 0.0, dim=-1), dim=1)
        out.append(box & inside)
    return torch.cat(out)


def sphere_rays(o, d, centre, radius):
    """(R,) True where the line of ray o, d (R, 3) meets the sphere ahead of o."""
    e = centre - o
    b = torch.sum(e * d, -1)
    disc = b * b - (torch.sum(e * e, -1) - radius * radius)
    return (disc > 0) & (b + torch.sqrt(torch.clamp(disc, min=0.0)) > 0)
