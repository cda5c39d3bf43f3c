"""Plain PyTorch geometry of the reference: camera rays, first hits against
triangles and primitives, closest points. Written for the
benchmark; it imports nothing of the program. Every function runs in the
dtype of its inputs, so that the control can run it a precision lower.

The camera model is a frozen copy of ``pixel_dirs_body`` of
``visfly_tpu_torch/render/camera.py`` at commit
2b650bf71ac506a5b36a60b5e2300d8c3685e117: body x forward, y left, z up,
rows top to bottom, a planar depth along the forward axis.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .frozen.core import quaternion as quat

BIG = 1e9
MAX_DEPTH = 20.0  # the cameras' background depth


def pixel_dirs_body(spec):
    """((H·W, 3) unit ray directions, (3,) forward axis) in the body frame."""
    H, W = spec["resolution"]
    tan_h = math.tan(math.radians(float(spec.get("hfov", 90.0))) / 2.0)
    tan_v = tan_h * H / W
    u = np.linspace(-1.0, 1.0, W, endpoint=True) if W > 1 else np.zeros(1)
    v = np.linspace(1.0, -1.0, H, endpoint=True) if H > 1 else np.zeros(1)
    uu, vv = np.meshgrid(u * tan_h, v * tan_v, indexing="xy")
    forward, right, up = np.asarray([1.0, 0, 0]), np.asarray([0, -1.0, 0]), np.asarray([0, 0, 1.0])
    dirs = forward[None, None] + uu[..., None] * right + vv[..., None] * up
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.reshape(H * W, 3).astype(np.float32), forward.astype(np.float32)


def camera_rays(spec, pos, q):
    """Rays of the cameras at ``pos`` (n, 3), ``q`` (n, 4): (origins (n, 3),
    dirs (n, H·W, 3), cos_forward (H·W,)) in the dtype of ``pos``."""
    if any(float(x) != 0.0 for x in spec.get("position", [0.0, 0.0, 0.0])):
        raise NotImplementedError("camera offsets: no configuration uses one")
    if spec.get("orientation") is not None and np.any(np.asarray(spec["orientation"]) != 0):
        raise NotImplementedError("camera orientation offsets: no configuration uses one")
    body, fwd = pixel_dirs_body(spec)
    b = torch.as_tensor(body, device=pos.device).to(torch.float64)
    rot = quat.to_rotation_matrix(q.to(torch.float64))  # (n, 3, 3)
    dirs = torch.einsum("nij,pj->npi", rot, b).to(pos.dtype)
    cos_f = (b @ torch.as_tensor(fwd, device=pos.device).to(torch.float64)).to(pos.dtype)
    return pos, dirs, cos_f


def ray_triangles(tris, o, d, max_depth=MAX_DEPTH, elems=1 << 24):
    """First hit of rays o, d (R, 3) against triangles (T, 9), both faces,
    Moeller-Trumbore, t > 1e-4 → t (R,), BIG where none."""
    R, T = o.shape[0], tris.shape[0]
    best = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    slab = max(1, min(T, elems // max(R, 1)))
    for k0 in range(0, T, slab):
        rows = tris[k0:k0 + slab].to(o.dtype)
        a = rows[None, :, 0:3]
        e1 = rows[None, :, 3:6] - a
        e2 = rows[None, :, 6:9] - a
        dd = d[:, None, :]
        p = torch.linalg.cross(dd.expand(-1, rows.shape[0], -1), e2.expand(R, -1, -1))
        det = torch.sum(e1 * p, -1)
        ok = det.abs() > 1e-12
        inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), 0.0)
        s = o[:, None, :] - a
        u = torch.sum(s * p, -1) * inv
        qv = torch.linalg.cross(s, e1.expand(R, -1, -1))
        v = torch.sum(dd * qv, -1) * inv
        t = torch.sum(e2 * qv, -1) * inv
        ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4) & (t < max_depth)
        best = torch.minimum(best, torch.where(ok, t, BIG).amin(dim=1))
    return best


def room_exit(lo, hi, o, d):
    """Distance along d (R, 3) from o (R, 3) inside the box [lo, hi] to its
    walls; 0 where o lies outside."""
    inv = 1.0 / torch.where(d.abs() < 1e-9, torch.where(d >= 0, 1e-9, -1e-9).to(d.dtype), d)
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    near = torch.amax(torch.minimum(t1, t2), -1)
    far = torch.amin(torch.maximum(t1, t2), -1)
    return torch.where(near <= 0, torch.clamp(far, min=0.0), torch.zeros_like(far))


def capsule_hit(a, b, r, o, d):
    """First hit t (R,) of rays o, d (R, 3) on the capsule a-b of radius r;
    0 where the origin lies within r + 5 cm of the axis, BIG on a miss."""
    ba = b - a
    oa = o - a
    baba = torch.sum(ba * ba)
    h = torch.clamp(torch.sum(oa * ba, -1) / (baba + 1e-9), 0.0, 1.0)
    axis_d = torch.linalg.vector_norm(oa - ba * h[:, None], dim=-1)
    bard = torch.sum(d * ba, -1)
    baoa = torch.sum(oa * ba, -1)
    A = baba - bard * bard
    B = baba * torch.sum(d * oa, -1) - baoa * bard
    C = baba * torch.sum(oa * oa, -1) - baoa * baoa - r * r * baba
    disc = B * B - A * C
    t = (-B - torch.sqrt(torch.clamp(disc, min=0.0))) / torch.clamp(A, min=1e-9)
    y = baoa + t * bard
    best = torch.where((disc > 0) & (A > 1e-7) & (y >= 0) & (y <= baba) & (t >= 0), t, BIG)
    for e in (a, b):
        oc = o - e
        bb = torch.sum(oc * d, -1)
        cc = torch.sum(oc * oc, -1) - r * r
        dd = bb * bb - cc
        ti = -bb - torch.sqrt(torch.clamp(dd, min=0.0))
        best = torch.minimum(best, torch.where((dd > 0) & (ti >= 0), ti, BIG))
    return torch.where(axis_d <= r + 0.05, torch.zeros_like(best), best)


def capsule_closest(a, b, r, p):
    """(surface point (N, 3), signed distance (N,)) of points p on the capsule."""
    ba = b - a
    h = torch.clamp(torch.sum((p - a) * ba, -1) / (torch.sum(ba * ba) + 1e-9), 0.0, 1.0)
    c = a + ba * h[:, None]
    e = p - c
    n = torch.linalg.vector_norm(e, dim=-1)
    return c + e / torch.clamp(n, min=1e-12)[:, None] * r, n - r


def room_closest(lo, hi, p):
    """(wall point (N, 3), distance (N,)) of points p inside the box."""
    gaps = torch.cat([p - lo, hi - p], -1)  # (N, 6)
    dist, k = torch.min(gaps, -1)
    axis = k % 3
    wall = torch.where(k < 3, lo[axis], hi[axis])
    point = p.clone()
    point[torch.arange(p.shape[0], device=p.device), axis] = wall
    return point, dist
