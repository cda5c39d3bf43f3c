"""Camera model: per-agent sensor rays (counterpart of
``visfly_tpu/render/camera.py``).

ENU / z-up / body-x-forward. Sensor spec dict keys: ``uuid``,
``sensor_type``, ``resolution`` [H, W], ``position`` (body-frame offset),
``orientation`` (body-frame zyx euler offset, radians), ``hfov`` (degrees,
default 90). Depth is planar along the camera forward axis.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core import quaternion as quat
from ..core.math_utils import full_fp32_matmul


def pixel_dirs_body(spec: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """((H, W, 3) unit ray directions, (3,) forward axis) in the BODY frame,
    host-side numpy."""
    H, W = spec["resolution"]
    hfov = math.radians(float(spec.get("hfov", 90.0)))
    tan_h = math.tan(hfov / 2.0)
    tan_v = tan_h * H / W  # vertical fov from the aspect ratio

    u = np.linspace(-1.0, 1.0, W, endpoint=True) if W > 1 else np.zeros(1)
    v = np.linspace(1.0, -1.0, H, endpoint=True) if H > 1 else np.zeros(1)
    uu, vv = np.meshgrid(u * tan_h, v * tan_v, indexing="xy")

    forward = np.asarray([1.0, 0.0, 0.0])
    right = np.asarray([0.0, -1.0, 0.0])
    up = np.asarray([0.0, 0.0, 1.0])

    ori = spec.get("orientation")
    if ori is not None and np.any(np.asarray(ori) != 0):
        r, p, y = (float(a) for a in ori)
        cr, sr = np.cos(r), np.sin(r)
        cp, sp = np.cos(p), np.sin(p)
        cy, sy = np.cos(y), np.sin(y)
        rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
        rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
        rot = rz @ ry @ rx
        forward, right, up = rot @ forward, rot @ right, rot @ up

    dirs = forward[None, None] + uu[..., None] * right[None, None] + vv[..., None] * up[None, None]
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32), forward.astype(np.float32)


def tile_cones_body(spec: Dict, tile: int = 8):
    """Per-tile cone prepass geometry (host-side constants): the H×W pixel
    grid in (H/t)×(W/t) tiles → (tile_dirs (Ht·Wt, 3), the normalised mean
    pixel direction of each tile; tile_tan (Ht·Wt,), the tangent of the cone
    half-angle that holds every pixel ray of the tile), or (None, None) when
    the tile does not divide the image. A cone that marches with radius
    t·tanθ cannot overshoot the first hit of any of its pixel rays."""
    dirs, _f = pixel_dirs_body(spec)
    H, W = dirs.shape[:2]
    t = tile
    if H % t or W % t:
        return None, None
    tiles = dirs.reshape(H // t, t, W // t, t, 3).transpose(0, 2, 1, 3, 4)
    tiles = tiles.reshape(H // t, W // t, t * t, 3)
    center = tiles.mean(axis=2)
    center = center / np.linalg.norm(center, axis=-1, keepdims=True)
    cos = np.einsum("hwc,hwpc->hwp", center, tiles).min(axis=-1)
    cos = np.clip(cos, 1e-3, 1.0)
    tan = np.sqrt(1.0 - cos**2) / cos
    return center.reshape(-1, 3).astype(np.float32), tan.reshape(-1).astype(np.float32)


class CameraGeometry(NamedTuple):
    """Per-sensor constants on the device, built once per env."""

    dirs_body: Tensor  # (3, H·W) body-frame pixel directions
    cos_forward: Tensor  # (H·W,) ray length → planar depth
    offset: Optional[Tensor]  # (3,) body-frame camera offset, None when zero


def camera_geometry(spec: Dict, device=None) -> CameraGeometry:
    dirs_body, forward_body = pixel_dirs_body(spec)
    H, W = dirs_body.shape[:2]
    flat = dirs_body.reshape(H * W, 3)
    offset = np.asarray(spec.get("position", [0.0, 0.0, 0.0]), np.float32)
    return CameraGeometry(
        dirs_body=torch.as_tensor(np.ascontiguousarray(flat.T), device=device),
        cos_forward=torch.as_tensor(flat @ forward_body, device=device),
        offset=torch.as_tensor(offset, device=device) if np.any(offset != 0) else None,
    )


def camera_rays_components(spec: Dict, pos: Tensor, q: Tensor,
                           geom: Optional[CameraGeometry] = None
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Component-major rays: (origins (3, N), dirs (3, N, H·W),
    cos_forward (H·W,)). The directions are one batched matmul
    ``R (N,3,3) @ dirs_body (3, H·W)``, in full float32."""
    if geom is None:
        geom = camera_geometry(spec, pos.device)
    if geom.offset is not None:
        origins = pos + quat.rotate_fused(q, geom.offset.to(pos.dtype).expand_as(pos))
    else:
        origins = pos
    full_fp32_matmul()
    rot = quat.to_rotation_matrix(q)  # (N, 3, 3)
    dirs = torch.einsum("nck,kp->cnp", rot, geom.dirs_body.to(rot.dtype))
    return origins.T, dirs, geom.cos_forward


def camera_rays(spec: Dict, pos: Tensor, q: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Point-major rays for the packed trace: (origins (N, 3), dirs
    (N, H, W, 3), cos_forward (N, H, W))."""
    dirs_body, forward_body = pixel_dirs_body(spec)
    H, W = dirs_body.shape[:2]
    n = pos.shape[0]
    offset = torch.as_tensor(np.asarray(spec.get("position", [0.0, 0.0, 0.0]), np.float32),
                             device=pos.device)
    origins = pos + quat.rotate_fused(q, offset.to(pos.dtype).expand_as(pos))
    db = torch.as_tensor(dirs_body.reshape(1, H * W, 3), device=pos.device)
    dirs = quat.rotate_fused(q[:, None, :], db.expand(n, H * W, 3))
    cos_f = torch.as_tensor(dirs_body.reshape(H * W, 3) @ forward_body, device=pos.device)
    return origins, dirs.reshape(n, H, W, 3), cos_f.reshape(1, H, W).expand(n, H, W)
