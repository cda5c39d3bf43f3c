# Frozen copy of visfly_tpu_torch/core/quaternion.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
"""Batched quaternion algebra on ``(..., 4)`` tensors ``[w, x, y, z]``.

Counterpart of ``visfly_tpu/core/quaternion.py``: Hamilton product,
scalar-first, rotation of v by unit q is ``q ⊗ (0, v) ⊗ q*`` (world from
body). The expansions follow the JAX module term by term so that float64
rollouts agree to the last digits.
"""
from __future__ import annotations

import torch
from torch import Tensor


def identity(shape=(), dtype=torch.float32, device=None) -> Tensor:
    """Unit quaternion(s) ``[1, 0, 0, 0]`` with the given batch shape."""
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def mul(q: Tensor, p: Tensor) -> Tensor:
    """Hamilton product q ⊗ p."""
    qw, qx, qy, qz = q.unbind(-1)
    pw, px, py, pz = p.unbind(-1)
    return torch.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        dim=-1,
    )


def conjugate(q: Tensor) -> Tensor:
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def norm(q: Tensor) -> Tensor:
    return torch.linalg.vector_norm(q, dim=-1)


def normalize(q: Tensor) -> Tensor:
    return q / norm(q)[..., None]


def _pure(v: Tensor) -> Tensor:
    return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)


def rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v (..., 3) into the world frame: q ⊗ (0,v) ⊗ q*."""
    return mul(mul(q, _pure(v)), conjugate(q))[..., 1:]


def rotate_fused(q: Tensor, v: Tensor) -> Tensor:
    """Rodrigues-style rotation (fewer flops, different last-ulp rounding
    than :func:`rotate`)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def inv_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) into the body frame: q* ⊗ (0,v) ⊗ q."""
    return mul(mul(conjugate(q), _pure(v)), q)[..., 1:]


def to_rotation_matrix(q: Tensor) -> Tensor:
    """(..., 3, 3) world-from-body rotation matrix."""
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def x_axis(q: Tensor) -> Tensor:
    """Body x-axis in the world frame (the drone's forward direction)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w)],
        dim=-1,
    )


def xz_axis(q: Tensor) -> Tensor:
    """(..., 2, 3) stacked body x and z axes in the world frame. The first
    row is the rotation matrix's row [R00, R01, R02], not its x column: the
    reference's formula, kept for parity."""
    w, x, y, z = q.unbind(-1)
    row_x = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                        dim=-1)
    row_z = torch.stack([2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y)],
                        dim=-1)
    return torch.stack([row_x, row_z], dim=-2)


def to_euler(q: Tensor, order: str = "zyx") -> Tensor:
    """(..., 3) [roll, pitch, yaw]."""
    w, x, y, z = q.unbind(-1)
    if order == "zyx":
        roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
        yaw_ = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    elif order == "xyz":
        roll = torch.atan2(2 * (w * y - x * z), 1 - 2 * (x * x + y * y))
        pitch = torch.asin(torch.clamp(2 * (w * z - y * x), -1.0, 1.0))
        yaw_ = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + z * z))
    else:
        raise ValueError(f"unknown euler order {order!r}")
    return torch.stack([roll, pitch, yaw_], dim=-1)


def yaw(q: Tensor) -> Tensor:
    """Heading angle about world z."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def from_euler(roll: Tensor, pitch: Tensor, yaw_: Tensor, order: str = "zyx") -> Tensor:
    """Quaternion(s) from euler angles."""
    cy, sy = torch.cos(yaw_ * 0.5), torch.sin(yaw_ * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    if order == "zyx":
        w = cr * cp * cy + sr * sp * sy
        x = sr * cp * cy - cr * sp * sy
        y = cr * sp * cy + sr * cp * sy
        z = cr * cp * sy - sr * sp * cy
    elif order == "xyz":
        w = cr * cp * cy - sr * sp * sy
        x = sr * cp * cy + cr * sp * sy
        y = cr * sp * cy - sr * cp * sy
        z = cr * cp * sy + sr * sp * cy
    else:
        raise ValueError(f"unknown euler order {order!r}")
    return torch.stack([w, x, y, z], dim=-1)


def extract_yaw_only(q: Tensor) -> Tensor:
    """The quaternion of q's yaw alone."""
    half = yaw(q) * 0.5
    w, z = torch.cos(half), torch.sin(half)
    zeros = torch.zeros_like(w)
    return torch.stack([w, zeros, zeros, z], dim=-1)


def world_to_head(q: Tensor, v: Tensor) -> Tensor:
    """A world vector in the heading (yaw-only) frame."""
    return inv_rotate(extract_yaw_only(q), v)


def local_to_head(q: Tensor, v: Tensor) -> Tensor:
    """A body vector in the heading frame: body → world → heading."""
    return world_to_head(q, rotate(q, v))


def extract_pitch_roll(q: Tensor) -> Tensor:
    """The quaternion of q's pitch and roll alone."""
    w, x, y, z = q.unbind(-1)
    pitch = torch.atan2(2 * (w * y + x * z), 1 - 2 * (x * x + z * z))
    roll = torch.atan2(2 * (w * x - y * z), 1 - 2 * (y * y + z * z))
    hp, hr = pitch / 2, roll / 2
    return torch.stack([torch.cos(hp) * torch.cos(hr), torch.sin(hr) * torch.cos(hp),
                        torch.sin(hp) * torch.cos(hr), torch.sin(hp) * torch.sin(hr)], dim=-1)


def omega_derivative(q: Tensor, omega: Tensor) -> Tensor:
    """Quaternion kinematics dq/dt = 0.5 · q ⊗ (0, ω_body)."""
    return 0.5 * mul(q, _pure(omega))
