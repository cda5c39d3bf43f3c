"""Scene queries on packed primitive scenes (counterpart of the primitive
branches of ``visfly_tpu/scene/queries.py``): the SDF, its normal, the
closest-point collision query and the spawn-rejection point test.

Points are a flat batch ``p (N, 3)`` with per-point scene ids ``sid (N,)``.
The dense-grid and triangle-soup branches are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from .prim_scene import PrimitiveScene, scene_sdf_flat


def _require_prim(data) -> None:
    if not isinstance(data, PrimitiveScene):
        raise NotImplementedError(
            "grid and triangle-soup scene queries are ROADMAP Queue A item 18 "
            "(imported meshes)")


def _outside_bbox(data: PrimitiveScene, p: Tensor) -> Tensor:
    lo, hi = data.bbox[0], data.bbox[1]
    return torch.any(p < lo, dim=-1) | torch.any(p > hi, dim=-1)


def sample_sdf(data: PrimitiveScene, sid: Tensor, p: Tensor) -> Tensor:
    """Scene SDF at points p (N, 3) with scene ids sid (N,)."""
    _require_prim(data)
    return scene_sdf_flat(data, sid, p)


def sdf_normal(data: PrimitiveScene, sid: Tensor, p: Tensor) -> Tensor:
    """Outward unit normal: the autograd gradient of the SDF, the same
    method as ``jax.grad`` in the JAX package. Returns a tensor with no
    gradient history."""
    _require_prim(data)
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(sample_sdf(data, sid, q)), q)
    return g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-9)


def closest_point_query(data: PrimitiveScene, sid: Tensor, p: Tensor
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """(closest surface point, distance, out_of_bounds): point = p − n̂·sdf(p),
    with the distance clamped at 0 inside obstacles."""
    out = _outside_bbox(data, p)
    dis = sample_sdf(data, sid, p)
    n = sdf_normal(data, sid, p)
    point = p - n * dis[..., None]
    return point, torch.clamp(dis, min=0.0), out


def point_is_collision(data: PrimitiveScene, p: Tensor, sid: Tensor = None,
                       radius: float = 1.0) -> Tensor:
    """Spawn rejection test: True when closer than ``radius`` to any
    surface or outside the scene bounds."""
    if sid is None:
        sid = torch.zeros(p.shape[:-1], dtype=torch.long, device=p.device)
    return (sample_sdf(data, sid, p) < radius) | _outside_bbox(data, p)
