"""Depth rendering of packed primitive scenes (counterpart of the depth
branch of ``visfly_tpu/render/sphere_trace.py``).

Per sensor: component-major camera rays → analytic trace (the CUDA kernel
on the card, its plain version on the CPU) → planar depth
``where(hit, t·cos, max_depth)`` in the layout ``(N, 1, H, W)`` float32.
Colour and semantic sensors, the march trace mode, the residual refine and
mesh scenes are not ported yet and raise ``NotImplementedError``; so do
dynamic objects and sensor noise, at env construction.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor

from ..scene.prim_scene import PrimitiveScene
from .camera import CameraGeometry, camera_rays_components
from .trace_kernel import prepare_kernel_scene, trace_analytic

DEFAULT_MAX_DEPTH = 20.0  # background value


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


def render_camera(
    data: PrimitiveScene,
    pos: Tensor,
    q: Tensor,
    spec: Dict,
    num_scene: Optional[int] = None,
    geom: Optional[CameraGeometry] = None,
) -> Dict[str, Tensor]:
    """Render one depth sensor for N agents ordered scene-contiguously
    (scene id = agent // agents per scene). Returns
    ``{"depth": (N, 1, H, W)}``, background ``DEFAULT_MAX_DEPTH``."""
    stype = str(spec.get("sensor_type", spec.get("uuid", "depth"))).lower()
    if not isinstance(data, PrimitiveScene):
        raise _unported("rendering of grid and triangle scenes", "imported meshes")
    if stype != "depth":
        raise _unported(f"the {stype!r} sensor", "colour and semantic shading")
    if str(spec.get("trace_mode", "analytic")) != "analytic":
        raise _unported("trace_mode='march'", "kernel B2, the sphere-trace march")
    if int(spec.get("analytic_refine", 0)) > 0:
        raise _unported("analytic_refine > 0", "kernel B1's residual refine")

    H, W = spec["resolution"]
    n = pos.shape[0]
    S = data.num_scene if num_scene is None else num_scene
    R = (n // S) * H * W
    o_c, d_c, cos_f = camera_rays_components(spec, pos, q, geom)
    o_full = o_c[:, :, None].expand(3, n, H * W).reshape(3, S, R)
    d_full = d_c.reshape(3, S, R).contiguous()
    t, hit = trace_analytic(prepare_kernel_scene(data), o_full, d_full, DEFAULT_MAX_DEPTH)
    depth = torch.where(hit.reshape(n, H, W), t.reshape(n, H, W) * cos_f.reshape(1, H, W),
                        DEFAULT_MAX_DEPTH)
    return {"depth": depth[:, None, :, :]}


def render_sensors(env, state) -> Dict[str, Tensor]:
    """Render every sensor in ``env.sensor_kwargs``, keyed by uuid."""
    if env.scene is None:
        return {}
    out: Dict[str, Tensor] = {}
    for spec, geom in zip(env.sensor_kwargs, env.cameras):
        res = render_camera(env.scene, state.dyn.pos, state.dyn.q, spec,
                            num_scene=env.num_scene, geom=geom)
        for k, v in res.items():
            out[spec.get("uuid", k)] = v
    return out
