"""Rendering of packed primitive scenes and of baked mesh scenes: depth,
colour and semantic cameras (counterpart of
``visfly_tpu/render/sphere_trace.py``).

Per sensor: camera rays → trace (a CUDA kernel on the card, its plain
version on the CPU; ``render/trace_kernel.py`` for primitive scenes,
``render/tri_trace.py`` for the exact triangles of a mesh scene) → planar
depth ``where(hit, t·cos, max_depth)``, or Lambert-shaded colour, or semantic
ids. Layouts: depth ``(N, 1, H, W)`` float32, colour ``(N, 3, H, W)`` uint8,
semantic ``(N, 1, H, W)`` uint8.

Sensor-spec keys beyond the camera's: ``trace_mode`` ("analytic", the
default: closed-form first hit; or "march": the sphere trace),
``analytic_refine`` (residual march steps after the analytic candidate),
``cull`` (march mode: each 1,024-ray tile marches over the rows whose bounds
meet it, as the JAX kernel does; default on), ``march_omega`` (over-relaxed
march), ``trace_steps_override`` and
``tile`` (> 1: one conservative cone per tile of pixels warm-starts the
per-pixel march, which then takes half the steps; march mode only).
``render_backend: "xla"`` takes the JAX package's XLA route instead
(:func:`trace_grouped`, plain PyTorch on either device, no kernel): the
march in ``render_dtype`` ("bfloat16" by default, "float32") with t in
float32 and a float32 residual step, or the closed-form candidate and
``analytic_refine`` march steps; objects without templates as spheres;
pixels shaded by the nearest primitive, object pixels too. Any other value,
or none, keeps the kernel route.

A mesh scene (``SceneData`` with triangles) renders its true triangles;
its sensor-spec keys are ``tri_cap`` (per-tile list length, default by mesh
size), ``tri_backface`` and ``tri_variant`` ("scalar", the default, "merged",
"mx" or "wl": how the per-camera tier of a dense mesh runs; nothing changes
where a mesh or a ray set does not reach that tier). Semantic ids come from
the baked grid at the exact hit, and so does colour, unless the scene
carries texture tables: then the winning triangle's texcoords, interpolated
at the hit's barycentrics and wrapped (glTF REPEAT), pick the nearest texel
of the scene's atlas. ``scene_kwargs["lighting"]["shadows"]`` casts one
shadow ray a light from each exact hit (:func:`shadow_visibility`, an
any-hit test against every triangle, chunked over rays and triangles; plain
PyTorch, as it is plain XLA in the JAX package). A grid scene without
triangles (``bake_scenes``), or a sensor with ``render_backend: "grid"``,
sphere-traces the trilinear SDF instead (:func:`trace_rays`, plain PyTorch)
and shades with the grid's normal.

Dynamic objects (``objects``: positions (S, M, 3), radii (S, M), colours
(S, M, 3)[, triangle templates (S, M, K, 9), attitudes (S, M, 4)]): without
templates they go into the kernel's scene as dynamic capsules; with
templates (drone bodies, ``model_path`` objects) the kernel traces the static
scene and each object's posed template is intersected after it
(:func:`_object_mesh_hits`, plain PyTorch, as it is plain XLA in the JAX
package), composed by the smaller t. On a mesh scene every object composes
after the triangle trace or the grid's sphere trace. Object pixels shade
with the object's colour and its hit normal, semantic id 255. A sensor's
noise model
(``random_kwargs["noise_kwargs"][uuid]``, ``render/noise.py``) applies after
the render, drawn from ``EnvState.gen``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import Tensor

from ..core import quaternion as quat
from ..scene.prim_scene import PrimitiveScene, prim_distances, prim_normal_single, prim_sdf
from ..scene.queries import sample_sdf, sdf_normal
from ..scene.scene import SceneData
from ..utils import profiling
from .camera import (CameraGeometry, camera_rays, camera_rays_components, tile_cones_body)
from .noise import apply_noise
from .trace_kernel import prepare_kernel_scene, trace_diff
from .tri_kernel import TILE
from .tri_trace import default_tri_cap, tri_trace_diff

DEFAULT_MAX_DEPTH = 20.0  # background value
BIG = 1e9
_LIGHT_DIR = (0.33798, 0.24142, 0.90966)  # normalised


# ---------------------------------------------------------------------------
# lighting and shading
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Lighting:
    """A baked lighting setup. ``shadows`` is a static flag, not a tensor: it
    selects code (shadow rays on the exact-triangle backend; the other
    backends ignore it)."""

    kind: Tensor  # (L,) 0 directional / 1 point
    vec: Tensor  # (L, 3) unit direction TO the light, or the light's position
    color: Tensor  # (L, 3) colour · intensity
    ambient: Tensor  # ()
    attenuation: Tensor  # () point lights: 1/(1 + a·d²)
    shadows: bool = False


def bake_lighting(cfg, device=None) -> Optional[Lighting]:
    """``scene_kwargs["lighting"]`` → :class:`Lighting`, or ``None`` when cfg
    is falsy (the default single fixed directional light):

        {"ambient": 0.35, "attenuation": 0.0, "lights": [
            {"type": "directional", "direction": [x, y, z],
             "color": [1, 1, 1], "intensity": 0.65},
            {"type": "point", "position": [x, y, z],
             "color": [1.0, 0.9, 0.8], "intensity": 2.0}]}
    """
    if not cfg:
        return None
    kind, vec, col = [], [], []
    for li in cfg.get("lights", ()):
        ty = str(li.get("type", "directional")).lower()
        c = np.asarray(li.get("color", [1.0, 1.0, 1.0]), np.float32)
        c = c * float(li.get("intensity", 1.0))
        if ty.startswith("dir"):
            d = np.asarray(li["direction"], np.float32)
            kind.append(0.0)
            vec.append(-d / max(float(np.linalg.norm(d)), 1e-9))  # surface → light
        elif ty == "point":
            kind.append(1.0)
            vec.append(np.asarray(li["position"], np.float32))
        else:
            raise ValueError(f"unknown light type {ty!r}")
        col.append(c)
    if not kind:  # ambient-only setup
        kind, vec, col = [0.0], [np.zeros(3, np.float32)], [np.zeros(3, np.float32)]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Lighting(t(kind), t(np.stack(vec)), t(np.stack(col)), t(cfg.get("ambient", 0.35)),
                    t(cfg.get("attenuation", 0.0)), bool(cfg.get("shadows", False)))


def lambert_shade(n: Tensor, p: Tensor, lighting: Optional[Lighting],
                  vis: Optional[Tensor] = None) -> Tensor:
    """Lambertian shade multiplier (..., 3) from normal ``n`` and hit point
    ``p`` (both (..., 3)). ``lighting=None`` is the fixed
    ``0.35 + 0.65·max(n·L, 0)`` single directional light. ``vis`` (..., L)
    in [0, 1] scales each light's diffuse term (shadow rays); the ambient
    term is never scaled."""
    if lighting is None:
        lam = torch.clamp(torch.sum(n * n.new_tensor(_LIGHT_DIR), dim=-1), min=0.0)
        return (0.35 + 0.65 * lam)[..., None].expand(*lam.shape, 3)
    kind, vec, col = lighting.kind, lighting.vec, lighting.color
    to = vec - p[..., None, :]  # (..., L, 3) towards a point light
    d2 = torch.sum(to * to, dim=-1)
    l_pt = to * torch.rsqrt(torch.clamp(d2, min=1e-12))[..., None]
    l = torch.where(kind[:, None] > 0.5, l_pt, vec)  # (..., L, 3)
    lam = torch.clamp(torch.sum(n[..., None, :] * l, dim=-1), min=0.0)  # (..., L)
    w = torch.where(kind > 0.5, 1.0 / (1.0 + lighting.attenuation * d2), 1.0)
    if vis is not None:
        w = w * vis
    return lighting.ambient + torch.sum((lam * w)[..., None] * col, dim=-2)


def shadow_visibility(tri: Tensor, p: Tensor, nrm: Tensor, lighting: Lighting,
                      slab: int = 512, chunk_elems: int = 1 << 22) -> Tensor:
    """Each light's visibility from surface points: one any-hit shadow ray
    a (point, light), from ``p + 1e-3·n`` toward the light, blocked where
    any triangle meets it past 1e-3 and, for a point light, before the
    light. tri (S, T, 9), p and nrm (S, R, 3) → vis (S, R, L) of 0 or 1.

    Möller–Trumbore against every triangle, over chunks of rays and slabs
    of ``slab`` triangles, so that no intermediate holds more than about
    ``chunk_elems`` (point, light, triangle) tests (the JAX package scans
    the slabs with every ray at once, (S, R, L, slab, 3)). The chunks change
    nothing but memory: a ray is blocked where any test of any slab hits."""
    kind, vec = lighting.kind, lighting.vec
    S, R, L = p.shape[0], p.shape[1], kind.shape[0]
    T = tri.shape[1]
    slab = max(1, min(slab, T))
    rc = max(1, min(R, chunk_elems // (S * L * slab)))
    out = torch.empty((S, R, L), dtype=p.dtype, device=p.device)
    for r0 in range(0, R, rc):
        pc, nc = p[:, r0:r0 + rc], nrm[:, r0:r0 + rc]
        to = vec - pc[:, :, None, :]  # (S, r, L, 3)
        dist = torch.sqrt(torch.clamp(torch.sum(to * to, dim=-1), min=1e-12))
        ldir = torch.where(kind[:, None] > 0.5, to / dist[..., None], vec.expand_as(to))
        tmax = torch.where(kind > 0.5, dist, BIG)[..., None]  # (S, r, L, 1)
        o = (pc + 1e-3 * nc)[:, :, None, None, :]  # (S, r, 1, 1, 3)
        d5 = ldir[:, :, :, None, :]  # (S, r, L, 1, 3)
        occ = torch.zeros(ldir.shape[:3], dtype=torch.bool, device=p.device)
        for t0 in range(0, T, slab):
            tr = tri[:, t0:t0 + slab]
            a = tr[:, None, None, :, 0:3]  # (S, 1, 1, slab, 3)
            e1 = tr[:, None, None, :, 3:6] - a
            e2 = tr[:, None, None, :, 6:9] - a
            pv = torch.linalg.cross(d5, e2)
            det = torch.sum(e1 * pv, dim=-1)  # (S, r, L, slab)
            valid = torch.abs(det) > 1e-12
            inv = 1.0 / torch.where(valid, det, 1.0)
            tv = o - a
            u = torch.sum(tv * pv, dim=-1) * inv
            qv = torch.linalg.cross(tv, e1)
            v = torch.sum(d5 * qv, dim=-1) * inv
            t = torch.sum(e2 * qv, dim=-1) * inv
            hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-3) & (t < tmax)
            occ |= torch.any(hit, dim=-1)
        out[:, r0:r0 + rc] = torch.where(occ, 0.0, 1.0)
    return out


def _shade_rows(scene: PrimitiveScene, p_hit: Tensor, hit: Tensor, k: Tensor, dyn_px,
                want: str, lighting) -> Tensor:
    """Shade hit points with the tables' rows ``k (S, R)`` int64: a gather
    where the JAX package multiplies by a one-hot matrix. ``dyn_px`` marks
    pixels of dynamic objects, which have no row: grey 110 × 0.75, semantic
    255."""
    if want == "semantic":
        sem = torch.gather(scene.semantic, 1, k).to(p_hit.dtype)
        if dyn_px is not None:
            sem = torch.where(dyn_px, 255.0, sem)
        return torch.where(hit, sem, 0.0)
    albedo = torch.gather(scene.colors, 1, k[..., None].expand(*k.shape, 3))
    prow = torch.gather(scene.params, 1, k[..., None].expand(*k.shape, 12))
    # the normal of the winning primitive only: the scene SDF is a hard min,
    # so its gradient is that primitive's
    shade = lambert_shade(prim_normal_single(prow, p_hit), p_hit, lighting)
    if dyn_px is not None:
        albedo = torch.where(dyn_px[..., None], 110.0, albedo)
        shade = torch.where(dyn_px[..., None], 0.75, shade)
    return torch.where(hit[..., None], albedo * shade, 0.0)


def _shade_primitive(scene: PrimitiveScene, p_hit: Tensor, hit: Tensor, want: str,
                     lighting=None) -> Tensor:
    """Colour (S, R, 3) or semantic (S, R) of hit points p_hit (S, R, 3), by
    the nearest primitive at each point (an all-K distance pass)."""
    k = torch.argmin(prim_distances(scene.params[:, None], p_hit), dim=-1)
    return _shade_rows(scene, p_hit, hit, k, None, want, lighting)


def _shade_primitive_indexed(scene: PrimitiveScene, p_hit: Tensor, hit: Tensor, kid: Tensor,
                             want: str, lighting=None) -> Tensor:
    """Shading when the trace reported the winning primitive ``kid (S, R)``
    (float32, −1 = none): no distance pass. A hit pixel with kid −1 belongs
    to a dynamic object."""
    k = kid.to(torch.int64)
    return _shade_rows(scene, p_hit, hit, torch.clamp(k, min=0), k < 0, want, lighting)


# ---------------------------------------------------------------------------
# the scene SDF and the cone prepass (plain PyTorch, as they are plain XLA in
# the JAX package)
# ---------------------------------------------------------------------------


def _scene_sdf_fn(params: Tensor, obj_pos: Optional[Tensor], obj_radius: Optional[Tensor],
                  origins: Optional[Tensor] = None):
    """One scene's SDF, points (R, 3) → (R,): the rows ``params`` (K, 12)
    and the objects as spheres. Where ``origins`` (R, 3) is given, an object
    within its radius + 0.05 of a ray's origin is left out for that ray (a
    drone's own body does not occlude its camera)."""
    excl = None
    if obj_pos is not None and origins is not None:
        d0 = torch.linalg.vector_norm(origins[:, None, :] - obj_pos[None], dim=-1)
        excl = d0 <= obj_radius[None] + 0.05

    def sdf(p):
        d = prim_sdf(params, p)
        if obj_pos is not None:
            do = torch.linalg.vector_norm(p[:, None, :] - obj_pos[None], dim=-1) - obj_radius[None]
            if excl is not None:
                do = torch.where(excl, torch.full((), BIG, dtype=do.dtype, device=do.device), do)
            d = torch.minimum(d, torch.amin(do, dim=-1))
        return d

    return sdf


def _trace_cones_one_scene(params, origins, dirs, tan, obj_pos, obj_radius, n_steps: int,
                           max_depth: float, eps: float) -> Tensor:
    """Conservative cone march: advance while the SDF exceeds the cone radius
    t·tanθ; the returned t cannot overshoot the first hit of ANY pixel ray
    inside the cone. The damped step (÷(1 + tanθ)) keeps that between
    samples for off-axis rays. origins/dirs (T, 3), tan (T,) → (T,)."""
    sdf = _scene_sdf_fn(params, obj_pos, obj_radius, origins)
    damp = 1.0 / (1.0 + tan)
    t = torch.zeros_like(tan)
    done = torch.zeros_like(tan, dtype=torch.bool)
    for _ in range(n_steps):
        margin = sdf(origins + dirs * t[:, None]) - t * tan
        done = done | (margin < eps) | (t >= max_depth)
        t = torch.where(done, t, t + margin * damp)
    return torch.clamp(t - 2.0 * eps, min=0.0)


def trace_cones_grouped(scene: PrimitiveScene, origins: Tensor, dirs: Tensor, tan: Tensor,
                        objects=None, n_steps: int = 32,
                        max_depth: float = DEFAULT_MAX_DEPTH) -> Tensor:
    """origins/dirs (S, T, 3), tan (S, T) → cone depths (S, T)."""
    eps = float(scene.eps)
    out = []
    for s in range(origins.shape[0]):
        op, orad = (None, None) if objects is None else (objects[0][s], objects[1][s])
        out.append(_trace_cones_one_scene(scene.params[s], origins[s], dirs[s], tan[s], op,
                                          orad, n_steps, max_depth, eps))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# the XLA route: the scene SDF traced in plain PyTorch (``render_backend:
# "xla"``; plain XLA in the JAX package), on either device
# ---------------------------------------------------------------------------


def _analytic_t0(params: Tensor, o: Tensor, d: Tensor, obj_pos: Optional[Tensor],
                 obj_radius: Optional[Tensor], max_depth: float, eps: float = 0.0) -> Tensor:
    """The closed-form first hit (R,) of rays o/d (R, 3) against one scene's
    rows (K, 12) and object spheres, min-reduced: slab tests for yaw-rotated
    boxes and inverted rooms, a quadratic for spheres, cylinder and cap
    quadratics for capsules. A general rounded box (half-extents and radius
    both non-zero, which no preset makes) takes the slab entry of the
    radius-inflated box, a lower bound the refine march converges from. An
    origin inside a solid gives 0, a miss ``max_depth``; ``eps`` dilates the
    solids (0 by default: exact)."""
    big = torch.full((), BIG, dtype=o.dtype, device=o.device)
    c, he, rad = params[:, 0:3], params[:, 3:6], params[:, 6]
    cy, sy = params[:, 7], params[:, 8]
    sign, fam, act = params[:, 9], params[:, 10], params[:, 11]

    # family 0 in the box's yaw frame, (R, K)
    rx = o[:, None, 0] - c[None, :, 0]
    ry = o[:, None, 1] - c[None, :, 1]
    px = cy * rx + sy * ry
    py = -sy * rx + cy * ry
    pz = o[:, None, 2] - c[None, :, 2]
    vx = cy * d[:, None, 0] + sy * d[:, None, 1]
    vy = -sy * d[:, None, 0] + cy * d[:, None, 1]
    vz = d[:, None, 2].expand_as(px)

    def slab(p, v, h):
        safe = torch.where(torch.abs(v) < 1e-9, torch.where(v >= 0, 1e-9, -1e-9), v)
        t1 = (-h - p) / safe
        t2 = (h - p) / safe
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    def box(h):
        n1, f1 = slab(px, vx, h[None, :, 0])
        n2, f2 = slab(py, vy, h[None, :, 1])
        n3, f3 = slab(pz, vz, h[None, :, 2])
        return (torch.maximum(n1, torch.maximum(n2, n3)),
                torch.minimum(f1, torch.minimum(f2, f3)))

    tn, tf = box(he + (rad[:, None] + eps))  # radius- and eps-inflated halves
    t_solid = torch.where((tn <= tf) & (tf > 0.0), torch.clamp(tn, min=0.0), big)
    # inverted room: from inside, the exit of the radius-inflated box; an
    # origin outside lies in the solid complement
    tnr, tfr = box(he + rad[:, None])
    t_room = torch.where(tnr <= 0.0, torch.clamp(tfr, min=0.0), 0.0)

    # sphere (he = 0): exact quadratic
    oc = o[:, None, :] - c[None]
    b_s = torch.sum(oc * d[:, None, :], dim=-1)
    c_s = torch.sum(oc * oc, dim=-1) - (rad[None] + eps) ** 2
    disc = b_s * b_s - c_s
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_in, t_out = -b_s - sq, -b_s + sq
    t_sphere = torch.where(disc > 0.0,
                           torch.where(t_in >= 0.0, t_in, torch.where(t_out > 0.0, 0.0, big)), big)
    is_sphere = (torch.sum(he, dim=-1) < 1e-6)[None]
    t_fam0 = torch.where(sign[None] < 0.0, t_room, torch.where(is_sphere, t_sphere, t_solid))

    # family 1: capsule = cylinder body and two cap spheres
    a, bp = params[:, 0:3], params[:, 3:6]
    ba = bp - a  # (K, 3)
    oa = o[:, None, :] - a[None]  # (R, K, 3)
    baba = torch.sum(ba * ba, dim=-1)[None]
    bard = torch.sum(ba[None] * d[:, None, :], dim=-1)
    baoa = torch.sum(ba[None] * oa, dim=-1)
    rdoa = torch.sum(d[:, None, :] * oa, dim=-1)
    oaoa = torch.sum(oa * oa, dim=-1)
    re_ = rad[None] + eps
    A = baba - bard * bard
    B = baba * rdoa - baoa * bard
    Cq = baba * oaoa - baoa * baoa - re_ ** 2 * baba
    hq = B * B - A * Cq
    t_cyl = (-B - torch.sqrt(torch.clamp(hq, min=0.0))) / torch.clamp(A, min=1e-9)
    ycyl = baoa + t_cyl * bard
    cyl_ok = (hq > 0.0) & (A > 1e-7) & (ycyl >= 0.0) & (ycyl <= baba) & (t_cyl >= 0.0)

    def cap_sphere(center):
        occ = o[:, None, :] - center[None]
        bb = torch.sum(occ * d[:, None, :], dim=-1)
        cc = torch.sum(occ * occ, dim=-1) - re_ ** 2
        dd = bb * bb - cc
        ti = -bb - torch.sqrt(torch.clamp(dd, min=0.0))
        return torch.where((dd > 0.0) & (ti >= 0.0), ti, big)

    t_cap = torch.minimum(torch.where(cyl_ok, t_cyl, big),
                          torch.minimum(cap_sphere(a), cap_sphere(bp)))
    # an origin inside a capsule: hit at t = 0, as the march has it
    h0 = torch.clamp(baoa / torch.clamp(baba, min=1e-9), 0.0, 1.0)
    e0 = oa - ba[None] * h0[..., None]
    t_cap = torch.where(torch.sum(e0 * e0, dim=-1) <= re_ ** 2, 0.0, t_cap)

    t_prim = torch.where(fam[None] < 0.5, t_fam0, t_cap)
    t_prim = torch.where(act[None] > 0.5, t_prim, big)
    t0 = torch.amin(t_prim, dim=-1)

    # objects: spheres, left out where they hold the ray's origin
    if obj_pos is not None:
        oco = o[:, None, :] - obj_pos[None]
        bo = torch.sum(oco * d[:, None, :], dim=-1)
        oo = torch.sum(oco * oco, dim=-1)
        do = bo * bo - (oo - (obj_radius[None] + eps) ** 2)
        tio = -bo - torch.sqrt(torch.clamp(do, min=0.0))
        excl = oo <= (obj_radius[None] + 0.05) ** 2
        t_obj = torch.where((do > 0.0) & (tio >= 0.0) & ~excl, tio, big)
        t0 = torch.minimum(t0, torch.amin(t_obj, dim=-1))
    return torch.clamp(t0, 0.0, max_depth)


def _trace_one_scene(params: Tensor, origins: Tensor, dirs: Tensor, obj_pos: Optional[Tensor],
                     obj_radius: Optional[Tensor], n_steps: int, max_depth: float, eps: float,
                     t_init: Tensor, compute_dtype: torch.dtype = torch.bfloat16):
    """R rays (origins, dirs (R, 3)) against one scene from ``t_init`` (R,):
    ``n_steps`` march steps whose distances are evaluated in
    ``compute_dtype`` while t accumulates in float32, then one residual step
    in float32. A ray that runs out of steps reports its marched t (a lower
    bound of its depth) as a hit. → (t (R,), max_depth where it missed;
    hit (R,))."""
    sdf_f32 = _scene_sdf_fn(params, obj_pos, obj_radius, origins)
    if compute_dtype == torch.float32:
        sdf_march = sdf_f32
    else:
        cast = (lambda x: None if x is None else x.to(compute_dtype))  # noqa: E731
        sdf_c = _scene_sdf_fn(cast(params), cast(obj_pos), cast(obj_radius),
                              None if obj_pos is None else cast(origins))
        sdf_march = lambda p: sdf_c(p.to(compute_dtype)).to(torch.float32)  # noqa: E731
    t = t_init.to(origins.dtype)
    done = torch.zeros(origins.shape[0], dtype=torch.bool, device=origins.device)
    for _ in range(n_steps):
        d = sdf_march(origins + dirs * t[:, None])
        done = done | (d < eps) | (t >= max_depth)
        t = torch.where(done, t, t + d)
    t = torch.clamp(t + sdf_f32(origins + dirs * t[:, None]), 0.0, max_depth)
    hit = t < max_depth
    return torch.where(hit, t, max_depth), hit


def trace_grouped(scene: PrimitiveScene, origins: Tensor, dirs: Tensor, objects=None,
                  n_steps: int = 40, max_depth: float = DEFAULT_MAX_DEPTH,
                  t_init: Optional[Tensor] = None, compute_dtype=torch.bfloat16,
                  mode: str = "march", refine_steps: int = 0):
    """The XLA route's trace, plain PyTorch on either device (no kernel):
    rays origins/dirs (S, R, 3) against each scene's rows and its objects
    ((positions (S, M, 3), radii (S, M), ...) or None) as spheres, one scene
    at a time. ``mode="march"``: :func:`_trace_one_scene` from ``t_init``
    (S, R) (zeros where None) in ``compute_dtype`` (a torch dtype or its
    name; bfloat16 by default, its ulp absorbed by the march and the float32
    residual step). ``mode="analytic"``: the closed-form candidate
    (:func:`_analytic_t0`, detached: the gradient flows through the residual
    step at the hit) then ``refine_steps`` march steps, all in float32.
    → (t (S, R), max_depth where it missed; hit (S, R))."""
    eps = float(scene.eps)
    analytic = mode == "analytic"
    if analytic:
        n_steps, compute_dtype = refine_steps, torch.float32
    elif isinstance(compute_dtype, str):
        compute_dtype = getattr(torch, compute_dtype)
    if t_init is None:
        t_init = torch.zeros(origins.shape[:2], dtype=origins.dtype, device=origins.device)
    ts, hits = [], []
    for s in range(origins.shape[0]):
        op, orad = (None, None) if objects is None else (objects[0][s], objects[1][s])
        prm, o, d = scene.params[s], origins[s], dirs[s]
        if analytic:
            with torch.no_grad():
                t0 = _analytic_t0(prm, o, d, op, orad, max_depth)
        else:
            t0 = t_init[s]
        t, hit = _trace_one_scene(prm, o, d, op, orad, n_steps, max_depth, eps, t0, compute_dtype)
        ts.append(t)
        hits.append(hit)
    return torch.stack(ts), torch.stack(hits)


# ---------------------------------------------------------------------------
# dynamic objects, composed after the trace (plain PyTorch)
# ---------------------------------------------------------------------------


def _sphere_candidates(c: Tensor, r: Tensor, o: Tensor, d: Tensor, max_depth: float):
    """Each scene's sphere (centre ``c`` (S, 3), radius ``r`` (S,)) against
    rays o/d (S, R, 3): (t (S, R), BIG where no hit; whether each ray's
    origin lies outside the sphere; the hit normal (S, R, 3)). A sphere that
    holds a ray's origin is invisible to that ray."""
    e = c[:, None] - o
    b = torch.sum(e * d, dim=-1)
    ee = torch.sum(e * e, dim=-1)
    rr = (r * r)[:, None]
    disc = b * b - (ee - rr)
    ts = b - torch.sqrt(torch.clamp(disc, min=0.0))
    outside = ee > rr
    ok = (disc > 0.0) & (ts > 1e-4) & outside & (r[:, None] > 1e-6) & (ts < max_depth)
    ts = torch.where(ok, ts, BIG)
    n = (o + d * ts[..., None] - c[:, None]) / torch.clamp(r[:, None, None], min=1e-9)
    return ts, outside, n


def _object_colors(objects, like: Tensor) -> Tensor:
    if len(objects) > 2 and objects[2] is not None:
        return objects[2].to(like.dtype)
    return torch.full(objects[0].shape, 110.0, dtype=like.dtype, device=like.device)


def _object_sphere_hits(objects, o: Tensor, d: Tensor, max_depth: float):
    """Nearest object-sphere hit per ray (o/d (S, R, 3)), one object at a
    time: (t (S, R), BIG where none; hit (S, R); normal (S, R, 3); the
    winning object's colour (S, R, 3), 0 where none)."""
    obj_pos, obj_radius = objects[0], objects[1]
    obj_color = _object_colors(objects, o)
    t = torch.full(o.shape[:2], BIG, dtype=o.dtype, device=o.device)
    n = torch.zeros_like(o)
    col = torch.zeros_like(o)
    for m in range(obj_pos.shape[1]):
        tm, _outside, nm = _sphere_candidates(obj_pos[:, m], obj_radius[:, m], o, d, max_depth)
        better = (tm < t)[..., None]
        n = torch.where(better, nm, n)
        col = torch.where(better, obj_color[:, m, None], col)
        t = torch.minimum(t, tm)
    return t, t < max_depth, n, col


def _object_mesh_hits(objects, o: Tensor, d: Tensor, max_depth: float):
    """Nearest object hit per ray with each object's triangle template
    (``objects[3]`` (S, M, K, 9), zero rows pad) posed at its position and
    attitude (``objects[4]`` (S, M, 4), identity where absent), Möller–
    Trumbore against every triangle; an all-zero template falls back to the
    bounding sphere. A ray whose origin lies inside an object's bounding
    sphere ignores the object (a drone never sees its own body). One object
    at a time, so memory is O(S·R·K); returns what
    :func:`_object_sphere_hits` returns."""
    mesh = objects[3] if len(objects) > 3 else None
    if mesh is None:
        return _object_sphere_hits(objects, o, d, max_depth)
    obj_pos, obj_radius = objects[0], objects[1]
    obj_color = _object_colors(objects, o)
    S, M, K = mesh.shape[:3]
    q = objects[4] if len(objects) > 4 else None
    if q is None:
        q = quat.identity((S, M), o.dtype, o.device)
    rot = quat.to_rotation_matrix(q)  # (S, M, 3, 3)
    has_mesh = torch.any(torch.abs(mesh) > 0.0, dim=-1).any(dim=-1)  # (S, M)
    t = torch.full(o.shape[:2], BIG, dtype=o.dtype, device=o.device)
    n = torch.zeros_like(o)
    col = torch.zeros_like(o)
    od, dd = o[:, :, None], d[:, :, None]  # (S, R, 1, 3)
    tracing = profiling.tracing()
    for m in range(M):
        c = obj_pos[:, m]
        ts, outside, n_s = _sphere_candidates(c, obj_radius[:, m], o, d, max_depth)
        if tracing:
            # every ray is tested against every triangle; the candidates are
            # the rays that meet the bounding sphere ahead, from outside it
            profiling.count("object_hits.tests", S * o.shape[1] * K)
            profiling.count("object_hits.candidate_tests", (ts < BIG).sum() * K)
        # the posed template: world vertices (S, K, 3, 3)
        v_l = mesh[:, m].reshape(S, K * 3, 3)
        v_w = torch.sum(rot[:, m, None] * v_l[:, :, None, :], dim=-1) + c[:, None]
        tri = v_w.reshape(S, K, 3, 3)
        a_ = tri[:, :, 0]
        e1 = tri[:, :, 1] - a_
        e2 = tri[:, :, 2] - a_
        h = torch.linalg.cross(dd, e2[:, None])  # (S, R, K, 3)
        det = torch.sum(e1[:, None] * h, dim=-1)
        valid = torch.abs(det) > 1e-12
        inv = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
        s_ = od - a_[:, None]
        u = torch.sum(s_ * h, dim=-1) * inv
        qv = torch.linalg.cross(s_, e1[:, None])
        v = torch.sum(dd * qv, dim=-1) * inv
        tk = torch.sum(e2[:, None] * qv, dim=-1) * inv
        ok = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tk > 1e-4) & (tk < max_depth)
        tk = torch.where(ok, tk, BIG)
        kid = torch.argmin(tk, dim=-1)  # (S, R)
        tm = torch.gather(tk, -1, kid[..., None])[..., 0]
        fn = torch.linalg.cross(e1, e2)
        fn = fn / torch.clamp(torch.linalg.vector_norm(fn, dim=-1, keepdim=True), min=1e-12)
        n_m = torch.gather(fn, 1, kid[..., None].expand(*kid.shape, 3))  # (S, R, 3)
        # the face normal turned toward the viewer (templates are soups)
        n_m = torch.where(torch.sum(n_m * d, dim=-1, keepdim=True) > 0, -n_m, n_m)
        mesh_m = has_mesh[:, m, None]
        tm = torch.where(outside & mesh_m, tm, BIG)
        t_obj = torch.where(mesh_m, tm, ts)
        n_obj = torch.where(mesh_m[..., None], n_m, n_s)
        better = (t_obj < t)[..., None]
        n = torch.where(better, n_obj, n)
        col = torch.where(better, obj_color[:, m, None], col)
        t = torch.minimum(t, t_obj)
    return t, t < max_depth, n, col


def _compose_objects(objects, o: Tensor, d: Tensor, t: Tensor, hit: Tensor, max_depth: float):
    """The object hits composed with a trace's (t, hit) (S, R) by the smaller
    t: (t, hit, object pixels, object normals, object colours)."""
    t_o, hit_o, n_o, c_o = _object_mesh_hits(objects, o, d, max_depth)
    obj_px = hit_o & (t_o < torch.where(hit, t, max_depth))
    return torch.where(obj_px, t_o, t), hit | obj_px, obj_px, n_o, c_o


def trace_rays(data, sid: Tensor, origins: Tensor, dirs: Tensor, n_steps: int = 48,
               max_depth: float = DEFAULT_MAX_DEPTH, hit_eps: Optional[float] = None):
    """Sphere trace of a flat batch of rays, origins and dirs (N, 3) with
    scene ids sid (N,), over either scene type: the analytic SDF of a
    ``PrimitiveScene`` (hit within its ``eps``) or the trilinear grid of a
    ``SceneData`` (hit within 0.3 cells, at least half a cell a step). A
    fixed ``n_steps``, then the SDF at the last point added once more; →
    (t (N,), max_depth where it missed; hit (N,))."""
    if isinstance(data, PrimitiveScene):
        eps = data.eps if hit_eps is None else hit_eps
        min_step = 0.0
    else:
        eps = data.spacing * 0.3 if hit_eps is None else hit_eps
        min_step = data.spacing * 0.5
    t = torch.zeros(origins.shape[0], dtype=origins.dtype, device=origins.device)
    done = torch.zeros(origins.shape[0], dtype=torch.bool, device=origins.device)
    for _ in range(n_steps):
        d = sample_sdf(data, sid, origins + dirs * t[:, None])
        done = done | (d < eps) | (t >= max_depth)
        t = torch.where(done, t, t + torch.clamp(d, min=min_step))
    t = torch.clamp(t + sample_sdf(data, sid, origins + dirs * t[:, None]), 0.0, max_depth)
    hit = t < max_depth
    return torch.where(hit, t, max_depth), hit


def _grid_cells(data: SceneData, sid: Tensor, p: Tensor) -> Tensor:
    """Flat index of the grid cell nearest each point p (N, 3) of scene
    sid (N,), into ``semantic.reshape(-1)`` and ``albedo.reshape(-1, 3)``."""
    X, Y, Z = data.sdf.shape[1:]
    g = torch.round((p - data.origin) / data.spacing).to(torch.int64)
    g = torch.minimum(torch.clamp(g, min=0), g.new_tensor([X - 1, Y - 1, Z - 1]))
    return ((sid * X + g[..., 0]) * Y + g[..., 1]) * Z + g[..., 2]


# ---------------------------------------------------------------------------
# camera rendering
# ---------------------------------------------------------------------------


def cone_warm_start(data, spec, tile, origins, q, S, objects, n_steps, max_depth):
    """Per-pixel warm starts (S, R) from one cone per ``tile``×``tile``
    pixels, or None when the tile does not divide the image."""
    H, W = spec["resolution"]
    n = origins.shape[0]
    tdirs_body, ttan = tile_cones_body(spec, tile)
    if tdirs_body is None:
        return None
    Tn = tdirs_body.shape[0]
    tb = torch.as_tensor(tdirs_body, device=origins.device).reshape(1, Tn, 3)
    tdirs = quat.rotate_fused(q[:, None, :], tb.expand(n, Tn, 3))
    to_g = origins[:, None, :].expand(n, Tn, 3).reshape(S, (n // S) * Tn, 3)
    tan_g = torch.as_tensor(ttan, device=origins.device)[None].expand(n, Tn)
    t_tile = trace_cones_grouped(data, to_g, tdirs.reshape(S, (n // S) * Tn, 3),
                                 tan_g.reshape(S, (n // S) * Tn), objects, n_steps, max_depth)
    t_tile = t_tile.reshape(n, H // tile, W // tile)
    t_px = t_tile.repeat_interleave(tile, dim=1).repeat_interleave(tile, dim=2)
    return t_px.reshape(S, n // S * H * W).contiguous()


def _texture_albedo(data: SceneData, gid: Tensor, p: Tensor) -> Tensor:
    """Textured albedo (S·R, 3) float32 of the hits p (S, R, 3) on the
    winning triangles gid (S, R): the barycentrics of the hit, the
    triangle's corner texcoords interpolated and wrapped (glTF REPEAT), the
    nearest texel of the scene's atlas."""
    S = gid.shape[0]
    g = gid.to(torch.int64)[..., None]
    rows = torch.gather(data.triangles, 1, g.expand(*gid.shape, 9))
    uv3 = torch.gather(data.tri_uv, 1, g.expand(*gid.shape, 6))
    rect = torch.gather(data.tri_rect, 1, g.expand(*gid.shape, 4))
    va = rows[..., 0:3]
    v0, v1, v2 = rows[..., 3:6] - va, rows[..., 6:9] - va, p - va
    d00 = torch.sum(v0 * v0, dim=-1)
    d01 = torch.sum(v0 * v1, dim=-1)
    d11 = torch.sum(v1 * v1, dim=-1)
    d20 = torch.sum(v2 * v0, dim=-1)
    d21 = torch.sum(v2 * v1, dim=-1)
    den = d00 * d11 - d01 * d01
    den = torch.where(torch.abs(den) > 1e-12, den, 1.0)
    bu = (d11 * d20 - d01 * d21) / den
    bv = (d00 * d21 - d01 * d20) / den
    uv = (uv3[..., 0:2] * (1.0 - bu - bv)[..., None] + uv3[..., 2:4] * bu[..., None]
          + uv3[..., 4:6] * bv[..., None])
    uv = uv - torch.floor(uv)
    tw, th = rect[..., 0], rect[..., 1]
    col = torch.minimum(torch.clamp(torch.round(uv[..., 0] * (tw - 1.0)), min=0.0),
                        torch.clamp(tw - 1.0, min=0.0)) + rect[..., 3]
    row = torch.minimum(torch.clamp(torch.round(uv[..., 1] * (th - 1.0)), min=0.0),
                        torch.clamp(th - 1.0, min=0.0)) + rect[..., 2]
    AH, AW = data.atlas.shape[1], data.atlas.shape[2]
    scene = torch.arange(S, device=gid.device)[:, None]
    lin = ((scene * AH + row.to(torch.int64)) * AW + col.to(torch.int64)).reshape(-1)
    return data.atlas.reshape(-1, 3)[lin].to(torch.float32)


def _render_triangles(data: SceneData, pos: Tensor, q: Tensor, spec: Dict, stype: str,
                      max_depth: float, objects, lighting: Optional[Lighting]
                      ) -> Dict[str, Tensor]:
    """One sensor on a mesh scene's exact triangles (``tri_trace_diff``): the
    tiled kernel path where a scene's rays are whole 1,024-ray tiles. Where
    they are not, CPU tensors take the brute force (every ray against every
    triangle, as the JAX package does); on the card that would be a plain
    PyTorch render by shape alone, so it raises instead."""
    H, W = spec["resolution"]
    n, S = pos.shape[0], data.num_scene
    Rs = (n // S) * H * W
    if Rs % TILE and pos.device.type != "cpu":
        raise ValueError(
            f"the exact-triangle camera on {pos.device} needs whole {TILE}-ray tiles a scene: "
            f"{n // S} agents a scene × {H}×{W} pixels = {Rs} rays is not a multiple of {TILE}; "
            "change the resolution or the number of agents a scene")
    origins, dirs, cos_f = camera_rays(spec, pos, q)
    o_g3 = origins[:, None, :].expand(n, H * W, 3).reshape(S, Rs, 3)
    d_g3 = dirs.reshape(S, Rs, 3)
    tiled = Rs % TILE == 0
    whole = tiled and (H * W) % TILE == 0  # a tile never spans two cameras
    tri = data.triangles
    t, hit, normal, gid = tri_trace_diff(
        tri, o_g3.permute(2, 0, 1).contiguous(), d_g3.permute(2, 0, 1).contiguous(),
        max_depth, int(spec.get("tri_cap", default_tri_cap(tri.shape[1]))),
        W if whole else None, tiled, H * W if whole else None,
        bool(spec.get("tri_backface", False)),
        variant=str(spec.get("tri_variant", "scalar")))
    obj_px = None
    if objects is not None:
        with profiling.span("render.object_hits"):
            t, hit, obj_px, n_o, c_o = _compose_objects(objects, o_g3, d_g3, t, hit, max_depth)
        normal = torch.where(obj_px[..., None], n_o, normal)
    if stype == "depth":
        depth = torch.where(hit.reshape(n, H, W), t.reshape(n, H, W) * cos_f, max_depth)
        return {"depth": depth[:, None, :, :]}
    # ids, and albedo where the scene has no textures, from the baked grids at
    # the exact hit
    p3 = o_g3 + d_g3 * t[..., None]
    p_hit = p3.reshape(n * H * W, 3)
    hit_f = hit.reshape(n * H * W)
    lin = _grid_cells(data, torch.arange(S, device=pos.device).repeat_interleave(Rs), p_hit)
    obj_f = (torch.zeros_like(hit_f) if obj_px is None else obj_px.reshape(n * H * W))
    if stype == "semantic":
        sem = torch.where(hit_f & ~obj_f, data.semantic.reshape(-1)[lin], 0)
        sem = torch.where(hit_f & obj_f, 255, sem).reshape(n, H, W)
        return {"semantic": sem[:, None, :, :].to(torch.uint8)}
    if isinstance(data.tri_uv, Tensor):
        albedo = _texture_albedo(data, gid, p3)
    else:
        albedo = data.albedo.reshape(-1, 3)[lin].to(torch.float32)
    if obj_px is not None:
        albedo = torch.where(obj_f[:, None], c_o.reshape(-1, 3), albedo)
    vis = None
    if lighting is not None and lighting.shadows:
        # dynamic objects receive shadows and cast none
        vis = shadow_visibility(tri, p3, normal.reshape(S, Rs, 3), lighting)
        vis = vis.reshape(n * H * W, -1)
    shade = lambert_shade(normal.reshape(-1, 3), p_hit, lighting, vis)
    rgb = torch.clamp(albedo * shade, 0, 255)
    rgb = torch.where(hit_f[:, None], rgb, 0.0).reshape(n, H, W, 3)
    return {"color": rgb.permute(0, 3, 1, 2).to(torch.uint8)}


def _render_grid(data: SceneData, pos: Tensor, q: Tensor, spec: Dict, stype: str,
                 n_steps: int, max_depth: float, objects, num_scene: Optional[int],
                 lighting: Optional[Lighting]) -> Dict[str, Tensor]:
    """One sensor sphere-traced through a grid scene's trilinear SDF
    (:func:`trace_rays`, a flat batch with scene ids): the grid backend,
    for a scene without triangles or a sensor with ``render_backend:
    "grid"``. Objects compose after the trace and shade with their own
    normal."""
    H, W = spec["resolution"]
    n = pos.shape[0]
    S = data.num_scene if num_scene is None else num_scene
    R = n * H * W
    origins, dirs, cos_f = camera_rays(spec, pos, q)
    flat_o = origins[:, None, :].expand(n, H * W, 3).reshape(R, 3)
    flat_d = dirs.reshape(R, 3)
    flat_sid = torch.arange(S, device=pos.device).repeat_interleave(R // S)
    t, hit = trace_rays(data, flat_sid, flat_o, flat_d, n_steps, max_depth)
    obj_flat = None
    if objects is not None:
        t_o, hit_o, n_o, c_o = _object_mesh_hits(objects, flat_o.reshape(S, R // S, 3),
                                                 flat_d.reshape(S, R // S, 3), max_depth)
        t_o, hit_o = t_o.reshape(R), hit_o.reshape(R)
        obj_flat = hit_o & (t_o < t)
        t = torch.where(obj_flat, t_o, t)
        hit = hit | obj_flat
    if stype == "depth":
        depth = torch.where(hit.reshape(n, H, W), t.reshape(n, H, W) * cos_f, max_depth)
        return {"depth": depth[:, None, :, :]}
    p_hit = flat_o + flat_d * t[:, None]
    lin = _grid_cells(data, flat_sid, p_hit)
    obj_f = torch.zeros_like(hit) if obj_flat is None else obj_flat
    if stype == "semantic":
        sem = torch.where(hit & ~obj_f, data.semantic.reshape(-1)[lin], 0)
        sem = torch.where(hit & obj_f, 255, sem).reshape(n, H, W)
        return {"semantic": sem[:, None, :, :].to(torch.uint8)}
    albedo = data.albedo.reshape(-1, 3)[lin].to(torch.float32)
    normal = sdf_normal(data, flat_sid, p_hit)
    if obj_flat is not None:
        albedo = torch.where(obj_flat[:, None], c_o.reshape(R, 3), albedo)
        normal = torch.where(obj_flat[:, None], n_o.reshape(R, 3), normal)
    rgb = torch.clamp(albedo * lambert_shade(normal, p_hit, lighting), 0, 255)
    rgb = torch.where(hit[:, None], rgb, 0.0).reshape(n, H, W, 3)
    return {"color": rgb.permute(0, 3, 1, 2).to(torch.uint8)}


def render_camera(
    data,
    pos: Tensor,
    q: Tensor,
    spec: Dict,
    n_steps: int = 40,
    max_depth: float = DEFAULT_MAX_DEPTH,
    objects=None,
    num_scene: Optional[int] = None,
    lighting: Optional[Lighting] = None,
    geom: Optional[CameraGeometry] = None,
) -> Dict[str, Tensor]:
    """Render one sensor for N agents ordered scene-contiguously (scene id =
    agent // agents per scene). ``objects``: see the module docstring; an
    object does not occlude a camera inside its bounding sphere."""
    stype = str(spec.get("sensor_type", spec.get("uuid", "depth"))).lower()
    if stype not in ("depth", "color", "semantic"):
        raise ValueError(f"unknown sensor type {stype!r}")
    if isinstance(data, SceneData):
        if data.has_triangles and str(spec.get("render_backend", "tri")) != "grid":
            return _render_triangles(data, pos, q, spec, stype, max_depth, objects, lighting)
        return _render_grid(data, pos, q, spec, stype, n_steps, max_depth, objects, num_scene,
                            lighting)
    if not isinstance(data, PrimitiveScene):
        raise TypeError(f"cannot render a {type(data).__name__}")
    # objects with triangle templates compose after the trace, which then
    # sees the static scene only; the others enter it as dynamic capsules
    mesh_objs = objects is not None and len(objects) > 3 and objects[3] is not None
    kern_objects = None if mesh_objs else objects

    H, W = spec["resolution"]
    n = pos.shape[0]
    S = data.num_scene if num_scene is None else num_scene
    R = (n // S) * H * W
    trace_mode = str(spec.get("trace_mode", "analytic"))
    analytic = trace_mode == "analytic"
    # analytic tracing discards warm starts, so the cone prepass would be
    # dead work: it is skipped
    tile = 1 if analytic else int(spec.get("tile", 1))
    cones = tile > 1 and H % tile == 0 and W % tile == 0 and H >= tile
    kid = None

    xla = str(spec.get("render_backend", "")) == "xla"
    if xla or cones:
        origins, dirs, cos_f = camera_rays(spec, pos, q)
        o_pm = origins[:, None, :].expand(n, H * W, 3).reshape(S, R, 3).contiguous()
        d_pm = dirs.reshape(S, R, 3)
        t_init, pixel_steps = None, n_steps
        if cones:
            # one conservative cone per tile, then the march from the tile
            # depth with half the steps
            t_init = cone_warm_start(data, spec, tile, origins, q, S, kern_objects, n_steps,
                                     max_depth)
            pixel_steps = n_steps if t_init is None else max(8, n_steps // 2)
        if xla:
            # the XLA route, asked for by name: plain PyTorch on either
            # device, no kernel; its pixels shade by the nearest primitive
            t, hit = trace_grouped(data, o_pm, d_pm, kern_objects, pixel_steps, max_depth,
                                   t_init, str(spec.get("render_dtype", "bfloat16")), trace_mode,
                                   int(spec.get("analytic_refine", 0)))
        else:
            t, hit, _ = trace_diff(prepare_kernel_scene(data, kern_objects), o_pm, d_pm, t_init,
                                   pixel_steps, max_depth, packed=True,
                                   img_w=W if (H * W) % TILE == 0 else None)
        cos_f = cos_f[:1]
    else:
        kscene = prepare_kernel_scene(data, kern_objects)
        # component-major: rays never exist as (R, 3) tensors on the way in
        o_c, d_c, cos_f = camera_rays_components(spec, pos, q, geom)
        # with one agent a scene the reshape is a view of the stride-0
        # expand; the kernels take contiguous rays
        o_full = o_c[:, :, None].expand(3, n, H * W).reshape(3, S, R).contiguous()
        d_full = d_c.reshape(3, S, R).contiguous()
        # the winning row's id is produced only when shading needs it
        want_kid = stype != "depth" and analytic
        # the per-tile cull takes whole 1,024-ray tiles (the JAX package takes
        # its un-culled path otherwise), and frustum planes only where a tile
        # never spans two cameras
        with profiling.span("render.scene_trace"):
            out = trace_diff(kscene, o_full, d_full, None,
                             int(spec.get("trace_steps_override", n_steps)), max_depth,
                             float(spec.get("march_omega", 1.0)),
                             bool(spec.get("cull", True)) and R % TILE == 0, analytic,
                             int(spec.get("analytic_refine", 0)), want_kid,
                             img_w=W if (H * W) % TILE == 0 else None)
        t, hit = out[0], out[1]
        kid = out[2] if want_kid else None
        cos_f = cos_f.reshape(1, H, W)
        if stype != "depth" or mesh_objs:  # shading and objects need point-major arrays
            o_pm, d_pm = o_full.permute(1, 2, 0), d_full.permute(1, 2, 0)

    obj_px = None
    if mesh_objs:
        with profiling.span("render.object_hits"):
            t, hit, obj_px, n_o, c_o = _compose_objects(objects, o_pm, d_pm, t, hit, max_depth)
    if stype == "depth":
        depth = torch.where(hit.reshape(n, H, W), t.reshape(n, H, W) * cos_f, max_depth)
        return {"depth": depth[:, None, :, :]}
    p_hit = o_pm + d_pm * t[..., None]
    if kid is not None:
        shaded = _shade_primitive_indexed(data, p_hit, hit, kid, stype, lighting)
    else:
        shaded = _shade_primitive(data, p_hit, hit, stype, lighting)
    if obj_px is not None:
        if stype == "semantic":
            shaded = torch.where(obj_px, 255.0, shaded)
        else:
            shaded = torch.where(obj_px[..., None], c_o * lambert_shade(n_o, p_hit, lighting),
                                 shaded)
    if stype == "semantic":
        sem = torch.round(shaded).to(torch.uint8).reshape(n, H, W)
        return {"semantic": sem[:, None, :, :]}
    rgb = torch.clamp(shaded, 0, 255).to(torch.uint8).reshape(n, H, W, 3)
    return {"color": rgb.permute(0, 3, 1, 2)}


def render_sensors(env, state) -> Dict[str, Tensor]:
    """Render every sensor in ``env.sensor_kwargs``, keyed by uuid, with the
    env's dynamic objects (``env.render_objects``) in view and each sensor's
    noise model applied, drawn from ``state.gen`` one sensor after another
    (the whole batch's draws, sliced, where the env is a block of a larger
    one). The env's lighting setup is baked once."""
    if env.scene is None:
        return {}
    if not hasattr(env, "_baked_lighting"):
        env._baked_lighting = bake_lighting(env.scene_kwargs.get("lighting"), env.device)
    noise = getattr(env, "noise_settings", None) or {}
    out: Dict[str, Tensor] = {}
    with profiling.span("render.sensors"):
        objects = env.render_objects(state)
        for spec, geom in zip(env.sensor_kwargs, env.cameras):
            res = render_camera(env.scene, state.dyn.pos, state.dyn.q, spec,
                                n_steps=int(env.scene_kwargs.get("trace_steps", 40)),
                                objects=objects, num_scene=env.num_scene,
                                lighting=env._baked_lighting, geom=geom)
            for k, v in res.items():
                uuid = spec.get("uuid", k)
                if uuid in noise and uuid != "IMU":
                    v = apply_noise(state.gen, uuid, v, noise, rows=env.global_rows)
                out[uuid] = v
    return out
