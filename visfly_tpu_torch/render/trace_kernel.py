"""Ray trace against packed primitive scenes: the CUDA kernels, their plain
PyTorch versions, the kernels' scene view and the differentiable entry
(counterpart of ``visfly_tpu/render/pallas_trace.py``).

Two wrappers, each launching its CUDA kernel on CUDA tensors (built at first
use from ``csrc/``, bound with ctypes) or raising, and running its plain
version on CPU tensors:

``trace_analytic``  closed-form first hit per ray (``csrc/trace_analytic.cu``),
    optionally with the winning row's id (``want_kid``) and an ``n_refine``
    step residual march. With ``n_refine == 0`` there is no final residual
    SDF evaluation, as in the JAX tile (``_march(final_eval=False)``).
``trace_march``  the sphere-trace march (``csrc/trace_march.cu``) from a warm
    start ``t_init``, plain or over-relaxed (``omega > 1``), on
    component-major ``(3, S, R)`` or packed ``(S, R, 3)`` rays.

Both return ``t (S, R)`` float32 and ``hit (S, R)`` bool, ``hit = t <
max_depth``; ``kid (S, R)`` is float32 as the JAX entries return it.

The march with ``cull`` computes ``_trace_kernel_culled``: each 1,024-ray tile
marches over the rows :func:`cull_rows` picks, the port of ``cull_compact``.
The rows whose bounds meet the tile's reachable region come first in stable
order; when both families' counts fit the compacted block (``kb_c``, ``kc_c``
of :func:`cull_capacity`) the tile evaluates the first ``kb_c`` box and
``kc_c`` capsule rows of that order, culled-in rows followed by culled-out
*filler* rows in scene order, and otherwise every row. The filler rows are
part of the function: a ray that runs out of steps ends where this row set
puts it. The analytic trace with ``cull`` computes the same kernel's analytic
mode: the closed-form first hit runs over the rows that meet the tile only (a
row the cull keeps out has no hit nearer than ``max_depth``, so t, hit and the
id are the TPU tile's), and the refine marches the tile's rows, filler rows
included.

``trace_diff`` is the differentiable entry over either wrapper: its backward
is the implicit-function-theorem rule in plain PyTorch, so no kernel runs
backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..scene.prim_scene import PrimitiveScene, prim_sdf

BIG = 1e9
BOX_COLS = 13
CAP_COLS = 9
EPS = 0.01  # the march's hit epsilon
TILE = 1024  # rays of a culled tile, the TPU kernel's (8, 128) block
# Launches of each CUDA kernel mode since the counts were last set to 0. A
# wrapper adds one to its mode where it launches and nowhere else.
# "trace_march" (culled), "trace_march_nocull" and "trace_march_packed" are
# instantiations of one march kernel.
LAUNCHES = {"trace_analytic": 0, "trace_analytic_kid": 0, "trace_march": 0,
            "trace_march_nocull": 0, "trace_march_packed": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class KernelScene(NamedTuple):
    """Family-split scene rows for the kernel: boxes (S, KB, 13)
    [cx cy cz hx hy hz r cos sin sign family active id], capsules (S, KC, 9)
    [ax ay az bx by bz r active id]."""

    boxes: Tensor
    capsules: Tensor


def prepare_kernel_scene(scene: PrimitiveScene, objects=None) -> KernelScene:
    """Kernel view of a packed scene. Dynamic objects ``(pos (S, M, 3),
    radius (S, M))`` append as degenerate capsules (a == b == position) with
    active flag 2.0, which makes an object whose inside holds a ray's origin
    invisible to that ray (a drone does not see its own body), and id −1."""
    boxes, capsules = scene.boxes, scene.capsules
    if objects is not None:
        obj_pos, obj_radius = objects[0], objects[1]
        S, m = obj_pos.shape[0], obj_pos.shape[1]
        flags = obj_pos.new_tensor([2.0, -1.0]).expand(S, m, 2)
        obj_caps = torch.cat([obj_pos, obj_pos, obj_radius[..., None], flags], dim=-1)
        capsules = torch.cat([capsules, obj_caps.to(capsules.dtype)], dim=1)
    return KernelScene(boxes, capsules)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _box_t(b: Tensor, o, d) -> Tensor:
    """(r, KB) hit t of each box row; b (KB, 13), o/d triples of (r, 1)."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy_, cz = b[:, 0], b[:, 1], b[:, 2]
    hx, hy, hz = b[:, 3], b[:, 4], b[:, 5]
    rad = b[:, 6]
    cyaw, syaw = b[:, 7], b[:, 8]
    sign = b[:, 9]
    active = b[:, 11]
    rx, ry = ox - cx, oy - cy_
    px = cyaw * rx + syaw * ry
    py = -syaw * rx + cyaw * ry
    pz = oz - cz
    vx = cyaw * dx + syaw * dy
    vy = -syaw * dx + cyaw * dy
    vz = dz.expand_as(vx)

    def slab1(p, v, h):
        tiny = torch.where(v >= 0, 1e-9, -1e-9).to(v.dtype)
        safe = torch.where(torch.abs(v) < 1e-9, tiny, v)
        t1 = (-h - p) / safe
        t2 = (h - p) / safe
        return torch.minimum(t1, t2), torch.maximum(t1, t2)

    n1, f1 = slab1(px, vx, hx + rad)
    n2, f2 = slab1(py, vy, hy + rad)
    n3, f3 = slab1(pz, vz, hz + rad)
    tn = torch.maximum(n1, torch.maximum(n2, n3))
    tf = torch.minimum(f1, torch.minimum(f2, f3))
    zero = torch.zeros_like(tn)
    big = torch.full_like(tn, BIG)
    t_solid = torch.where((tn <= tf) & (tf > 0.0), torch.maximum(tn, zero), big)
    t_room = torch.where(tn <= 0.0, torch.maximum(tf, zero), zero)
    # sphere (he == 0): exact quadratic
    bs = px * vx + py * vy + pz * vz
    cs = px * px + py * py + pz * pz - rad * rad
    disc = bs * bs - cs
    sq = torch.sqrt(torch.maximum(disc, zero))
    tin, tout = -bs - sq, -bs + sq
    t_sph = torch.where(disc > 0.0,
                        torch.where(tin >= 0.0, tin, torch.where(tout > 0.0, zero, big)), big)
    tk = torch.where(sign < 0.0, t_room, torch.where(hx + hy + hz < 1e-6, t_sph, t_solid))
    return torch.where(active > 0.5, tk, big)


def _capsule_axis_distance(c: Tensor, p) -> Tensor:
    """(r, KC) distance from points p (triple of (r, 1)) to each capsule's
    axis segment."""
    px, py, pz = p
    ax, ay, az = c[:, 0], c[:, 1], c[:, 2]
    bax, bay, baz = c[:, 3] - ax, c[:, 4] - ay, c[:, 5] - az
    pax, pay, paz = px - ax, py - ay, pz - az
    inv_denom = 1.0 / (bax * bax + bay * bay + baz * baz + 1e-9)
    h = torch.clamp((pax * bax + pay * bay + paz * baz) * inv_denom, 0.0, 1.0)
    ex, ey, ez = pax - bax * h, pay - bay * h, paz - baz * h
    return torch.sqrt(ex * ex + ey * ey + ez * ez + 1e-12)


def _capsule_holds(c: Tensor, o) -> Tensor:
    """(r, KC) True where the capsule, grown by 5 cm, holds the point."""
    return _capsule_axis_distance(c, o) <= c[:, 6] + 0.05


def _capsule_t(c: Tensor, o, d) -> Tensor:
    """(r, KC) hit t of each capsule row; c (KC, 9), o/d triples of (r, 1)."""
    ox, oy, oz = o
    dx, dy, dz = d
    ax, ay, az = c[:, 0], c[:, 1], c[:, 2]
    bx, by, bz = c[:, 3], c[:, 4], c[:, 5]
    rad = c[:, 6]
    active = c[:, 7]
    bax, bay, baz = bx - ax, by - ay, bz - az
    oax, oay, oaz = ox - ax, oy - ay, oz - az

    # origin inside (within rad + 5 cm): static rows hit at 0, dynamic rows
    # (active == 2) are the agent's own body and stay invisible
    inside = _capsule_holds(c, o)
    dyn = active > 1.5

    baba = bax * bax + bay * bay + baz * baz
    bard = bax * dx + bay * dy + baz * dz
    baoa = bax * oax + bay * oay + baz * oaz
    rdoa = dx * oax + dy * oay + dz * oaz
    oaoa = oax * oax + oay * oay + oaz * oaz
    A = baba - bard * bard
    Bq = baba * rdoa - baoa * bard
    Cq = baba * oaoa - baoa * baoa - rad * rad * baba
    hq = Bq * Bq - A * Cq
    zero = torch.zeros_like(hq)
    big = torch.full_like(hq, BIG)
    tcyl = (-Bq - torch.sqrt(torch.maximum(hq, zero))) / torch.clamp(A, min=1e-9)
    yc = baoa + tcyl * bard
    ok = (hq > 0.0) & (A > 1e-7) & (yc >= 0.0) & (yc <= baba) & (tcyl >= 0.0)
    tk = torch.where(ok, tcyl, big)
    for ex_, ey_, ez_ in ((ax, ay, az), (bx, by, bz)):
        ocx, ocy, ocz = ox - ex_, oy - ey_, oz - ez_
        bb = ocx * dx + ocy * dy + ocz * dz
        cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        dd = bb * bb - cc
        ti = -bb - torch.sqrt(torch.maximum(dd, zero))
        tk = torch.minimum(tk, torch.where((dd > 0.0) & (ti >= 0.0), ti, big))
    tk = torch.where(inside & dyn, big, tk)
    tk = torch.where(inside & ~dyn, zero, tk)
    return torch.where(active > 0.5, tk, big)


def _box_sdf(b: Tensor, p) -> Tensor:
    """(r, KB) signed distance of each box row at points p."""
    px, py, pz = p
    cyaw, syaw = b[:, 7], b[:, 8]
    rx, ry = px - b[:, 0], py - b[:, 1]
    x = cyaw * rx + syaw * ry
    y = -syaw * rx + cyaw * ry
    z = pz - b[:, 2]
    qx, qy, qz = torch.abs(x) - b[:, 3], torch.abs(y) - b[:, 4], torch.abs(z) - b[:, 5]
    zero = torch.zeros_like(qx)
    ex, ey, ez = torch.maximum(qx, zero), torch.maximum(qy, zero), torch.maximum(qz, zero)
    outside = torch.sqrt(ex * ex + ey * ey + ez * ez + 1e-12)
    inside = torch.minimum(torch.maximum(qx, torch.maximum(qy, qz)), zero)
    return (outside + inside - b[:, 6]) * b[:, 9]


def _ray_sdf(boxes: Tensor, caps: Tensor, o, d, rows=None):
    """The scene SDF a marching ray evaluates, as a function of t (r,):
    inactive rows and dynamic capsules that hold the ray's origin are out,
    and with ``rows`` ((r, KB), (r, KC) bool: the rows each ray's tile
    evaluates) every other row too."""
    box_off = ~(boxes[:, 11] > 0.5)
    cap_off = ~(caps[:, 7] > 0.5) | ((caps[:, 7] > 1.5) & _capsule_holds(caps, o))
    if rows is not None:
        box_off, cap_off = box_off | ~rows[0], cap_off | ~rows[1]

    def sdf(t: Tensor) -> Tensor:
        p = tuple(oi + di * t[:, None] for oi, di in zip(o, d))
        db = _box_sdf(boxes, p)
        dc = _capsule_axis_distance(caps, p) - caps[:, 6]
        dist = torch.cat([db.masked_fill(box_off, BIG), dc.masked_fill(cap_off, BIG)], dim=1)
        return torch.amin(dist, dim=1)

    return sdf


def _march(sdf, t: Tensor, n_steps: int, max_depth: float, eps: float, omega: float,
           evals: Optional[Tensor]) -> Tensor:
    """``n_steps`` of the march from t, mirroring ``_march`` of the JAX tile
    step by step; ``evals`` (r,) gains, in place, the evaluations each ray
    needed while not yet done."""
    done = torch.zeros_like(t, dtype=torch.bool)
    prev_r = torch.zeros_like(t)
    step_len = torch.zeros_like(t)
    om = torch.full_like(t, omega)
    for _ in range(n_steps):
        if evals is not None:
            evals += ~done
        r = sdf(t)
        if omega <= 1.0:
            done = done | (r < eps) | (t >= max_depth)
            t = torch.where(done, t, t + r)
        else:
            # the safe spheres of the two last samples must overlap, else the
            # over-relaxed step may have skipped a surface: step back inside
            # the previous sphere and march plainly from then on
            fail = (om > 1.0) & (r + prev_r < step_len)
            done = done | (~fail & (r < eps)) | (t >= max_depth)
            new_step = torch.where(fail, step_len * (1.0 - omega), r * om)
            om = torch.where(fail, torch.ones_like(om), om)
            t = torch.where(done, t, t + new_step)
            prev_r, step_len = r, new_step
    return t


def _final_eval(sdf, t: Tensor, max_depth: float, evals: Optional[Tensor]) -> Tensor:
    if evals is not None:
        evals += 1
    return torch.clamp(t + sdf(t), 0.0, max_depth)


def _chunks(origins_c: Tensor, dirs_c: Tensor, chunk: int):
    """(scene, ray slice, o, d) with o/d triples of (r, 1)."""
    _, S, R = origins_c.shape
    for s in range(S):
        for r0 in range(0, R, chunk):
            sl = slice(r0, r0 + chunk)
            yield (s, sl, tuple(origins_c[i, s, sl, None] for i in range(3)),
                   tuple(dirs_c[i, s, sl, None] for i in range(3)))


class CullRows(NamedTuple):
    """The per-tile cull of :func:`cull_rows`: the rows that meet each tile,
    ``box_in`` (S, T, KB) and ``cap_in`` (S, T, KC) bool, counted per family
    ``nb``, ``nc`` (S, T) int64; whether both counts fit the compacted block,
    ``fits`` (S, T) bool; and the rows the culled march evaluates in each
    tile, ``box_rows`` (S, T, KB) and ``cap_rows`` (S, T, KC) bool. With the
    frustum planes, each row's margin against each plane, ``box_margin``
    (S, T, 4, KB) and ``cap_margin`` (S, T, 4, KC): the row is on the inner
    side of a plane where its margin is ≥ 0; else None."""

    nb: Tensor
    nc: Tensor
    fits: Tensor
    box_rows: Tensor
    cap_rows: Tensor
    box_in: Tensor
    cap_in: Tensor
    box_margin: Optional[Tensor] = None
    cap_margin: Optional[Tensor] = None


def cull_capacity(k: int) -> int:
    """Rows of one family that a tile's compacted block holds: half of
    them, at least 4 (``pallas_trace_c``)."""
    return min(k, max(4, k // 2))


def _dot3(n: Tensor, v: Tensor) -> Tensor:
    """n·v over the last axis as (n0·v0 + n1·v1) + n2·v2, the kernel's order."""
    return n[..., 0] * v[..., 0] + n[..., 1] * v[..., 1] + n[..., 2] * v[..., 2]


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """a × b over the last axis, each component as ``jnp.cross`` forms it."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], -1)


def _first_in_order(inside: Tensor, k_c: int, fits: Tensor) -> Tensor:
    """Rows among the first ``k_c`` of the stable order that puts the rows
    ``inside`` (S, T, K) first, where ``fits``; every row elsewhere."""
    n = inside.sum(-1, keepdim=True)
    before = torch.cumsum(inside, -1) - inside.long()  # inside rows ahead of each row
    k = torch.arange(inside.shape[-1], device=inside.device)
    rank = torch.where(inside, before, n + k - before)
    return (rank < k_c) | ~fits[..., None]


def cull_rows(kscene: KernelScene, origins_c: Tensor, dirs_c: Tensor, max_depth: float,
              img_w: Optional[int] = None) -> CullRows:
    """The per-tile cull of ``cull_compact`` for rays (3, S, R), R a multiple
    of 1,024. A tile may reach the box from o.min + max_depth·min(d.min, 0)
    to o.max + max_depth·max(d.max, 0); a row is in where its bounds meet
    that box (a box's: |R(yaw)|·half + r about its centre; a capsule's: its
    endpoints' box grown by r), where it is active, and, with ``img_w``
    dividing 1,024 (each tile rows of one pinhole camera), where it lies on
    the inner side of the four planes through the tile's first origin and
    consecutive corner rays 0, img_w − 1, 1023, 1024 − img_w. Active hollow
    rooms (sign < 0) are always in. Sums of three products run in the
    kernel's order (:func:`_dot3`)."""
    boxes, caps = kscene.boxes, kscene.capsules
    _, S, R = origins_c.shape
    if R % TILE:
        raise ValueError(f"the per-tile cull takes whole tiles of {TILE} rays; got {R} a scene")
    T = R // TILE
    o = origins_c.reshape(3, S, T, TILE)
    d = dirs_c.reshape(3, S, T, TILE)
    lo = (o.amin(-1) + max_depth * torch.clamp(d.amin(-1), max=0.0)).permute(1, 2, 0)
    hi = (o.amax(-1) + max_depth * torch.clamp(d.amax(-1), min=0.0)).permute(1, 2, 0)
    lo, hi = lo[:, :, None], hi[:, :, None]  # (S, T, 1, 3)

    c, h, rad = boxes[..., 0:3], boxes[..., 3:6], boxes[..., 6]
    acy, asy = boxes[..., 7].abs(), boxes[..., 8].abs()
    hw = torch.stack([acy * h[..., 0] + asy * h[..., 1], asy * h[..., 0] + acy * h[..., 1],
                      h[..., 2]], -1) + rad[..., None]  # (S, KB, 3)
    room = (boxes[..., 9] < 0.0)[:, None]
    in_b = ((lo <= (c + hw)[:, None]) & (hi >= (c - hw)[:, None])).all(-1)  # (S, T, KB)
    in_b = (in_b | room) & (boxes[..., 11] > 0.5)[:, None]

    a, b, r = caps[..., 0:3], caps[..., 3:6], caps[..., 6:7]
    clo, chi = torch.minimum(a, b) - r, torch.maximum(a, b) + r
    in_c = ((lo <= chi[:, None]) & (hi >= clo[:, None])).all(-1)
    in_c = in_c & (caps[..., 7] > 0.5)[:, None]  # (S, T, KC)

    if img_w is not None and TILE % img_w == 0:
        corners = torch.stack([d[..., 0], d[..., img_w - 1], d[..., TILE - 1],
                               d[..., TILE - img_w]], -1).permute(1, 2, 3, 0)  # (S, T, 4, 3)
        planes = _cross(corners, torch.roll(corners, -1, dims=2))
        centre = corners[:, :, 0] + corners[:, :, 1] + corners[:, :, 2] + corners[:, :, 3]
        side = torch.sign(_dot3(planes, centre[:, :, None]))
        planes = planes * torch.where(side == 0, 1.0, side)[..., None]
        apex = o[..., 0].permute(1, 2, 0)[:, :, None, None]  # (S, T, 1, 1, 3)
        n = planes[:, :, :, None]  # (S, T, 4, 1, 3)
        r_box = _dot3(n.abs(), hw[:, None, None])
        margin_b = _dot3(n, c[:, None, None] - apex) + r_box  # (S, T, 4, KB)
        in_b = in_b & ((margin_b >= 0.0).all(2) | room)
        r_cap = caps[..., 6][:, None, None] * torch.sqrt(_dot3(planes, planes))[..., None]
        d_a = _dot3(n, a[:, None, None] - apex)
        d_b = _dot3(n, b[:, None, None] - apex)
        margin_c = torch.maximum(d_a, d_b) + r_cap
        in_c = in_c & (margin_c >= 0.0).all(2)
    else:
        margin_b = margin_c = None

    nb, nc = in_b.sum(-1), in_c.sum(-1)
    fits = (nb <= cull_capacity(boxes.shape[1])) & (nc <= cull_capacity(caps.shape[1]))
    return CullRows(nb, nc, fits, _first_in_order(in_b, cull_capacity(boxes.shape[1]), fits),
                    _first_in_order(in_c, cull_capacity(caps.shape[1]), fits), in_b, in_c,
                    margin_b, margin_c)


def _tiles_of(sl: slice, R: int, device) -> Tensor:
    """The tile of each ray of the chunk ``sl``."""
    return torch.arange(sl.start, min(sl.stop, R), device=device) // TILE


def trace_analytic_reference(kscene: KernelScene, origins_c: Tensor, dirs_c: Tensor,
                             max_depth: float = 20.0, chunk: int = 1 << 18,
                             want_kid: bool = False, n_refine: int = 0, eps: float = EPS,
                             stats: Optional[dict] = None, cull: bool = False,
                             img_w: Optional[int] = None) -> Tuple[Tensor, ...]:
    """Plain PyTorch version of the analytic kernel: the same formulas in the
    same order, broadcast over (rays, rows). Rays go in chunks of ``chunk``
    to bound the (r, K) intermediates. ``kid`` is the id column of the first
    minimum in row order (boxes, then capsules), −1 on a miss. With ``cull``
    (R a multiple of 1,024; ``chunk`` is rounded down to whole tiles) the
    closed form of each tile's rays runs over the rows :func:`cull_rows`
    finds to meet the tile, and the refine marches the rows the tile
    evaluates."""
    _, S, R = origins_c.shape
    t = torch.empty((S, R), dtype=origins_c.dtype, device=origins_c.device)
    kid = torch.empty_like(t) if want_kid else None
    evals = (torch.zeros((S, R), dtype=torch.int32, device=t.device)
             if stats is not None and n_refine > 0 else None)
    plan = cull_rows(kscene, origins_c, dirs_c, max_depth, img_w) if cull else None
    if cull:
        chunk = max(TILE, chunk // TILE * TILE)
    for s, sl, o, d in _chunks(origins_c, dirs_c, chunk):
        boxes, caps = kscene.boxes[s], kscene.capsules[s]
        t_box, t_cap = _box_t(boxes, o, d), _capsule_t(caps, o, d)
        rows = None
        if cull:
            tiles = _tiles_of(sl, R, t.device)
            t_box = t_box.masked_fill(~plan.box_in[s, tiles], BIG)
            t_cap = t_cap.masked_fill(~plan.cap_in[s, tiles], BIG)
            rows = (plan.box_rows[s, tiles], plan.cap_rows[s, tiles])
        tk = torch.cat([t_box, t_cap], dim=1)
        if want_kid:
            best, k = torch.min(tk, dim=1)  # the index of the first minimum
            ids = torch.cat([boxes[:, 12], caps[:, 8]])
            kid[s, sl] = torch.where(best < max_depth, ids[k], -1.0)
        else:
            best = torch.amin(tk, dim=1)
        t0 = torch.clamp(best, max=max_depth)
        if n_refine > 0:
            sdf = _ray_sdf(boxes, caps, o, d, rows)
            ev = None if evals is None else evals[s, sl]
            t0 = _march(sdf, t0, n_refine, max_depth, eps, 1.0, ev)
            t[s, sl] = _final_eval(sdf, t0, max_depth, ev)
        else:
            t[s, sl] = torch.clamp(t0, 0.0, max_depth)
    if evals is not None:
        stats.update(ray_evals=evals, sdf_evals=int(evals.sum()))
    hit = t < max_depth
    return (t, hit, kid) if want_kid else (t, hit)


def trace_march_reference(kscene: KernelScene, origins_c: Tensor, dirs_c: Tensor,
                          t_init: Optional[Tensor] = None, n_steps: int = 40,
                          max_depth: float = 20.0, eps: float = EPS, omega: float = 1.0,
                          chunk: int = 1 << 18, stats: Optional[dict] = None,
                          cull: bool = False, img_w: Optional[int] = None
                          ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the march kernel on component-major rays
    (3, S, R), float32 step by step as the JAX tile marches. With ``cull``
    each tile evaluates only the rows of :func:`cull_rows` (R a multiple of
    1,024; ``chunk`` is rounded down to whole tiles). ``stats`` receives the
    evaluations each ray needed, ``"ray_evals"`` (S, R), and their sum,
    ``"sdf_evals"``."""
    _, S, R = origins_c.shape
    t = torch.empty((S, R), dtype=origins_c.dtype, device=origins_c.device)
    evals = None if stats is None else torch.zeros((S, R), dtype=torch.int32, device=t.device)
    plan = cull_rows(kscene, origins_c, dirs_c, max_depth, img_w) if cull else None
    if cull:
        chunk = max(TILE, chunk // TILE * TILE)
    for s, sl, o, d in _chunks(origins_c, dirs_c, chunk):
        rows = None
        if cull:
            tiles = _tiles_of(sl, R, t.device)
            rows = (plan.box_rows[s, tiles], plan.cap_rows[s, tiles])
        sdf = _ray_sdf(kscene.boxes[s], kscene.capsules[s], o, d, rows)
        t0 = torch.zeros_like(o[0][:, 0]) if t_init is None else t_init[s, sl]
        ev = None if evals is None else evals[s, sl]
        t0 = _march(sdf, t0, n_steps, max_depth, eps, omega, ev)
        t[s, sl] = _final_eval(sdf, t0, max_depth, ev)
    if stats is not None:
        stats.update(ray_evals=evals, sdf_evals=int(evals.sum()))
    return t, t < max_depth


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launcher(name: str):
    from ..build import load_library

    fn = getattr(load_library(name), f"{name}_launch")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = {
        # boxes caps origins dirs t hit kid | S R KB KC kb_c kc_c img_w | max_depth
        # n_refine eps | cull stream
        "trace_analytic": [p] * 7 + [i] * 7 + [f, i, f, i, p],
        # boxes caps origins dirs t_init t hit counts | S R KB KC kb_c kc_c img_w
        # n_steps | max_depth eps omega 1-omega | packed cull stream
        "trace_march": [p] * 8 + [i] * 8 + [f] * 4 + [i, i, p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check(kscene: KernelScene, origins: Tensor, dirs: Tensor, packed: bool = False,
           t_init: Optional[Tensor] = None) -> Tuple[int, int]:
    """Shapes, dtypes and devices both paths need → (S, R)."""
    boxes, caps = kscene.boxes, kscene.capsules
    layout = "(S, R, 3)" if packed else "(3, S, R)"
    if (origins.dim() != 3 or origins.shape[2 if packed else 0] != 3
            or dirs.shape != origins.shape):
        raise ValueError(f"rays must be {layout}; got {tuple(origins.shape)} and "
                         f"{tuple(dirs.shape)}")
    S, R = (origins.shape[0], origins.shape[1]) if packed else origins.shape[1:]
    if (boxes.dim() != 3 or boxes.shape[0] != S or boxes.shape[2] != BOX_COLS
            or caps.dim() != 3 or caps.shape[0] != S or caps.shape[2] != CAP_COLS):
        raise ValueError(f"kernel scene must be boxes (S, KB, {BOX_COLS}) and capsules "
                         f"(S, KC, {CAP_COLS}) with S = {S}; got {tuple(boxes.shape)} and "
                         f"{tuple(caps.shape)}")
    if t_init is not None and tuple(t_init.shape) != (S, R):
        raise ValueError(f"t_init must be ({S}, {R}); got {tuple(t_init.shape)}")
    for x in (boxes, caps, origins, dirs) + (() if t_init is None else (t_init,)):
        if x.dtype != torch.float32:
            raise TypeError(f"the trace takes float32 tensors; got {x.dtype}")
        if x.device != origins.device:
            raise ValueError(f"all inputs must be on {origins.device}; got {x.device}")
    if origins.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the trace runs on cpu or cuda tensors, not {origins.device}")
    return S, R


def _check_cuda(kscene: KernelScene, tensors, smem: int) -> None:
    """What only the kernels need: contiguity and rows that fit shared
    memory (``smem`` bytes, as the kernel's launch reckons them)."""
    for x in (kscene.boxes, kscene.capsules, *tensors):
        if not x.is_contiguous():
            raise ValueError("the trace kernels take contiguous tensors")
    KB, KC = kscene.boxes.shape[1], kscene.capsules.shape[1]
    if smem > 48 * 1024:
        raise ValueError(f"{KB} box and {KC} capsule rows need {smem} bytes of shared memory; "
                         f"the kernel takes at most {48 * 1024}")


@functools.lru_cache(maxsize=None)
def _smem(name: str):
    """``<name>_smem(KB, KC, flag)`` of a kernel's library: the shared memory
    one block takes, in bytes, as its launch reckons it (the march's flag is
    the cull, the analytic kernel's the refine)."""
    from ..build import load_library

    fn = getattr(load_library(name), f"{name}_smem")
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn


def _camera_width(img_w: Optional[int]) -> int:
    """The ``img_w`` a kernel takes: the camera's width where it divides a
    tile, else 0 (no frustum planes)."""
    return img_w if img_w is not None and TILE % img_w == 0 else 0


def trace_analytic(kscene: KernelScene, origins_c: Tensor, dirs_c: Tensor,
                   max_depth: float = 20.0, want_kid: bool = False, n_refine: int = 0,
                   eps: float = EPS, cull: bool = False,
                   img_w: Optional[int] = None) -> Tuple[Tensor, ...]:
    """First hit of rays (3, S, R) against each scene's rows → (t (S, R),
    hit (S, R)[, kid (S, R)]). ``cull`` culls each 1,024-ray tile, as
    ``pallas_trace_c(analytic=True, cull=True)``: R must be a multiple of
    1,024, and ``img_w``, where it divides 1,024, gives the cull the frustum
    planes of a camera that many pixels wide. CUDA tensors go through the
    CUDA kernel, CPU tensors through :func:`trace_analytic_reference`."""
    S, R = _check(kscene, origins_c, dirs_c)
    if cull and R % TILE:
        raise ValueError(f"rays per scene ({R}) must be a multiple of {TILE} for the "
                         "per-tile cull")
    dev = origins_c.device
    if dev.type == "cpu":
        return trace_analytic_reference(kscene, origins_c, dirs_c, max_depth,
                                        want_kid=want_kid, n_refine=n_refine, eps=eps,
                                        cull=cull, img_w=img_w)
    KB, KC = kscene.boxes.shape[1], kscene.capsules.shape[1]
    _check_cuda(kscene, (origins_c, dirs_c),
                _smem("trace_analytic")(KB, KC, int(n_refine > 0)))
    boxes, caps = kscene.boxes, kscene.capsules
    t = torch.empty((S, R), dtype=torch.float32, device=dev)
    hit = torch.empty((S, R), dtype=torch.bool, device=dev)
    kid = torch.empty((S, R), dtype=torch.float32, device=dev) if want_kid else None
    if S and R:
        launch = _launcher("trace_analytic")
        with torch.cuda.device(dev):
            rc = launch(boxes.data_ptr(), caps.data_ptr(), origins_c.data_ptr(),
                        dirs_c.data_ptr(), t.data_ptr(), hit.data_ptr(),
                        kid.data_ptr() if want_kid else None, S, R, KB, KC, cull_capacity(KB),
                        cull_capacity(KC), _camera_width(img_w), float(max_depth),
                        int(n_refine), float(eps), int(cull),
                        torch.cuda.current_stream(dev).cuda_stream)
            LAUNCHES["trace_analytic_kid" if want_kid else "trace_analytic"] += 1
        if rc != 0:
            raise RuntimeError(f"trace_analytic kernel launch failed with CUDA error {rc}")
    return (t, hit, kid) if want_kid else (t, hit)


def trace_march(kscene: KernelScene, origins: Tensor, dirs: Tensor,
                t_init: Optional[Tensor] = None, n_steps: int = 40,
                max_depth: float = 20.0, eps: float = EPS, omega: float = 1.0,
                cull: bool = True, packed: bool = False, img_w: Optional[int] = None,
                want_counts: bool = False) -> Tuple[Tensor, ...]:
    """Sphere-trace march → (t (S, R), hit (S, R)). Rays are (3, S, R), or
    (S, R, 3) with ``packed`` (which has no over-relaxed form and no cull,
    as the TPU's packed entry). ``cull`` marches each 1,024-ray tile over
    the rows of :func:`cull_rows`, as ``pallas_trace_c(cull=True)``: R must
    be a multiple of 1,024. ``img_w``, where it divides 1,024, says the rays
    are images of a camera that many pixels wide, each tile whole rows of
    one image: the cull then takes its frustum planes, and in every mode
    the kernel hands a warp 8 × 4 patches of pixels (which changes no
    result). ``want_counts`` (with ``cull``) also returns each tile's
    (nb, nc) of :func:`cull_rows`, (S, T, 2) int32. CUDA tensors go through
    the CUDA kernel, CPU tensors through :func:`trace_march_reference`."""
    S, R = _check(kscene, origins, dirs, packed, t_init)
    if packed and omega > 1.0:
        raise ValueError("the packed march has no over-relaxed form (omega > 1)")
    cull = cull and not packed
    if cull and R % TILE:
        raise ValueError(f"rays per scene ({R}) must be a multiple of {TILE} for the "
                         "per-tile cull")
    if want_counts and not cull:
        raise ValueError("want_counts needs the per-tile cull")
    dev = origins.device
    if dev.type == "cpu":
        if packed:
            origins, dirs = origins.permute(2, 0, 1), dirs.permute(2, 0, 1)
        out = trace_march_reference(kscene, origins, dirs, t_init, n_steps, max_depth, eps,
                                    omega, cull=cull, img_w=img_w)
        if want_counts:
            plan = cull_rows(kscene, origins, dirs, max_depth, img_w)
            out = (*out, torch.stack([plan.nb, plan.nc], -1).to(torch.int32))
        return out
    tensors = (origins, dirs) if t_init is None else (origins, dirs, t_init)
    KB, KC = kscene.boxes.shape[1], kscene.capsules.shape[1]
    _check_cuda(kscene, tensors, _smem("trace_march")(KB, KC, int(cull)))
    boxes, caps = kscene.boxes, kscene.capsules
    t = torch.empty((S, R), dtype=torch.float32, device=dev)
    hit = torch.empty((S, R), dtype=torch.bool, device=dev)
    counts = (torch.empty((S, R // TILE, 2), dtype=torch.int32, device=dev)
              if want_counts else None)
    if S and R:
        launch = _launcher("trace_march")
        mode = "trace_march_packed" if packed else "trace_march" if cull else "trace_march_nocull"
        with torch.cuda.device(dev):
            rc = launch(boxes.data_ptr(), caps.data_ptr(), origins.data_ptr(), dirs.data_ptr(),
                        None if t_init is None else t_init.data_ptr(), t.data_ptr(),
                        hit.data_ptr(), None if counts is None else counts.data_ptr(), S, R,
                        KB, KC, cull_capacity(KB), cull_capacity(KC), _camera_width(img_w),
                        int(n_steps),
                        float(max_depth), float(eps), float(omega), 1.0 - float(omega),
                        int(packed), int(cull), torch.cuda.current_stream(dev).cuda_stream)
            LAUNCHES[mode] += 1
        if rc != 0:
            raise RuntimeError(f"{mode} kernel launch failed with CUDA error {rc}")
    return (t, hit, counts) if want_counts else (t, hit)


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------
#
# The trace defines t*(o, d) implicitly by sdf(o + t·d) = 0. The implicit
# function theorem gives exact gradients from one normal evaluation:
#     ∂t/∂o = −n / (n·d),       ∂t/∂d = −t·n / (n·d)
# so the forward needs no differentiable trace and the backward is one SDF
# gradient at the hit points.


def kernel_scene_sdf(kscene: KernelScene, p: Tensor) -> Tensor:
    """The kernels' (boxes ∪ capsules) SDF in plain PyTorch, for the
    backward's normal query. p (S, R, 3) → (S, R)."""
    out = []
    for boxes, caps, pts in zip(kscene.boxes, kscene.capsules, p):
        d = prim_sdf(boxes[:, :12], pts)  # box rows are packed rows + the id column
        a, b, rad, active = caps[:, 0:3], caps[:, 3:6], caps[:, 6], caps[:, 7]
        pa = pts[:, None, :] - a
        ba = b - a
        h = torch.clamp(torch.sum(pa * ba, -1) / (torch.sum(ba * ba, -1) + 1e-9), 0.0, 1.0)
        diff = pa - ba * h[..., None]
        dc = torch.sqrt(torch.sum(diff * diff, -1) + 1e-12) - rad
        dc = torch.where(active > 0.5, dc, BIG)
        out.append(torch.minimum(d, torch.amin(dc, dim=-1)) if dc.shape[1] else d)
    return torch.stack(out)


def trace_ift_backward(kscene: KernelScene, origins: Tensor, dirs: Tensor, t: Tensor,
                       hit: Tensor, g_t: Tensor, packed: bool = False
                       ) -> Tuple[Tensor, Tensor]:
    """The implicit-function-theorem rule: (∂o, ∂d) of a loss whose gradient
    with respect to t is ``g_t``. Normal n = normalised autograd gradient of
    :func:`kernel_scene_sdf` at o + t·d, scale = 1/(n·d) where the ray hit
    and |n·d| > 1e-3 else 0, ∂o = −g_t·scale·n, ∂d = t·∂o. Rays and
    gradients are (3, S, R), or (S, R, 3) with ``packed``."""
    o, d = (origins, dirs) if packed else (origins.permute(1, 2, 0), dirs.permute(1, 2, 0))
    with torch.enable_grad():
        p_hit = (o + d * t[..., None]).detach().requires_grad_(True)
        (n,) = torch.autograd.grad(kernel_scene_sdf(kscene, p_hit).sum(), p_hit)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    denom = torch.sum(n * d, dim=-1)
    scale = torch.where(hit & (denom.abs() > 1e-3), 1.0 / denom, 0.0)
    d_o = -(g_t * scale)[..., None] * n
    d_d = d_o * t[..., None]
    return (d_o, d_d) if packed else (d_o.permute(2, 0, 1), d_d.permute(2, 0, 1))


class _TraceIFT(torch.autograd.Function):
    """Forward: a kernel wrapper in any mode. Backward:
    :func:`trace_ift_backward`; nothing for the scene, ``t_init``, ``hit``
    or ``kid``."""

    @staticmethod
    def forward(ctx, origins, dirs, t_init, kscene, packed, analytic, want_kid, kw):
        if analytic:
            out = trace_analytic(kscene, origins, dirs, kw["max_depth"], want_kid,
                                 kw["n_refine"], cull=kw["cull"], img_w=kw["img_w"])
        else:
            out = trace_march(kscene, origins, dirs, t_init, kw["n_steps"], kw["max_depth"],
                              EPS, kw["omega"], kw["cull"], packed, kw["img_w"])
            if want_kid:  # a march does not track the winner: −1 is "unknown"
                out = (*out, torch.full_like(out[0], -1.0))
        ctx.kscene, ctx.packed = kscene, packed
        ctx.save_for_backward(origins, dirs, out[0], out[1])
        ctx.mark_non_differentiable(*out[1:])
        return out

    @staticmethod
    def backward(ctx, g_t, *_):
        origins, dirs, t, hit = ctx.saved_tensors
        d_o, d_d = trace_ift_backward(ctx.kscene, origins, dirs, t, hit, g_t, ctx.packed)
        return d_o, d_d, None, None, None, None, None, None


def trace_diff(kscene: KernelScene, origins: Tensor, dirs: Tensor,
               t_init: Optional[Tensor] = None, n_steps: int = 40, max_depth: float = 20.0,
               omega: float = 1.0, cull: bool = True, analytic: bool = False,
               n_refine: int = 2, want_kid: bool = True, packed: bool = False,
               img_w: Optional[int] = None) -> Tuple[Tensor, ...]:
    """Differentiable trace → (t, hit[, kid]), the counterpart of
    ``pallas_trace_diff_c`` (component-major rays) and, with ``packed``, of
    ``pallas_trace_diff`` (march only). Gradients reach ``origins`` and
    ``dirs`` through t by the implicit function theorem, at the full scene's
    SDF whatever the forward culled, as the JAX backward takes it."""
    if packed and analytic:
        raise ValueError("packed rays take the march only")
    kw = dict(n_steps=n_steps, max_depth=max_depth, omega=omega, cull=cull, n_refine=n_refine,
              img_w=img_w)
    return _TraceIFT.apply(origins, dirs, t_init, kscene, packed, analytic, want_kid, kw)
