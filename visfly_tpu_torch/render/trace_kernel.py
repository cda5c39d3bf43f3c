"""Analytic ray trace: the CUDA kernel, its plain PyTorch version and the
kernel's scene view (counterpart of ``visfly_tpu/render/pallas_trace.py``).

``trace_analytic`` is the entry the renderer calls. On CUDA tensors it
launches ``csrc/trace_analytic.cu`` (built at first use, bound with ctypes)
or raises; on CPU tensors it runs ``trace_analytic_reference``, which
computes the same function with ``(R, K)`` broadcasting. Both take rays
component-major, ``(3, S, R)``, and return ``t (S, R)`` float32 and
``hit (S, R)`` bool, with ``t = clamp(min_k t_k, 0, max_depth)`` and
``hit = t < max_depth``.

The JAX kernel this replaces runs its tile body with ``analytic=True`` and
``n_refine=0``: no final residual SDF evaluation (``_march(final_eval=
False)``), which the plain version mirrors. The march mode, the residual
refine and the winning-primitive id are not ported yet.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from ..scene.prim_scene import PrimitiveScene

BIG = 1e9
BOX_COLS = 13
CAP_COLS = 9
# Launches of the CUDA kernel since the count was last set to 0. The
# wrapper adds one where it launches and nowhere else.
LAUNCHES = 0


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
    inv_denom = 1.0 / (bax * bax + bay * bay + baz * baz + 1e-9)
    h = torch.clamp((oax * bax + oay * bay + oaz * baz) * inv_denom, 0.0, 1.0)
    ex, ey, ez = oax - bax * h, oay - bay * h, oaz - baz * h
    d0 = torch.sqrt(ex * ex + ey * ey + ez * ez + 1e-12)
    inside = d0 <= rad + 0.05
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


def trace_analytic_reference(kscene: KernelScene, origins_c: Tensor, dirs_c: Tensor,
                             max_depth: float = 20.0, chunk: int = 1 << 18
                             ) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of the kernel: the same formulas in the same
    order, broadcast over (rays, rows). Rays go in chunks of ``chunk`` to
    bound the (r, K) intermediates."""
    _, S, R = origins_c.shape
    t = torch.empty((S, R), dtype=torch.float32, device=origins_c.device)
    for s in range(S):
        boxes, caps = kscene.boxes[s], kscene.capsules[s]
        for r0 in range(0, R, chunk):
            o = tuple(origins_c[i, s, r0:r0 + chunk, None] for i in range(3))
            d = tuple(dirs_c[i, s, r0:r0 + chunk, None] for i in range(3))
            tk = torch.cat([_box_t(boxes, o, d), _capsule_t(caps, o, d)], dim=1)
            t0 = torch.clamp(torch.amin(tk, dim=1), max=max_depth)
            t[s, r0:r0 + chunk] = torch.clamp(t0, 0.0, max_depth)
    return t, t < max_depth


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launcher():
    from ..build import load_library

    fn = load_library("trace_analytic").trace_analytic_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                               ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(kscene: KernelScene, origins_c: Tensor, dirs_c: Tensor) -> None:
    boxes, caps = kscene.boxes, kscene.capsules
    if origins_c.dim() != 3 or origins_c.shape[0] != 3 or dirs_c.shape != origins_c.shape:
        raise ValueError(f"rays must be (3, S, R); got {tuple(origins_c.shape)} and "
                         f"{tuple(dirs_c.shape)}")
    S = origins_c.shape[1]
    if (boxes.dim() != 3 or boxes.shape[0] != S or boxes.shape[2] != BOX_COLS
            or caps.dim() != 3 or caps.shape[0] != S or caps.shape[2] != CAP_COLS):
        raise ValueError(f"kernel scene must be boxes (S, KB, {BOX_COLS}) and capsules "
                         f"(S, KC, {CAP_COLS}) with S = {S}; got {tuple(boxes.shape)} and "
                         f"{tuple(caps.shape)}")
    for x in (boxes, caps, origins_c, dirs_c):
        if x.dtype != torch.float32:
            raise TypeError(f"trace_analytic takes float32 tensors; got {x.dtype}")
        if x.device != origins_c.device:
            raise ValueError(f"all inputs must be on {origins_c.device}; got {x.device}")


def trace_analytic(kscene: KernelScene, origins_c: Tensor, dirs_c: Tensor,
                   max_depth: float = 20.0) -> Tuple[Tensor, Tensor]:
    """First hit of rays (3, S, R) against each scene's rows → (t (S, R),
    hit (S, R)). CUDA tensors go through the CUDA kernel, CPU tensors through
    :func:`trace_analytic_reference`."""
    global LAUNCHES
    _check(kscene, origins_c, dirs_c)
    dev = origins_c.device
    if dev.type == "cpu":
        return trace_analytic_reference(kscene, origins_c, dirs_c, max_depth)
    if dev.type != "cuda":
        raise ValueError(f"trace_analytic runs on cpu or cuda tensors, not {dev}")
    boxes, caps = kscene.boxes, kscene.capsules
    for x in (boxes, caps, origins_c, dirs_c):
        if not x.is_contiguous():
            raise ValueError("trace_analytic takes contiguous tensors")
    _, S, R = origins_c.shape
    KB, KC = boxes.shape[1], caps.shape[1]
    smem = (KB * BOX_COLS + KC * CAP_COLS) * 4
    if smem > 48 * 1024:
        raise ValueError(f"scene rows need {smem} bytes of shared memory; the kernel "
                         "takes at most 48 KiB")
    t = torch.empty((S, R), dtype=torch.float32, device=dev)
    hit = torch.empty((S, R), dtype=torch.bool, device=dev)
    if S == 0 or R == 0:
        return t, hit
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(boxes.data_ptr(), caps.data_ptr(), origins_c.data_ptr(),
                    dirs_c.data_ptr(), t.data_ptr(), hit.data_ptr(),
                    S, R, KB, KC, float(max_depth), stream)
        LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"trace_analytic kernel launch failed with CUDA error {rc}")
    return t, hit
