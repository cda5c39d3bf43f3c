"""First hit of rays on per-tile triangle lists: the CUDA kernel, its plain
PyTorch version and the wrapper (counterpart of the three kernels
``_tri_kernel``, ``_tri_kernel_soup`` and ``_tri_kernel_camsoup`` of
``visfly_tpu/render/tri_trace.py``).

Rays come component-major ``(3, S, R)`` with ``R`` a multiple of ``TILE``
(1,024); tile ``i`` of a scene is rays ``[i·1024, (i+1)·1024)``. Each tile has
a list (:class:`TileLists`) of entries into the scene's triangle soup
``(S, T, 9)``, walked in stages of ``chunk`` triangles. For every ray the
result is the smallest accepted t over its tile's list, clipped to
``[0, max_depth]``, ``hit = t < max_depth`` and the id of the winning triangle
(the first strict minimum in list order; 0 where nothing was accepted).

Three uses of two bodies (``form``):

``"mt"``       Möller–Trumbore on the raw rows with per-ray origins (the
               ``shared_origin=False`` body of ``_tri_kernel``, and the soup
               kernel);
``"sv_tile"``  signed volumes against the tile's one origin, its ray 0 (the
               ``shared_origin=True`` body, coefficients as at
               ``tri_trace.py:743-754``);
``"sv_cam"``   the same body against the camera's origin, ray 0 of the
               ``origin_tiles`` tiles that make a camera (the per-camera
               kernel over ``_sv_pages``).

The per-camera tier of the JAX package expands its coefficients as
``g0 = b×c + o×(b − c)`` so that ``b×c`` is computed once for all cameras.
Nothing is shared between cameras here (a triangle's coefficients are made
where it is staged), and that form multiplies world coordinates before it
subtracts: in float32, on a garage mesh moved 40 m from the origin, it
moved t by up to 0.16 m (``chip_profile.py sv``). So ``"sv_cam"`` subtracts the origin first,
as ``"sv_tile"`` does; the two differ in the origin and the lists.

The acceptance rules are the TPU kernels' to the constant: ``|det| > 1e-9``,
``t > 1e-4``; the three pairwise products of the volumes ``>= 0`` and
``t = kt · (1 / wsum)``, so that ±inf and NaN fail the comparisons.

:func:`tri_first_hit` launches ``csrc/tri_trace.cu`` on CUDA tensors (built at
first use, bound with ctypes) or raises, and runs
:func:`tri_first_hit_reference` on CPU tensors. The plain version does the
kernel's arithmetic in the kernel's order, stage by stage with the same count
skip and occlusion early-out per tile, so on one device the two agree to the
bit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
from torch import Tensor

TILE = 1024
BIG = 1e9
MAX_CHUNK = 128  # triangles a stage: the kernel's staging buffer
FORMS = {"mt": 0, "sv_tile": 1, "sv_cam": 1}  # the kernel's body: 0 kMT, 1 kSV
# Launches of the CUDA kernel by the tier that asked for it, since the counts
# were last set to 0. The wrapper adds one where it launches and nowhere else.
LAUNCHES = {"tri_trace_tile_sv": 0, "tri_trace_tile_mt": 0, "tri_trace_soup": 0,
            "tri_trace_camsoup": 0}
# elements of the largest intermediate of the plain version
_PLAIN_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_name(form: str, block: int) -> str:
    """The entry of ``LAUNCHES`` for a body and an entry size: lists of
    triangle ids are the tile tiers, lists of blocks the soup tiers."""
    if form == "sv_cam":
        return "tri_trace_camsoup"
    if form == "sv_tile":
        return "tri_trace_tile_sv"
    return "tri_trace_tile_mt" if block == 1 else "tri_trace_soup"


class TileLists(NamedTuple):
    """What a cull prepass hands the kernel.

    ids      (S, tiles, n_stage · chunk // block) int32 entry ids in walking
             order, nearest first; entry ``e`` is triangles
             ``[e·block, (e+1)·block)`` of the soup; −1 is an empty slot
    n_stage  (S, tiles) int32 stages to walk (the count skip)
    lb       (S, tiles, n_stage) float32 lower bound on any hit t of a stage
             (the occlusion early-out)
    chunk    triangles a stage
    block    triangles an entry
    """

    ids: Tensor
    n_stage: Tensor
    lb: Tensor
    chunk: int
    block: int


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------


def _cross(a, b):
    """Cross product of component triples, each product rounded on its own."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def sv_coefficients(rows: Tensor, o):
    """Signed-volume coefficients (g0, g1, g2, kt) of triangle rows (..., 9)
    against origins ``o`` (a triple broadcastable to (...)):
    ``g0 = (b − o)×(c − o)`` and so on, ``kt = (a − o)·g0``."""
    a_ = _sub(tuple(rows[..., i] for i in (0, 1, 2)), o)
    b_ = _sub(tuple(rows[..., i] for i in (3, 4, 5)), o)
    c_ = _sub(tuple(rows[..., i] for i in (6, 7, 8)), o)
    g0, g1, g2 = _cross(b_, c_), _cross(c_, a_), _cross(a_, b_)
    return g0, g1, g2, _dot(a_, g0)


def _test_mt(rows: Tensor, o, d) -> Tuple[Tensor, Tensor]:
    """Möller–Trumbore t of rows (..., n, 1, 9-split) against rays (..., 1, r),
    BIG where a test fails; and the tests past the determinant gate, the only
    ones for which the kernel divides."""
    a = tuple(rows[..., i, None] for i in (0, 1, 2))
    e1 = tuple(rows[..., i + 3, None] - rows[..., i, None] for i in range(3))
    e2 = tuple(rows[..., i + 6, None] - rows[..., i, None] for i in range(3))
    p = _cross(d, e2)
    det = _dot(e1, p)
    okd = det.abs() > 1e-9
    inv = 1.0 / torch.where(okd, det, 1.0)
    tv = _sub(o, a)
    u = _dot(tv, p) * inv
    q = _cross(tv, e1)
    v = _dot(d, q) * inv
    tk = _dot(e2, q) * inv
    ok = okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tk > 1e-4)
    return torch.where(ok, tk, BIG), okd


def _test_sv(coef, d) -> Tuple[Tensor, Tensor]:
    """Signed-volume t of coefficients (g0, g1, g2 triples and kt, each
    component (..., n, 1)) against ray directions (..., 1, r), BIG where a
    test fails; and the tests past the sign gate, the only ones for which the
    kernel divides."""
    g0, g1, g2, kt = coef
    w0, w1, w2 = _dot(d, g0), _dot(d, g1), _dot(d, g2)
    ok = (w0 * w1 >= 0.0) & (w0 * w2 >= 0.0) & (w1 * w2 >= 0.0)
    tk = kt * (1.0 / (w0 + w1 + w2))
    return torch.where(ok & (tk > 1e-4), tk, BIG), ok


def tri_first_hit_reference(tris: Tensor, lists: TileLists, origins_c: Tensor, dirs_c: Tensor,
                            max_depth: float = 20.0, form: str = "mt", origin_tiles: int = 1,
                            stats: dict = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernel → (t (S, R), hit (S, R), gid (S, R)
    int32). A stage is taken in slices so that the (S, tiles, slice, 1024)
    intermediates stay bounded. ``stats`` gains, over the stages that ran:
    ``"tests"`` the ray–slot tests (empty slots of a stage included, as the
    kernel stages them), ``"real_tests"`` those against a triangle, and
    ``"gated"`` those of them past the body's gate (the sign test of the
    volumes, or ``|det| > 1e-9``), after which the division and the rest of
    the test run."""
    _, S, R = origins_c.shape
    tiles = R // TILE
    T = tris.shape[1]
    chunk, bs = lists.chunk, lists.block
    n_stage = lists.lb.shape[2]
    dev = origins_c.device
    o4 = origins_c.reshape(3, S, tiles, 1, TILE)
    d = tuple(dirs_c.reshape(3, S, tiles, 1, TILE))
    if form == "mt":
        o = tuple(o4)
    else:  # ray 0 of the tile, or of the camera the tile belongs to
        src = torch.arange(tiles, device=dev) // origin_tiles * origin_tiles
        o = tuple(o4[:, :, src, 0, 0])  # each (S, tiles)
    tbest = torch.full((S, tiles, TILE), BIG, dtype=origins_c.dtype, device=dev)
    gbest = torch.zeros((S, tiles, TILE), dtype=torch.int64, device=dev)
    step = max(1, min(chunk, _PLAIN_ELEMS // max(S * tiles * TILE, 1)))
    within = torch.arange(bs, device=dev)
    for ci in range(n_stage):
        worst = torch.clamp(tbest.amax(-1), max=max_depth)
        run = (ci < lists.n_stage) & (lists.lb[:, :, ci] < worst)  # (S, tiles)
        if stats is not None:
            stats["tests"] = stats.get("tests", 0) + int(run.sum()) * chunk * TILE
        entry = lists.ids[:, :, ci * chunk // bs:(ci + 1) * chunk // bs].to(torch.int64)
        gid = torch.where(entry[..., None] < 0, -1, entry[..., None] * bs + within)
        gid = gid.reshape(S, tiles, chunk)
        real = (gid >= 0) & (gid < T)
        gid = torch.where(real, gid, 0)
        for j0 in range(0, chunk, step):
            g = gid[:, :, j0:j0 + step]
            rows = torch.gather(tris, 1, g.reshape(S, -1, 1).expand(S, -1, 9))
            rows = rows.reshape(S, tiles, -1, 9)
            if form == "mt":
                tk, gate = _test_mt(rows, o, d)
            else:
                g0, g1, g2, kt = sv_coefficients(rows, tuple(x[..., None] for x in o))
                tk, gate = _test_sv((*(tuple(x[..., None] for x in g) for g in (g0, g1, g2)),
                                     kt[..., None]), d)
            live = real[:, :, j0:j0 + step, None]
            if stats is not None:
                live_run = live & run[:, :, None, None]
                stats["real_tests"] = stats.get("real_tests", 0) + int(live_run.sum()) * TILE
                stats["gated"] = stats.get("gated", 0) + int((gate & live_run).sum())
            tk = torch.where(live, tk, BIG)
            best, j = torch.min(tk, dim=2)  # the first minimum of the slice
            better = (best < tbest) & run[..., None]
            gbest = torch.where(better, torch.gather(g, 2, j), gbest)
            tbest = torch.where(better, best, tbest)
    t = torch.clamp(tbest, 0.0, max_depth).reshape(S, R)
    return t, t < max_depth, gbest.reshape(S, R).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launcher():
    from ..build import load_library

    fn = load_library("tri_trace").tri_trace_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # tris list nst lb origins dirs t hit gid | S T R n_stage chunk bs origin_tiles |
    # max_depth | form stream
    fn.argtypes = [p] * 9 + [i] * 7 + [f, i, p]
    fn.restype = ctypes.c_int
    return fn


def _check(tris: Tensor, lists: TileLists, origins_c: Tensor, dirs_c: Tensor, form: str,
           origin_tiles: int) -> Tuple[int, int]:
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}; got {form!r}")
    if origins_c.dim() != 3 or origins_c.shape[0] != 3 or dirs_c.shape != origins_c.shape:
        raise ValueError(f"rays must be (3, S, R); got {tuple(origins_c.shape)} and "
                         f"{tuple(dirs_c.shape)}")
    _, S, R = origins_c.shape
    if R % TILE:
        raise ValueError(f"rays per scene ({R}) must be a multiple of {TILE}")
    tiles = R // TILE
    if tris.dim() != 3 or tris.shape[0] != S or tris.shape[2] != 9:
        raise ValueError(f"triangles must be ({S}, T, 9); got {tuple(tris.shape)}")
    chunk, bs = lists.chunk, lists.block
    if not (1 <= chunk <= MAX_CHUNK and bs >= 1 and chunk % bs == 0):
        raise ValueError(f"a stage takes 1..{MAX_CHUNK} triangles in whole entries; got "
                         f"chunk {chunk}, block {bs}")
    n_stage = lists.lb.shape[-1]
    if (tuple(lists.lb.shape) != (S, tiles, n_stage)
            or tuple(lists.n_stage.shape) != (S, tiles)
            or tuple(lists.ids.shape) != (S, tiles, n_stage * chunk // bs)):
        raise ValueError(f"lists do not fit {S} scenes of {tiles} tiles: ids "
                         f"{tuple(lists.ids.shape)}, n_stage {tuple(lists.n_stage.shape)}, lb "
                         f"{tuple(lists.lb.shape)}")
    if origin_tiles < 1 or tiles % origin_tiles:
        raise ValueError(f"{tiles} tiles are not whole cameras of {origin_tiles} tiles")
    for x, want in ((tris, torch.float32), (origins_c, torch.float32), (dirs_c, torch.float32),
                    (lists.lb, torch.float32), (lists.ids, torch.int32),
                    (lists.n_stage, torch.int32)):
        if x.dtype != want:
            raise TypeError(f"expected {want}, got {x.dtype}")
        if x.device != origins_c.device:
            raise ValueError(f"all inputs must be on {origins_c.device}; got {x.device}")
    if origins_c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the trace runs on cpu or cuda tensors, not {origins_c.device}")
    return S, R


def tri_first_hit(tris: Tensor, lists: TileLists, origins_c: Tensor, dirs_c: Tensor,
                  max_depth: float = 20.0, form: str = "mt", origin_tiles: int = 1
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """First hit of rays (3, S, R) over their tiles' lists → (t (S, R),
    hit (S, R) bool, gid (S, R) int32). CUDA tensors go through the CUDA
    kernel, CPU tensors through :func:`tri_first_hit_reference`. A launch
    adds one to ``LAUNCHES[count_name(form, lists.block)]``."""
    S, R = _check(tris, lists, origins_c, dirs_c, form, origin_tiles)
    dev = origins_c.device
    if dev.type == "cpu":
        return tri_first_hit_reference(tris, lists, origins_c, dirs_c, max_depth, form,
                                       origin_tiles)
    for x in (tris, lists.ids, lists.n_stage, lists.lb, origins_c, dirs_c):
        if not x.is_contiguous():
            raise ValueError("the triangle kernel takes contiguous tensors")
    t = torch.empty((S, R), dtype=torch.float32, device=dev)
    hit = torch.empty((S, R), dtype=torch.bool, device=dev)
    gid = torch.empty((S, R), dtype=torch.int32, device=dev)
    if S and R:
        launch = _launcher()
        count = count_name(form, lists.block)
        with torch.cuda.device(dev):
            rc = launch(tris.data_ptr(), lists.ids.data_ptr(), lists.n_stage.data_ptr(),
                        lists.lb.data_ptr(), origins_c.data_ptr(), dirs_c.data_ptr(),
                        t.data_ptr(), hit.data_ptr(), gid.data_ptr(), S, tris.shape[1], R,
                        lists.lb.shape[2], lists.chunk, lists.block, int(origin_tiles),
                        float(max_depth), FORMS[form],
                        torch.cuda.current_stream(dev).cuda_stream)
            LAUNCHES[count] += 1
        if rc != 0:
            raise RuntimeError(f"{count} kernel launch failed with CUDA error {rc}")
    return t, hit, gid
