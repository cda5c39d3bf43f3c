"""First hit of rays on per-tile triangle lists: the CUDA kernels, their plain
PyTorch version and the wrapper (counterpart of the kernels ``_tri_kernel``,
``_tri_kernel_soup``, ``_tri_kernel_camsoup``, ``_tri_kernel_camsoup2``,
``_tri_kernel_camsoup_mx`` and ``_tri_kernel_worklist`` of
``visfly_tpu/render/tri_trace.py``, and of the two diagnostic copies
``examples/_tri_probe.py::_probe_kernel`` and
``examples/_tri_kernel_exp.py::make_kernel``).

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

Variants of the per-camera use (``mode``, ``form="sv_cam"`` only):

``"merged"``   the same lists, body and early-out; the kernel writes one
               float32 block ``(S, tiles, 2, 1024)`` of t and the id as a float
               (exact below 2²⁴) and no hit flag; the wrapper derives
               ``hit = t < max_depth``. On the TPU this halves a per-grid-step
               prologue paid per operand, which a GPU block does not have.
``"mx"``       the test as a matrix product a stage, ``W = D · G`` with
               ``D = [dx dy dz 1]`` (1,024 × 4) and ``G = [g0 | g1 | g2 | kt]``
               (4 × 4·chunk), from coefficients that subtract the origin
               first. The kernel takes the three volumes on the tensor cores
               (``wgmma`` in TF32 with float32 accumulation), each factor
               split into two TF32 parts (:func:`tf32_split`) and three of the
               four products summed, ``d_hi·g_hi + d_lo·g_hi + d_hi·g_lo``:
               the counterpart of the TPU kernel's ``Precision.HIGHEST``
               (:func:`sv_first_hit_tf32` models it; one TF32 pass would move
               hits by metres). kt is read, not multiplied, and ``1 / wsum``
               is the hardware's reciprocal with one Newton step (within an
               ulp of the division). Stages hold a multiple of 32 triangles.
               A ray's best is taken in (stage, slot) order with a strict
               less-than and the first strict minimum kept, as ``"scalar"``
               does; the TPU kernel's per-lane slabs give "first in stage
               order within a lane, then the smallest id across lanes", which
               can differ from it only on exact ties of t. The plain version
               takes the product with ``torch.matmul`` in full float32.

The worklist tier is a list mode, not a body: :class:`TileLists` with
``start`` set is a CSR list (one flattened array of stages a scene, per tile
an offset and a quota), walked by the ``"sv_tile"`` body.

Diagnostics: ``count_stages`` also returns, per tile, the stages that passed
the count skip and the early-out vote, summed over the tile's blocks;
``body=False`` (every stage is staged and one staged value read, no test runs:
every ray ends at ``max_depth``) and ``pin_stage=True`` (every stage loads the
list's first stage) knock parts of the merged kernel out, to split its time
into launch and barrier floor, staging and arithmetic. Both run on the list
walk that renders launch (B8a, B8b), unless a ``split`` of the cluster walk is
asked for.

The acceptance rules are the TPU kernels' to the constant: ``|det| > 1e-9``,
``t > 1e-4``; the three pairwise products of the volumes ``>= 0`` and
``t = kt · (1 / wsum)``, so that ±inf and NaN fail the comparisons.

:func:`tri_first_hit` launches a CUDA kernel on CUDA tensors (built at first
use, bound with ctypes) or raises, and runs :func:`tri_first_hit_reference`
on CPU tensors. Two kernels share the test (``csrc/tri_body.cuh``): the list
walk of ``csrc/tri_tile.cu`` takes the tile tiers (``form`` ``"sv_tile"`` or
``"mt"`` over lists of triangle ids, B4; :func:`tile_route`), the merged
per-camera tier (B7a), the worklist (B7c) and the two diagnostics
(:func:`list_route`); every other call goes to the cluster walk of
``csrc/tri_trace.cu``. The plain version
does the kernels' arithmetic in their order, stage by stage with the same count skip and occlusion
early-out per tile, except that the kernels fuse the per-test dot and cross
products (``__fmaf_rn``), and the matrix form takes its products in split
TF32 and votes on each lane's own best (which runs a few more stages, never a
different result): the two agree within the smoke's limits (1.6e-4 m at most
on path D's 23,040 triangles, 3.1e-4 m for mx).

The list walk splits a tile's rays, not its stages: each of its blocks takes
:data:`TILE_BLOCK_RAYS` of the tile's 1,024 rays and walks the whole list
with its own running best and early-out vote, over the tile's real slots only
(:func:`real_counts`; the slots past them hold no triangle the cull kept), its
tiles' blocks launched longest walk first where the lists carry an order
(:func:`longest_first`).
On B7a and B7c, where its blocks would not fill the card (a few cameras),
each block's rays are walked by :func:`stage_parts` blocks, each over every
``P``-th stage, merged by (t, list position) by the last to finish. Its
result is the sequential walk's, ``split = 1`` below: t and hit to the bit,
and the id of every ray that hits.

The split of the cluster walk: a tile's stages are walked by a cluster of
``split`` blocks (:func:`pick_split`), block ``c`` taking stages
``c, c + split, …`` with its own running best and list position a ray. After
every round of ``split`` stages the blocks exchange their bests, and a block
skips a stage whose bound lies past every ray's best in its own walk or past
the cluster's least best (a bound equal to it still runs, so a tie goes to the
earlier list position). At the end the blocks merge by (t, list position).
That is the sequential walk's first strict minimum: t and hit are those of
``split = 1`` to the bit, and so is the id of every ray that hits (a miss's id
is whatever its walk last kept). The tile, merged and worklist tiers do not
split: the list walk takes them (``PERF.md``, B4, B7a, B7c); the cluster walk
takes their lists, and the diagnostics, only where a caller asks for a
``split`` (the old design, timed beside the list walk; B7a's and B7c's lists
then launch in their ``order``). The Möller–Trumbore body tests the signs of u and v before it
divides (:func:`_mt_signs_pass`), which changes no result.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..core.math_utils import full_fp32_matmul

TILE = 1024
BIG = 1e9
MAX_CHUNK = 128  # triangles a stage: the kernel's staging buffer
MAX_SPLIT = 8  # blocks a tile: a thread-block cluster's portable limit
SPLIT_ROUNDS = 2  # rounds of resident blocks the split aims at (pick_split)
MX_GROUP = 32  # triangles a product of the matrix form: N = 96 columns, three volumes of 32
TILE_BLOCK_RAYS = 512  # rays a block of the list walk, 2 blocks a tile (csrc/tri_tile.cu)
MAX_STAGE_PARTS = 8  # stage shares a tile of the list walk (csrc/tri_tile.cu: kMaxStageParts)
STAGE_ROUNDS = 3  # rounds of resident blocks the list walk's stage shares aim at (stage_parts)
FORMS = {"mt": 0, "sv_tile": 1, "sv_cam": 1}  # the kernel's body: 0 kMT, 1 kSV
MODES = ("scalar", "merged", "mx")
# Launches of the CUDA kernels by the tier that asked for it, since the counts
# were last set to 0. The wrapper adds one where it launches and nowhere else.
# The two tile entries, "tri_trace_camsoup_merged", "tri_trace_worklist" and
# the two diagnostics, "tri_trace_probe" and "tri_trace_knockout", count the
# list walk (B4, B7a, B7c, B8a, B8b); the "*_cluster" entries count the cluster
# walk on those tiers' lists and the diagnostics, launched only where a caller
# asks for a split (no render does).
LAUNCHES = {"tri_trace_tile_sv": 0, "tri_trace_tile_mt": 0, "tri_trace_soup": 0,
            "tri_trace_camsoup": 0, "tri_trace_camsoup_merged": 0, "tri_trace_camsoup_mx": 0,
            "tri_trace_worklist": 0, "tri_trace_probe": 0, "tri_trace_knockout": 0,
            "tri_trace_tile_cluster": 0, "tri_trace_list_cluster": 0,
            "tri_trace_probe_cluster": 0, "tri_trace_knockout_cluster": 0}
# elements of the largest intermediate of the plain version
_PLAIN_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_name(form: str, block: int, mode: str = "scalar", worklist: bool = False) -> str:
    """The entry of ``LAUNCHES`` for a tier's launch: the worklist, the variant
    of the per-camera body, or, by body and entry size, a tile tier (lists of
    triangle ids) or a soup tier (lists of blocks). The two diagnostics count
    apart from the tiers (:func:`tri_first_hit`)."""
    if worklist:
        return "tri_trace_worklist"
    if mode != "scalar":
        return f"tri_trace_camsoup_{mode}"
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
    start    None, or (S, tiles) int32: the lists are one flattened array a
             scene (CSR), ``ids (S, NW · chunk // block)`` and ``lb (S, NW)``
             over ``NW`` stages, of which a tile owns ``n_stage`` from
             ``start`` on
    count    None, or (S, tiles) int32: a tile's real slots, those from the
             first slot of its list on that hold a triangle the cull kept (the
             list walk walks no slot past them; :func:`real_counts`)
    order    None, or (S · tiles,) int32: the tiles (``s · tiles + tile``)
             in the order the list walk launches their blocks, most real
             slots first (:func:`longest_first`); None: in index order
    """

    ids: Tensor
    n_stage: Tensor
    lb: Tensor
    chunk: int
    block: int
    start: Optional[Tensor] = None
    count: Optional[Tensor] = None
    order: Optional[Tensor] = None


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


def _mt_signs_pass(un: Tensor, vn: Tensor, det: Tensor) -> Tensor:
    """False where ``un / det`` or ``vn / det`` is negative for certain: the
    numerator's sign is not det's and its magnitude exceeds |det|·2⁻¹²⁵, so
    the quotient ``un · (1/det)`` is a negative normal number, never −0. The
    kernel divides only where this holds, and it rejects nothing that
    ``u >= 0`` and ``v >= 0`` accept."""
    sg = torch.copysign(torch.full_like(det, 2.0 ** 125), det)
    lim = -det.abs()
    return (un * sg >= lim) & (vn * sg >= lim)


def _test_mt(rows: Tensor, o, d) -> Tuple[Tensor, Tensor, Tensor]:
    """Möller–Trumbore t of rows (..., n, 1, 9-split) against rays (..., 1, r),
    BIG where a test fails; the tests past the determinant gate; and those of
    them past the sign test of u and v, the only ones for which the kernel
    divides. Every operation in the kernel's order: the division deferred
    changes no result."""
    a = tuple(rows[..., i, None] for i in (0, 1, 2))
    e1 = tuple(rows[..., i + 3, None] - rows[..., i, None] for i in range(3))
    e2 = tuple(rows[..., i + 6, None] - rows[..., i, None] for i in range(3))
    p = _cross(d, e2)
    det = _dot(e1, p)
    okd = det.abs() > 1e-9
    tv = _sub(o, a)
    un = _dot(tv, p)
    q = _cross(tv, e1)
    vn = _dot(d, q)
    divide = okd & _mt_signs_pass(un, vn, det)
    inv = 1.0 / torch.where(okd, det, 1.0)
    u = un * inv
    v = vn * inv
    tk = _dot(e2, q) * inv
    ok = divide & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tk > 1e-4)
    return torch.where(ok, tk, BIG), okd, divide


def _accept_sv(w0, w1, w2, kt) -> Tuple[Tensor, Tensor]:
    """t of the volumes that share a sign, BIG elsewhere; and the tests past
    that gate, twice: the gate and the tests for which the kernel divides are
    the same."""
    ok = (w0 * w1 >= 0.0) & (w0 * w2 >= 0.0) & (w1 * w2 >= 0.0)
    tk = kt * (1.0 / (w0 + w1 + w2))
    return torch.where(ok & (tk > 1e-4), tk, BIG), ok, ok


def _test_sv(coef, d) -> Tuple[Tensor, Tensor, Tensor]:
    """Signed-volume t of coefficients (g0, g1, g2 triples and kt, each
    component (..., n, 1)) against ray directions (..., 1, r), BIG where a
    test fails; and the tests past the sign gate (twice, as
    :func:`_accept_sv`)."""
    g0, g1, g2, kt = coef
    return _accept_sv(_dot(d, g0), _dot(d, g1), _dot(d, g2), kt)


def _test_sv_mx(coef, d) -> Tuple[Tensor, Tensor, Tensor]:
    """The same test as one matrix product: ``W = D · G`` with
    ``D = [dx dy dz 1]`` (..., r, 4) and ``G = [g0 | g1 | g2 | kt]``
    (..., 4, 4n), whose column blocks are the three volumes and kt."""
    g0, g1, g2, kt = coef
    zero = torch.zeros_like(kt)
    rows = [torch.cat([g0[r], g1[r], g2[r], zero], dim=-2) for r in range(3)]
    rows.append(torch.cat([zero, zero, zero, kt], dim=-2))
    G = torch.stack([x[..., 0] for x in rows], dim=-2)  # (..., 4, 4n)
    D = torch.stack([d[0][..., 0, :], d[1][..., 0, :], d[2][..., 0, :],
                     torch.ones_like(d[0][..., 0, :])], dim=-1)  # (..., r, 4)
    full_fp32_matmul()
    W = torch.matmul(D, G).transpose(-1, -2)  # (..., 4n, r)
    n = kt.shape[-2]
    return _accept_sv(*(W[..., i * n:(i + 1) * n, :] for i in range(4)))


def _tf32_rna(x: Tensor) -> Tensor:
    """float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest value with 10 mantissa bits, ties away from zero (half a TF32 ulp
    added to the magnitude's bits, the low 13 cleared), so the largest
    finite values round up to ±inf; ±0 and ±inf stay, NaN stays NaN."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, r)


def tf32_split(x: Tensor) -> Tuple[Tensor, Tensor]:
    """The matrix-form kernel's split of float32 ``x`` into two TF32 parts
    (``split_tf32`` of ``csrc/tri_trace.cu``): ``hi = rna(x)`` and ``lo`` the
    rounded rest, ``rna(|x| − |hi|)`` with x's sign (``|x| − |hi|`` is exact),
    so that ``|x − hi − lo| ≤ 2⁻²²·|x|`` and the split of ``−x`` is that of
    ``x`` negated, to the bit. A model for the tests and ``chip_smoke.py``."""
    x = x.to(torch.float32)
    hi = _tf32_rna(x)
    r = x.abs() - hi.abs()
    return hi, _tf32_rna(torch.where(torch.signbit(x), -r, r))


def _sv_volumes_tf32(d, g, passes: int) -> Tensor:
    """The volume ``d·g`` of direction and coefficient triples (component
    tensors that broadcast) as the matrix-form kernel forms it from TF32
    parts: ``passes = 3`` sums ``d_hi·g_hi + d_lo·g_hi + d_hi·g_lo``, the
    kernel's product, ``passes = 1`` only ``d_hi·g_hi`` (one TF32 pass).
    Products of TF32 parts are exact in float64; they are summed there and
    rounded once to float32 (a model of the tensor cores' accumulation, which
    aligns and truncates inside the unit)."""
    acc = 0.0
    for dc, gc in zip(d, g):
        dh, dl = (y.double() for y in tf32_split(dc))
        gh, gl = (y.double() for y in tf32_split(gc))
        acc = acc + dh * gh
        if passes == 3:
            acc = acc + dl * gh + dh * gl
    return acc.to(torch.float32)


def sv_first_hit_tf32(tris: Tensor, origin, dirs: Tensor, max_depth: float = 20.0,
                      passes: int = 3, slab: int = 256) -> Tuple[Tensor, Tensor]:
    """First hit of rays ``dirs`` (R, 3) from one origin (a triple of
    scalars or 0-d tensors) on every triangle of ``tris`` (T, 9), by signed
    volumes whose coefficients subtract the origin first (float32, as the
    kernel stages them) and whose volumes are :func:`_sv_volumes_tf32` →
    (t (R,) clipped to [0, max_depth], hit (R,)). The model of the
    matrix-form kernel with lists that hold the whole mesh; ties of t are
    not resolved (no id)."""
    best = torch.full((dirs.shape[0],), BIG, dtype=torch.float32, device=dirs.device)
    d = tuple(dirs[:, i, None] for i in range(3))  # (R, 1)
    for k0 in range(0, tris.shape[0], slab):
        g0, g1, g2, kt = sv_coefficients(tris[k0:k0 + slab], origin)
        w = [_sv_volumes_tf32(d, g, passes) for g in (g0, g1, g2)]
        tk, _, _ = _accept_sv(*w, kt)
        best = torch.minimum(best, tk.amin(-1))
    t = torch.clamp(best, 0.0, max_depth)
    return t, t < max_depth


def padded_lists(lists: TileLists) -> TileLists:
    """A CSR list as the padded lists it stands for: every tile gets as many
    stages as the longest tile owns, the rest empty slots with bound BIG."""
    if lists.start is None:
        return lists
    S, tiles = lists.n_stage.shape
    per = lists.chunk // lists.block
    dev = lists.ids.device
    n_max = max(int(lists.n_stage.max()), 1)
    own = torch.arange(n_max, device=dev) < lists.n_stage[..., None]  # (S, tiles, n_max)
    stage = torch.where(own, lists.start.to(torch.int64)[..., None]
                        + torch.arange(n_max, device=dev), 0)
    lb = torch.gather(lists.lb, 1, stage.reshape(S, -1)).reshape(S, tiles, n_max)
    slot = (stage[..., None] * per + torch.arange(per, device=dev)).reshape(S, -1)
    ids = torch.gather(lists.ids, 1, slot).reshape(S, tiles, n_max, per)
    ids = torch.where(own[..., None], ids, -1).reshape(S, tiles, n_max * per)
    return TileLists(ids, lists.n_stage, torch.where(own, lb, BIG), lists.chunk, lists.block)


def tri_first_hit_reference(tris: Tensor, lists: TileLists, origins_c: Tensor, dirs_c: Tensor,
                            max_depth: float = 20.0, form: str = "mt", origin_tiles: int = 1,
                            stats: dict = None, mode: str = "scalar", body: bool = True,
                            pin_stage: bool = False, split: int = 1, block_rays: int = TILE
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of the kernels → (t (S, R), hit (S, R), gid (S, R)
    int32), walked as the kernel walks it with ``split`` blocks a tile: block
    ``c`` takes stages ``c, c + split, …`` with its own running best, the
    blocks exchange their bests after every round of ``split`` stages, and
    their results merge by (t, list position) (module docstring). A stage is
    taken in slices so that the (S, tiles, slice, 1024) intermediates stay
    bounded.

    ``block_rays`` below :data:`TILE` (``split`` 1) is the list walk's own
    walk (``csrc/tri_tile.cu``, :data:`TILE_BLOCK_RAYS`): each block of
    ``block_rays`` consecutive rays of a tile votes on its own rays, over the
    tile's real slots only (:func:`real_counts`). The default, the whole tile,
    is the vote of the cluster walk at ``split = 1`` and of the JAX kernels.

    ``stats`` gains, over the stages that ran in all blocks: ``"tests"`` the
    ray–slot tests (empty slots of a stage included, as the kernel stages
    them), ``"real_tests"`` those against a triangle, ``"gated"`` those of
    them past the body's gate (the sign test of the volumes, or
    ``|det| > 1e-9``), ``"divided"`` those for which the kernel divides (past
    the sign test of the volumes, or of u and v), and ``"stages"`` the
    (S, tiles) int32 count of stages that ran, summed over a tile's blocks.
    ``mode``, ``body`` and ``pin_stage`` as in :func:`tri_first_hit`."""
    _, S, R = origins_c.shape
    tiles = R // TILE
    T = tris.shape[1]
    if not (1 <= block_rays <= TILE and TILE % block_rays == 0) or (block_rays < TILE
                                                                     and split != 1):
        raise ValueError(f"blocks of {block_rays} rays walk a tile's whole list: a divisor of "
                         f"{TILE}, with split 1; got split {split}")
    n_blocks = TILE // block_rays
    n_real = real_counts(lists, T).to(torch.int64) if n_blocks > 1 else None
    lists = padded_lists(lists)
    chunk, bs = lists.chunk, lists.block
    n_stage = lists.lb.shape[2]
    dev = origins_c.device
    if n_real is not None:  # the real slots of the tile's own stages
        n_real = torch.clamp(torch.minimum(n_real, torch.clamp(lists.n_stage, max=n_stage)
                                           .to(torch.int64) * chunk), min=0)
    o4 = origins_c.reshape(3, S, tiles, 1, TILE)
    d = tuple(dirs_c.reshape(3, S, tiles, 1, TILE))
    if form == "mt":
        o = tuple(o4)
    else:  # ray 0 of the tile, or of the camera the tile belongs to
        src = torch.arange(tiles, device=dev) // origin_tiles * origin_tiles
        o = tuple(o4[:, :, src, 0, 0])  # each (S, tiles)
    # per block: the running best and its list position (−1: none)
    tbest = torch.full((split, S, tiles, TILE), BIG, dtype=origins_c.dtype, device=dev)
    pbest = torch.full((split, S, tiles, TILE), -1, dtype=torch.int64, device=dev)
    xmin = torch.full((S, tiles, TILE), BIG, dtype=origins_c.dtype, device=dev)  # exchanged
    step = max(1, min(chunk, _PLAIN_ELEMS // max(S * tiles * TILE, 1)))
    within = torch.arange(bs, device=dev)
    slots = torch.arange(chunk, device=dev)
    ran = torch.zeros((S, tiles), dtype=torch.int32, device=dev)
    count = {"tests": 0, "real_tests": 0, "gated": 0, "divided": 0}
    test_sv = _test_sv_mx if mode == "mx" else _test_sv
    for m in range(-(-n_stage // split)):
        for c in range(split):
            ci = m * split + c
            if ci >= n_stage:
                break
            bound = lists.lb[:, :, ci]
            if split == 1:  # each block of the tile votes on its own rays
                worst = tbest[c].reshape(S, tiles, n_blocks, block_rays).amax(-1)
                run = bound[..., None] < torch.clamp(worst, max=max_depth)
            else:
                run = ((bound[..., None] < torch.clamp(tbest[c], max=max_depth))
                       & (bound[..., None] <= xmin)).any(-1, keepdim=True)
            run = run & (ci < lists.n_stage)[..., None]  # (S, tiles, blocks)
            ce = 0 if pin_stage else ci
            entry = lists.ids[:, :, ce * chunk // bs:(ce + 1) * chunk // bs].to(torch.int64)
            gid = torch.where(entry[..., None] < 0, -1, entry[..., None] * bs + within)
            gid = gid.reshape(S, tiles, chunk)
            real = (gid >= 0) & (gid < T)
            staged = torch.full((S, tiles), chunk, device=dev)
            if n_real is not None:  # the list walk stages the real slots only
                run = run & (ci * chunk < n_real)[..., None]
                real = real & (ce * chunk + slots < n_real[..., None])
                staged = torch.clamp(n_real - ce * chunk, 0, chunk)
            ran = ran + run.sum(-1).to(torch.int32)
            count["tests"] += int((run.sum(-1) * staged).sum()) * block_rays
            count["real_tests"] += int((run.sum(-1) * real.sum(-1)).sum()) * block_rays
            if not body:  # the knocked-out body stages its rows and accepts nothing
                continue
            run_ray = run.repeat_interleave(TILE // run.shape[-1], dim=-1)  # (S, tiles, TILE)
            gid = torch.where(real, gid, 0)
            for j0 in range(0, chunk, step):
                g = gid[:, :, j0:j0 + step]
                rows = torch.gather(tris, 1, g.reshape(S, -1, 1).expand(S, -1, 9))
                rows = rows.reshape(S, tiles, -1, 9)
                if form == "mt":
                    tk, gate, divide = _test_mt(rows, o, d)
                else:
                    g0, g1, g2, kt = sv_coefficients(rows, tuple(x[..., None] for x in o))
                    tk, gate, divide = test_sv(
                        (*(tuple(x[..., None] for x in g) for g in (g0, g1, g2)), kt[..., None]),
                        d)
                live = real[:, :, j0:j0 + step, None] & run_ray[:, :, None, :]
                count["gated"] += int((gate & live).sum())
                count["divided"] += int((divide & live).sum())
                tk = torch.where(live, tk, BIG)
                best, j = torch.min(tk, dim=2)  # the first minimum of the slice
                better = best < tbest[c]
                pbest[c] = torch.where(better, ci * chunk + j0 + j, pbest[c])
                tbest[c] = torch.where(better, best, tbest[c])
        if split > 1:
            xmin = tbest.amin(0)
    if split > 1:  # merge by (t, list position)
        live = pbest >= 0
        t_best = torch.where(live, tbest, BIG).amin(0)
        last = n_stage * chunk
        pos = torch.where(live & (tbest == t_best), pbest, last).amin(0)
        pos = torch.where(pos == last, -1, pos)
    else:
        t_best, pos = tbest[0], pbest[0]
    if stats is not None:
        for key, v in count.items():
            stats[key] = stats.get(key, 0) + v
        stats["stages"] = ran
    # the id of the winning list position (the pinned stage's slots for pin_stage)
    at = torch.clamp(pos, min=0)
    j = at % chunk
    slot = ((0 if pin_stage else at // chunk) * chunk + j) // bs
    entry = torch.gather(lists.ids.to(torch.int64), 2, slot.reshape(S, tiles, TILE))
    gbest = torch.where(pos >= 0, entry * bs + j % bs, 0)
    t = torch.clamp(t_best, 0.0, max_depth)
    if mode == "merged":  # through the kernel's one block of t and the id as a float
        block = torch.stack([t, gbest.to(t.dtype)], dim=2)  # (S, tiles, 2, 1024)
        t, gbest = block[:, :, 0], block[:, :, 1]
    t = t.reshape(S, R)
    return t, t < max_depth, gbest.reshape(S, R).to(torch.int32)


def pick_split(n_tiles: int, n_stage: int, slots: dict) -> int:
    """Blocks a tile of the cluster walk for a grid of ``n_tiles`` tiles of up
    to ``n_stage`` stages: the least ``k`` whose ``n_tiles · k`` blocks fill
    the card's resident blocks ``slots[k]`` (SMs × blocks an SM; with clusters
    of ``k``, resident clusters × ``k``) at least :data:`SPLIT_ROUNDS` times,
    so that the last round is a small share of the work; else the largest
    ``k`` allowed, at most :data:`MAX_SPLIT` and ``n_stage``. The rule sees
    the padded list length, not the stages each tile owns (those live on the
    card). The tile tiers do not split: they go to the tile kernel
    (:func:`tile_route`), because where most tiles own a stage or two of a
    short list the blocks past them only waited at the cluster's barriers
    (B4's signed-volume lists at 360 triangles, ``PERF.md``); the rule still
    gives the ``k`` the cluster walk would take on their lists."""
    k_max = max(1, min(MAX_SPLIT, n_stage))
    for k in range(1, k_max + 1):
        if n_tiles * k >= SPLIT_ROUNDS * slots[k]:
            return k
    return k_max


def tile_route(form: str, lists: TileLists, mode: str = "scalar", count_stages: bool = False,
               knockout: bool = False, split: Optional[int] = None) -> bool:
    """Whether a call on the card is B4 going to the list walk
    (``csrc/tri_tile.cu``, :data:`TILE_BLOCK_RAYS` a block): a tile tier
    (``form`` ``"sv_tile"`` or ``"mt"`` over padded lists of triangle ids),
    the scalar output, with or without the stage count, and no ``split``
    asked for. A tile tier at an explicit ``split`` goes to the cluster walk
    of ``csrc/tri_trace.cu`` (the design B4 had before, kept to be timed
    beside it); so do the soup, per-camera and matrix tiers. The merged and
    worklist tiers and the other diagnostics: :func:`list_route`."""
    return (form in ("sv_tile", "mt") and lists.block == 1 and lists.start is None
            and mode == "scalar" and not knockout and split is None)


def list_route(form: str, lists: TileLists, mode: str = "scalar", count_stages: bool = False,
               knockout: bool = False, split: Optional[int] = None) -> bool:
    """Whether a call on the card goes to the list walk (``csrc/tri_tile.cu``,
    :data:`TILE_BLOCK_RAYS` a block) and is not :func:`tile_route`'s: B7a,
    the merged per-camera tier (``mode="merged"``, ``form="sv_cam"``, padded
    block lists), with or without a knock-out (B8b); B7c, a CSR list (the
    worklist); and the stage count (B8a) of every tier of the scalar output,
    the soup (B5) and the per-camera tier (B6) among them; each with no
    ``split`` asked for. At an explicit ``split`` their lists go to the
    cluster walk (counted as ``tri_trace_list_cluster``,
    ``tri_trace_probe_cluster`` and ``tri_trace_knockout_cluster``); B6 and
    B5 without a count, and the matrix form, keep the cluster walk and the
    tensor-core kernel. The count of the merged output has no list walk: the
    wrapper refuses it without a ``split``."""
    if split is not None or tile_route(form, lists, mode, count_stages, knockout, split):
        return False
    if count_stages:
        return mode == "scalar"
    return ((mode == "merged" and form == "sv_cam" and lists.start is None)
            or (mode == "scalar" and lists.start is not None))


def real_counts(lists: TileLists, n_tris: int) -> Tensor:
    """(S, tiles) int32: the slots of each tile's list that the list walk
    walks, from the tile's first on. ``lists.count`` where the prepass handed
    it (``tile_lists``, ``walk_order`` for B7a's block lists, ``worklist_lists``
    of :mod:`~visfly_tpu_torch.render.tri_trace`: the slots of what the cull
    kept, at most the cap); else one past the last slot of the tile's
    ``n_stage`` stages that holds a triangle (an entry ``e`` holds slots
    ``e·block + j`` for ``j < block``, those below ``n_tris``), since an empty
    slot never hits. The kernel also stops at the tile's ``n_stage`` stages."""
    if lists.count is not None:
        return lists.count
    p = padded_lists(lists)  # a CSR list as its tiles' own stages
    bs = p.block
    dev = p.ids.device
    first = torch.arange(p.ids.shape[-1], dtype=torch.int64, device=dev) * bs  # an entry's slot 0
    entry = p.ids.to(torch.int64)
    last = first + torch.clamp(n_tris - entry * bs, max=bs)  # one past its last real slot
    walked = (torch.clamp(p.n_stage, max=p.lb.shape[-1]) * p.chunk).to(torch.int64)[..., None]
    real = (entry >= 0) & (entry * bs < n_tris) & (first < walked)
    return torch.where(real, torch.minimum(last, walked), 0).amax(-1).to(torch.int32)


def stage_parts(n_blocks: int, resident: int) -> int:
    """Stage shares a tile the list walk takes on B7a and B7c: the least
    ``P`` whose ``n_blocks · P`` blocks (``n_blocks``: tiles × blocks a tile's
    rays take) fill the card's ``resident`` blocks :data:`STAGE_ROUNDS` times,
    at most :data:`MAX_STAGE_PARTS`. A tile's ``P`` blocks of the same rays
    walk its stages ``c, c + P, …`` and the last to finish merges them by (t,
    list position): the sequential walk's first strict minimum. On the H100
    the least time at 8 to 256 cameras of path D fell where the grid first
    reached three rounds (``chip_profile.py sweep``; ``PERF.md`` §6); few
    tiles with long lists (8 cameras at ``cap = T``) leave the card idle
    without it."""
    for parts in range(1, MAX_STAGE_PARTS + 1):
        if n_blocks * parts >= STAGE_ROUNDS * resident:
            return parts
    return MAX_STAGE_PARTS if n_blocks else 1


def longest_first(counts: Tensor) -> Tensor:
    """(S · tiles,) int32: the tiles of ``counts`` (S, tiles), flattened to
    ``s · tiles + tile``, most real slots first and in index order among
    equals: the order in which the list walk launches their blocks, so that
    the longest walks start in the first round of resident blocks and the
    short ones fill the last (longest processing time first)."""
    return torch.argsort(counts.flatten(), descending=True, stable=True).to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _launchers():
    """(tri_trace_launch, tri_trace_mx_launch, tri_trace_occupancy) of the
    built library."""
    from ..build import load_library

    lib = load_library("tri_trace")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # tris list nst start order lb origins dirs t hit gid cnt | S T R n_stage chunk bs
    # origin_tiles | max_depth | form out knock split | stream
    lib.tri_trace_launch.argtypes = [p] * 12 + [i] * 7 + [f] + [i] * 4 + [p]
    # tris list nst lb origins dirs t hit gid cnt | S T R n_stage chunk origin_tiles |
    # max_depth | stream
    lib.tri_trace_mx_launch.argtypes = [p] * 10 + [i] * 6 + [f, p]
    # form out knock split | regs threads blocks_per_sm clusters
    lib.tri_trace_occupancy.argtypes = [i] * 4 + [p] * 4
    fns = (lib.tri_trace_launch, lib.tri_trace_mx_launch, lib.tri_trace_occupancy)
    for fn in fns:
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _tile_launchers():
    """(tri_tile_launch, tri_tile_occupancy) of the built list walk."""
    from ..build import load_library

    lib = load_library("tri_tile")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # tris list nst start cnt lb order origins dirs t hit gid part_t part_pos part_done
    # cnt_out | S T R n_stage chunk bs origin_tiles P | max_depth | form merged count knock |
    # stream
    lib.tri_tile_launch.argtypes = [p] * 16 + [i] * 8 + [f] + [i] * 4 + [p]
    # form merged count knock | regs threads rays blocks_per_sm
    lib.tri_tile_occupancy.argtypes = [i] * 4 + [p] * 4
    fns = (lib.tri_tile_launch, lib.tri_tile_occupancy)
    for fn in fns:
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def _tile_occupancy(device_index: int, form_id: int, merged: int, count: int, knock: int) -> dict:
    regs, threads, rays, per_sm = (ctypes.c_int() for _ in range(4))
    with torch.cuda.device(device_index):
        rc = _tile_launchers()[1](form_id, merged, count, knock,
                                  *(ctypes.addressof(x) for x in (regs, threads, rays, per_sm)))
    if rc != 0:
        raise RuntimeError(f"the occupancy query failed with CUDA error {rc}")
    return {"regs": regs.value, "threads": threads.value, "rays": rays.value,
            "blocks_per_sm": per_sm.value,
            "sms": torch.cuda.get_device_properties(device_index).multi_processor_count}


def _resident(dev, form: str, mode: str) -> int:
    """Blocks of the list walk the card holds at once."""
    occ = tile_occupancy(form, dev, mode)
    return occ["blocks_per_sm"] * occ["sms"]


def tile_occupancy(form: str = "mt", device=None, mode: str = "scalar",
                   count_stages: bool = False, knock: int = 0) -> dict:
    """What the card holds of the list walk of ``form`` (``mode`` "merged":
    its merged output; with the stage count, or the knock-out bits ``knock``,
    1 the body off and 2 the stage pinned): ``regs`` a thread, ``threads``
    and ``rays`` a block, ``blocks_per_sm`` and ``sms``."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _tile_occupancy(index, FORMS[form], int(mode == "merged"), int(count_stages), knock)


@functools.lru_cache(maxsize=None)
def _occupancy(device_index: int, form_id: int, out: int, knock: int) -> dict:
    query = _launchers()[2]
    regs, threads, per_sm, clusters = (ctypes.c_int() for _ in range(4))
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    slots = {}
    with torch.cuda.device(device_index):
        for k in range(1, MAX_SPLIT + 1):
            rc = query(form_id, out, knock, k, *(ctypes.addressof(x) for x in
                                                 (regs, threads, per_sm, clusters)))
            if rc != 0:
                raise RuntimeError(f"the occupancy query failed with CUDA error {rc}")
            slots[k] = per_sm.value * sms if k == 1 else clusters.value * k
    return {"regs": regs.value, "threads": threads.value, "blocks_per_sm": per_sm.value,
            "sms": sms, "slots": slots}


def occupancy(form: str = "mt", mode: str = "scalar", knock: int = 0, device=None) -> dict:
    """What the card holds of the instantiation of ``tri_trace_kernel`` that a
    call with ``form``, ``mode`` and knock-out bits ``knock`` launches:
    ``regs`` a thread, ``threads`` a block, ``blocks_per_sm``, ``sms`` and
    ``slots`` {k: blocks resident at once with clusters of k}."""
    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _occupancy(index, FORMS[form], int(mode == "merged"), knock)


def default_split(lists: TileLists, form: str, mode: str, device) -> int:
    """The blocks a tile the wrapper picks on the card (:func:`pick_split`):
    from the tiles of the call, its list length (for a CSR list the mean
    quota) and the card's resident blocks."""
    S, tiles = lists.n_stage.shape
    n_stage = lists.lb.shape[-1]
    if lists.start is not None:
        n_stage = max(1, n_stage // max(tiles, 1))
    return pick_split(S * tiles, n_stage, occupancy(form, mode, 0, device)["slots"])


def _check(tris: Tensor, lists: TileLists, origins_c: Tensor, dirs_c: Tensor, form: str,
           origin_tiles: int, mode: str = "scalar", knockout: bool = False) -> Tuple[int, int]:
    if form not in FORMS:
        raise ValueError(f"form must be one of {sorted(FORMS)}; got {form!r}")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}; got {mode!r}")
    if mode != "scalar" and (form != "sv_cam" or lists.start is not None
                             or lists.chunk != lists.block):
        raise ValueError(f"mode {mode!r} is a variant of the per-camera body over block lists "
                         f"(form 'sv_cam', one block a stage); got form {form!r}, chunk "
                         f"{lists.chunk}, block {lists.block}")
    if knockout and mode != "merged":
        raise ValueError("body=False and pin_stage=True knock out parts of the merged kernel "
                         f"(mode 'merged'); got mode {mode!r}")
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
    if mode == "mx" and chunk % MX_GROUP:
        raise ValueError(f"the matrix form takes stages of a multiple of {MX_GROUP} triangles "
                         f"(the columns of its tensor-core product); got {chunk}")
    n_stage = lists.lb.shape[-1]
    lead = (S,) if lists.start is not None else (S, tiles)
    if (tuple(lists.lb.shape) != (*lead, n_stage)
            or tuple(lists.n_stage.shape) != (S, tiles)
            or tuple(lists.ids.shape) != (*lead, n_stage * chunk // bs)
            or (lists.start is not None and tuple(lists.start.shape) != (S, tiles))):
        raise ValueError(f"lists do not fit {S} scenes of {tiles} tiles: ids "
                         f"{tuple(lists.ids.shape)}, n_stage {tuple(lists.n_stage.shape)}, lb "
                         f"{tuple(lists.lb.shape)}")
    if origin_tiles < 1 or tiles % origin_tiles:
        raise ValueError(f"{tiles} tiles are not whole cameras of {origin_tiles} tiles")
    if lists.count is not None and tuple(lists.count.shape) != (S, tiles):
        raise ValueError(f"count must be ({S}, {tiles}); got {tuple(lists.count.shape)}")
    if lists.order is not None and tuple(lists.order.shape) != (S * tiles,):
        raise ValueError(f"order must be ({S * tiles},); got {tuple(lists.order.shape)}")
    typed = [(tris, torch.float32), (origins_c, torch.float32), (dirs_c, torch.float32),
             (lists.lb, torch.float32), (lists.ids, torch.int32), (lists.n_stage, torch.int32)]
    typed += [(x, torch.int32) for x in (lists.start, lists.count, lists.order) if x is not None]
    for x, want in typed:
        if x.dtype != want:
            raise TypeError(f"expected {want}, got {x.dtype}")
        if x.device != origins_c.device:
            raise ValueError(f"all inputs must be on {origins_c.device}; got {x.device}")
    if origins_c.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the trace runs on cpu or cuda tensors, not {origins_c.device}")
    return S, R


def tri_first_hit(tris: Tensor, lists: TileLists, origins_c: Tensor, dirs_c: Tensor,
                  max_depth: float = 20.0, form: str = "mt", origin_tiles: int = 1,
                  mode: str = "scalar", count_stages: bool = False, body: bool = True,
                  pin_stage: bool = False, split: Optional[int] = None):
    """First hit of rays (3, S, R) over their tiles' lists → (t (S, R),
    hit (S, R) bool, gid (S, R) int32), and with ``count_stages`` a fourth
    tensor, the stages executed per tile (S, tiles) int32, summed over its
    blocks. CUDA tensors go through a CUDA kernel, CPU tensors through
    :func:`tri_first_hit_reference`. ``mode`` picks the variant of the
    per-camera body (module docstring); ``body=False`` and ``pin_stage=True``
    are the knock-outs of the merged kernel. ``split`` (1 to
    :data:`MAX_SPLIT`) is the blocks of the cluster walk that walk a tile;
    ``None`` picks it: on the card :func:`default_split`, except for the
    matrix form, which walks a tile as one block; on the CPU 1. Any ``split``
    gives the same t and hit to the bit and the same ids where a ray hits.
    On the card the tile, merged and worklist tiers and the two diagnostics
    go to the list walk where no ``split`` is asked for (:func:`tile_route`,
    :func:`list_route`), with the same result; the stage count is then the
    list walk's, each of a tile's blocks of :data:`TILE_BLOCK_RAYS` rays
    voting on its own rays, and the CPU counts it alike
    (:func:`tri_first_hit_reference` at that ``block_rays``). The count of the
    merged output asks for a ``split``. A launch adds one to ``LAUNCHES``: a
    knock-out to ``tri_trace_knockout``, else a counting launch to
    ``tri_trace_probe`` (the matrix form's to ``tri_trace_camsoup_mx``), each
    with ``_cluster`` at an explicit ``split``; else a tile tier at an
    explicit ``split`` to ``tri_trace_tile_cluster``, the merged or worklist
    tier at one to ``tri_trace_list_cluster`` (its tiles launched in
    ``lists.order``), else to the tier's entry (:func:`count_name`)."""
    knockout = not body or pin_stage
    S, R = _check(tris, lists, origins_c, dirs_c, form, origin_tiles, mode, knockout)
    if split is not None and not 1 <= split <= MAX_SPLIT:
        raise ValueError(f"split must be 1..{MAX_SPLIT} blocks a tile; got {split}")
    if mode == "mx" and split not in (None, 1):
        raise ValueError(f"the matrix form walks a tile as one block; got split {split}")
    if count_stages and mode == "merged" and split is None:
        raise ValueError("the list walk counts stages on the scalar output; the merged output's "
                         "count is the cluster walk's, at an explicit split")
    tile = tile_route(form, lists, mode, count_stages, knockout, split)
    walk = tile or list_route(form, lists, mode, count_stages, knockout, split)
    diag = count_stages or knockout
    dev = origins_c.device
    if dev.type == "cpu":
        stats = {}
        out = tri_first_hit_reference(tris, lists, origins_c, dirs_c, max_depth, form,
                                      origin_tiles, stats, mode, body, pin_stage, split or 1,
                                      TILE_BLOCK_RAYS if walk and diag else TILE)
        return (*out, stats["stages"]) if count_stages else out
    # B7a's and B7c's lists at an explicit split: the cluster walk in their order
    list_cluster = split is not None and not diag and list_route(form, lists, mode)
    if split is None and not walk:
        split = 1 if mode == "mx" else default_split(lists, form, mode, dev)
    n_tris = tris.shape[1]
    counts = real_counts(lists, n_tris) if walk else None
    order = lists.order if walk or list_cluster else None
    tensors = [tris, lists.ids, lists.n_stage, lists.lb, origins_c, dirs_c]
    tensors += [x for x in (lists.start, counts, order) if x is not None]
    for x in tensors:
        if not x.is_contiguous():
            raise ValueError("the triangle kernel takes contiguous tensors")
    tiles = R // TILE
    merged = mode == "merged"
    t = torch.empty((S, tiles, 2, TILE) if merged else (S, R), dtype=torch.float32, device=dev)
    hit = None if merged else torch.empty((S, R), dtype=torch.bool, device=dev)
    gid = None if merged else torch.empty((S, R), dtype=torch.int32, device=dev)
    stages = None
    if count_stages:  # the list walk: a slot a block of the tile's rays
        stages = torch.zeros((S, tiles, TILE // TILE_BLOCK_RAYS if walk else 1),
                             dtype=torch.int32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    if S and R:
        if diag and mode != "mx":
            count = "tri_trace_knockout" if knockout else "tri_trace_probe"
            count += "" if walk else "_cluster"
        else:
            count = count_name(form, lists.block, mode, lists.start is not None)
            if count in ("tri_trace_tile_sv", "tri_trace_tile_mt") and not tile:
                count = "tri_trace_tile_cluster"
            if list_cluster:
                count = "tri_trace_list_cluster"
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if walk:
                n_blocks = S * tiles * (TILE // TILE_BLOCK_RAYS)
                # the knock-outs take the stage shares of B7a's own launch
                parts = (1 if tile or count_stages
                         else stage_parts(n_blocks, _resident(dev, form, mode)))
                part_t = part_pos = part_done = None
                if parts > 1:  # the stage shares' results, and a zeroed counter a tile's rays
                    part_t = torch.empty(S * tiles * parts * TILE, dtype=torch.float32,
                                         device=dev)
                    part_pos = torch.empty(S * tiles * parts * TILE, dtype=torch.int32,
                                           device=dev)
                    part_done = torch.zeros(n_blocks, dtype=torch.int32, device=dev)
                rc = _tile_launchers()[0](
                    tris.data_ptr(), lists.ids.data_ptr(), lists.n_stage.data_ptr(),
                    ptr(lists.start), counts.data_ptr(), lists.lb.data_ptr(), ptr(order),
                    origins_c.data_ptr(), dirs_c.data_ptr(), ptr(t), ptr(hit), ptr(gid),
                    ptr(part_t), ptr(part_pos), ptr(part_done), ptr(stages), S, n_tris, R,
                    lists.lb.shape[-1], lists.chunk, lists.block, int(origin_tiles), parts,
                    float(max_depth), FORMS[form], int(merged), int(count_stages),
                    int(not body) + 2 * int(pin_stage), stream)
            elif mode == "mx":
                rc = _launchers()[1](
                    tris.data_ptr(), lists.ids.data_ptr(), lists.n_stage.data_ptr(),
                    lists.lb.data_ptr(), origins_c.data_ptr(), dirs_c.data_ptr(), ptr(t),
                    ptr(hit), ptr(gid), ptr(stages), S, n_tris, R, lists.lb.shape[-1],
                    lists.chunk, int(origin_tiles), float(max_depth), stream)
            else:
                rc = _launchers()[0](
                    tris.data_ptr(), lists.ids.data_ptr(), lists.n_stage.data_ptr(),
                    ptr(lists.start), ptr(order), lists.lb.data_ptr(), origins_c.data_ptr(),
                    dirs_c.data_ptr(), ptr(t), ptr(hit), ptr(gid), ptr(stages), S, n_tris, R,
                    lists.lb.shape[-1], lists.chunk, lists.block, int(origin_tiles),
                    float(max_depth), FORMS[form], int(merged),
                    int(not body) + 2 * int(pin_stage), int(split), stream)
            LAUNCHES[count] += 1
        if rc != 0:
            raise RuntimeError(f"{count} kernel launch failed with CUDA error {rc}")
    if merged:
        t, gid = t[:, :, 0].reshape(S, R), t[:, :, 1].reshape(S, R).to(torch.int32)
        hit = t < max_depth
    if count_stages:
        stages = stages.sum(-1, dtype=torch.int32)
    return (t, hit, gid, stages) if count_stages else (t, hit, gid)
