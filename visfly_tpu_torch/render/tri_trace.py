"""Exact triangle-mesh ray tracing (counterpart of
``visfly_tpu/render/tri_trace.py``).

An imported stage renders as its true triangles: per 1,024-ray tile a cull
prepass (plain PyTorch, as it is plain XLA in the JAX package) keeps the
``cap`` nearest triangles, or blocks of triangles, that the tile can see, and
a kernel (``render/tri_kernel.py``: the list walk of ``csrc/tri_tile.cu`` or
the cluster walk of ``csrc/tri_trace.cu``) finds each ray's
first hit on its tile's list and the id of the winning triangle; normals
follow from the id by one gather.

* :func:`tri_trace_brute` — every ray against every triangle
  (Möller–Trumbore), the reference of the tests and the path for ray counts
  that are no multiple of 1,024.
* :func:`tri_trace_tiled` — the tiers of ``tri_trace_pallas``, picked by mesh
  size: ``T ≤ 2,048`` per-triangle lists; up to ``soup_min_t`` lists of
  Morton-ordered 64-triangle clusters (both through the kernel's signed-volume
  body on camera tiles, Möller–Trumbore otherwise); above it lists of
  128-triangle blocks, with per-camera signed volumes for whole cameras and
  Möller–Trumbore for other ray sets. Whole cameras wider than 32 pixels
  are first repacked into 32×32-pixel tiles. ``variant`` picks how that
  per-camera tier runs, and changes nothing on a mesh or a ray set that
  does not reach it: ``"scalar"``; ``"merged"`` (one merged output block);
  ``"mx"`` (the test as a matrix product); ``"wl"`` (16-triangle clusters on
  a flattened worklist under a budget, against each tile's own origin). The
  JAX package picks it with a module global; here it is an argument.
  ``soup_cluster`` likewise sets the block size of that tier's lists (the
  JAX package's ``_SOUP_CLUSTER_OVERRIDE``); a block larger than a kernel
  stage reaches the kernel as consecutive stage-sized blocks.
* :func:`stage_stats` and :func:`knockout_trace` — the diagnostics: stages
  executed per tile, and the merged per-camera kernel with its body or its
  staging traffic knocked out, both on the list walk that renders launch.
* :func:`tri_trace_diff` — differentiable in the rays: the hit surface is a
  plane, so ∂t/∂o = −n/(n·d) and ∂t/∂d = −t·n/(n·d) exactly; no kernel runs
  backward.

Overflow: a tile that sees more than ``cap`` keeps the ``cap`` triangles or
blocks whose centres are nearest its apex. A ray whose first hit lies in a
dropped block (a large floor block whose centre is far, say) sees the next
kept surface behind it, or background: the image is exact only on tiles
within the cap. The tile is the unit of that choice, which is why the tile
size and the repack are part of the function and not of the kernel's
schedule.

The thresholds between tiers are arguments, so a test reaches every tier
with a small mesh.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from .tri_kernel import (BIG, MAX_CHUNK, TILE, TILE_BLOCK_RAYS, TileLists, longest_first,
                         tri_first_hit)

CLUSTER = 64  # triangles per cull cluster of the two-level path
CLUSTER_CULL_MIN_T = 2048  # above: cull whole clusters, not triangles
SHARED_SOUP_MIN_T = 16384  # above: lists of blocks into the shared soup
STAGE = 64  # triangles a kernel stage for caps up to 1,024, twice that above
VARIANTS = ("scalar", "merged", "mx", "wl")
WL_CLUSTER = 16  # triangles a cull cluster of the worklist tier
WL_CHUNK = 128  # triangles a worklist stage: eight clusters


def default_tri_cap(n_tris: int) -> int:
    """Default per-tile ``cap`` by mesh size: 256 for meshes that cull per
    triangle (stages are a few large walls and floors), a quarter of the mesh
    in whole clusters, at least 1,024, for dense ones."""
    if n_tris <= CLUSTER_CULL_MIN_T:
        return min(n_tris, 256)
    return min(n_tris, max(1024, -(-n_tris // 4 // CLUSTER) * CLUSTER))


def _morton3(x: np.ndarray) -> np.ndarray:
    """(N, 3) in [0,1] → 30-bit Morton codes (10 bits/axis)."""
    q = np.clip((x * 1023.0), 0, 1023).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def pack_triangles(verts: np.ndarray, faces: np.ndarray, pad_to: int = 8,
                   return_order: bool = False):
    """(V, 3) + (F, 3) → (T, 9) rows [a | b | c], zero-padded (degenerate
    rows never intersect). Meshes above ``CLUSTER_CULL_MIN_T`` are sorted by
    an orientation-aware Morton code of the centroid (a 3-bit facing bucket
    below the top 12 spatial bits, so that clusters are spatially tight and
    orientation-pure) and padded to whole clusters. ``return_order`` also
    returns packed row → original face, −1 on padding rows."""
    tris = verts[faces.reshape(-1)].reshape(-1, 9).astype(np.float32)
    t = len(tris)
    order = np.arange(t)
    if t > CLUSTER_CULL_MIN_T:
        cen = tris.reshape(-1, 3, 3).mean(1)
        lo, hi = cen.min(0), cen.max(0)
        norm = (cen - lo) / np.maximum(hi - lo, 1e-9)
        v3 = tris.reshape(-1, 3, 3).astype(np.float64)
        n = np.cross(v3[:, 1] - v3[:, 0], v3[:, 2] - v3[:, 0])
        axis = np.argmax(np.abs(n), axis=1)
        sign = np.take_along_axis(n, axis[:, None], 1)[:, 0] < 0
        bucket = (axis * 2 + sign).astype(np.uint64)  # 6 facings
        m = _morton3(norm).astype(np.uint64)
        key = ((m >> 18) << 21) | (bucket << 18) | (m & ((1 << 18) - 1))
        order = np.argsort(key, kind="stable")
        tris = tris[order]
        pad_to = max(pad_to, CLUSTER)
    padded = -(-max(t, 1) // pad_to) * pad_to
    out = np.zeros((padded, 9), np.float32)
    out[:t] = tris
    if return_order:
        ids = np.full(padded, -1, np.int64)
        ids[:t] = order
        return out, ids
    return out


# ---------------------------------------------------------------------------
# brute force
# ---------------------------------------------------------------------------


def _norm3(x: Tensor) -> Tensor:
    """Euclidean norm over the last axis of 3, summed in index order."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2])


def _face_normals(tris: Tensor) -> Tensor:
    """Unnormalised geometric normals (b − a) × (c − a) of rows (..., 9)."""
    a = tris[..., 0:3]
    return torch.linalg.cross(tris[..., 3:6] - a, tris[..., 6:9] - a)


def normals_from_gid(tris: Tensor, gid: Tensor, dirs: Tensor, hit: Tensor) -> Tensor:
    """Unit normals (S, R, 3) of the winning triangles ``gid (S, R)``, turned
    against the ray ``dirs (S, R, 3)``; zero on misses."""
    n = torch.gather(_face_normals(tris), 1, gid.to(torch.int64)[..., None].expand(*gid.shape, 3))
    n = n / (_norm3(n)[..., None] + 1e-12)
    n = torch.where(torch.sum(n * dirs, -1, keepdim=True) > 0, -n, n)
    return torch.where(hit[..., None], n, 0.0)


def _winner_plane_t(tris: Tensor, gid: Tensor, origins: Tensor, dirs: Tensor, hit: Tensor,
                   t: Tensor, max_depth: float) -> Tensor:
    """t (S, R) of the rays that hit, recomputed on the winning triangle's
    plane, ((a − o)·n) / (d·n) with n = (b − a) × (c − a) from its edges;
    ``t`` elsewhere. ``origins`` and ``dirs`` are (S, R, 3).

    The signed-volume bodies take t as a'·(b'×c') over the sum of the three
    volumes, products of vectors from the origin that cancel down to the
    plane's: on a sliver triangle (3.75 cm by 22 cm, 6.4 m away, 92,160
    triangles) that was 1.16 mm off the float64 first hit on an H100, where
    the winner itself was right (``chip_profile.py plane``). The edges'
    cross product keeps float32's accuracy."""
    rows = torch.gather(tris, 1, gid.to(torch.int64)[..., None].expand(*gid.shape, 9))
    a = rows[..., 0:3]
    n = torch.linalg.cross(rows[..., 3:6] - a, rows[..., 6:9] - a)
    tp = torch.sum((a - origins) * n, -1) / torch.sum(dirs * n, -1)
    return torch.where(hit, torch.clamp(tp, 0.0, max_depth), t)


def tri_trace_brute(tris: Tensor, origins: Tensor, dirs: Tensor, max_depth: float = 20.0,
                    max_elems: int = 1 << 24) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Every ray against every triangle. tris (S, T, 9), origins/dirs
    (S, R, 3) → (t (S, R), hit (S, R), normal (S, R, 3) geometric and facing
    the ray, id (S, R) int32 of the first minimum in row order). Triangles go
    in slabs so that a (slab, R) intermediate holds ``max_elems``."""
    S, T = tris.shape[0], tris.shape[1]
    R = origins.shape[1]
    best = torch.full((S, R), BIG, dtype=origins.dtype, device=origins.device)
    gid = torch.zeros((S, R), dtype=torch.int64, device=origins.device)
    slab = max(1, min(T, max_elems // max(S * R, 1)))
    o = origins[:, None]  # (S, 1, R, 3)
    d = dirs[:, None]
    for k0 in range(0, T, slab):
        rows = tris[:, k0:k0 + slab, None, :]  # (S, slab, 1, 9)
        a = rows[..., 0:3]
        e1 = rows[..., 3:6] - a
        e2 = rows[..., 6:9] - a
        pvec = torch.linalg.cross(d, e2.expand(S, -1, R, 3))
        det = torch.sum(e1 * pvec, -1)
        okd = det.abs() > 1e-9
        inv = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
        tvec = o - a
        u = torch.sum(tvec * pvec, -1) * inv
        qvec = torch.linalg.cross(tvec, e1.expand(S, -1, R, 3))
        v = torch.sum(d * qvec, -1) * inv
        t = torch.sum(e2 * qvec, -1) * inv
        ok = okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
        ts, k = torch.min(torch.where(ok, t, BIG), dim=1)  # (S, R), first minimum
        better = ts < best
        gid = torch.where(better, k + k0, gid)
        best = torch.where(better, ts, best)
    hit = best < max_depth
    n = torch.gather(_face_normals(tris), 1, gid[..., None].expand(S, R, 3))
    n = n / (_norm3(n)[..., None] + 1e-12)
    n = torch.where(torch.sum(n * dirs, -1, keepdim=True) > 0, -n, n)
    return torch.clamp(best, 0.0, max_depth), hit, n, gid.to(torch.int32)


# ---------------------------------------------------------------------------
# per-tile cull prepasses (plain PyTorch)
# ---------------------------------------------------------------------------


def _apex_spread(origins_c: Tensor, S: int, n_tiles: int) -> Tuple[Tensor, Tensor]:
    """Per-tile mean ray origin (apex (S, tiles, 3)) and the largest distance
    of an origin from it (spread (S, tiles)): the sound radius of the
    occlusion lower bound."""
    o4 = origins_c.reshape(3, S, n_tiles, TILE)
    apex = o4.mean(-1)
    spread = torch.sqrt(torch.sum((o4 - apex[..., None]) ** 2, dim=0).amax(-1))
    return apex.permute(1, 2, 0), spread


def _tile_planes(origins_c: Tensor, dirs_c: Tensor, S: int, n_tiles: int, img_w: int
                 ) -> Tuple[Tensor, Tensor]:
    """The four planes of a tile's camera wedge (planes (S, tiles, 4, 3),
    inward) and its apex (S, tiles, 3); valid when a tile is a block of whole
    rows of one camera."""
    dt4 = dirs_c.reshape(3, S, n_tiles, TILE)
    corners = torch.stack([dt4[..., 0], dt4[..., img_w - 1], dt4[..., TILE - 1],
                           dt4[..., TILE - img_w]], dim=-1).permute(1, 2, 3, 0)
    planes = torch.linalg.cross(corners, torch.roll(corners, -1, dims=2))
    centre = corners.sum(dim=2, keepdim=True)
    sign_fix = torch.sign(torch.sum(planes * centre, -1, keepdim=True))
    planes = planes * torch.where(sign_fix == 0, 1.0, sign_fix)
    apex = origins_c.reshape(3, S, n_tiles, TILE)[..., 0].permute(1, 2, 0)
    return planes, apex


def _tile_aabb(origins_c: Tensor, dirs_c: Tensor, max_depth: float) -> Tuple[Tensor, Tensor]:
    """Bounds (S, tiles, 3) of every point a tile's rays reach in max_depth."""
    _, S, R = origins_c.shape
    o = origins_c.reshape(3, S, R // TILE, TILE)
    d = dirs_c.reshape(3, S, R // TILE, TILE)
    lo = o.amin(-1) + max_depth * torch.clamp(d.amin(-1), max=0.0)
    hi = o.amax(-1) + max_depth * torch.clamp(d.amax(-1), min=0.0)
    return lo.permute(1, 2, 0), hi.permute(1, 2, 0)


def _nearest_first(active: Tensor, dist: Tensor, keep: int) -> Tensor:
    """Indices (S, tiles, keep) of the active entries by distance, then the
    inactive ones in index order."""
    key = torch.where(active, dist, torch.inf)
    return torch.argsort(key, dim=-1, stable=True)[:, :, :keep]


def tri_cull_compact(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float,
                     cap: int, img_w: Optional[int] = None, backface: bool = False
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """(S, T, 9) triangles × (3, S, R) rays → per tile the ``cap`` nearest
    visible triangles: ids (S, tiles, cap') int32 slot → triangle, counts
    (S, tiles) int32 of visible triangles, lb (S, tiles, cap') lower bound on
    a hit t of each slot (BIG on invisible ones). The test is the tile's
    reach AABB, plus the exact camera wedge when ``img_w`` says that a tile
    is whole rows of one camera, plus facing when ``backface``. Above
    ``CLUSTER_CULL_MIN_T`` whole clusters are culled and ``cap'`` is ``cap``
    in whole clusters.

    The JAX function also returns a compacted copy of the rows; the kernel
    here gathers rows from the soup by id."""
    S, T = tris.shape[0], tris.shape[1]
    n_tiles = origins_c.shape[2] // TILE
    lo, hi = _tile_aabb(origins_c, dirs_c, max_depth)
    if T > CLUSTER_CULL_MIN_T and T % CLUSTER == 0:
        return _cluster_cull_compact(tris, origins_c, dirs_c, max_depth, cap, lo, hi, img_w,
                                     backface)
    v = tris.reshape(S, T, 3, 3)
    tlo, thi = v.amin(2), v.amax(2)  # (S, T, 3)
    active = torch.all((lo[:, :, None] <= thi[:, None]) & (hi[:, :, None] >= tlo[:, None]), -1)
    # zero-padded rows are out (degenerate at the origin, they could overlap)
    active = active & torch.any(tris.abs() > 0, dim=-1)[:, None]

    if img_w is not None and TILE % img_w == 0:
        planes, apex_w = _tile_planes(origins_c, dirs_c, S, n_tiles, img_w)
        # visible unless all three vertices lie outside one plane; the plane
        # distance written out, so that no matrix product rounds it
        rel = v[:, None] - apex_w[:, :, None, None]  # (S, tiles, T, 3 verts, 3)
        pl = planes[:, :, :, None, None, :]  # (S, tiles, 4, 1, 1, 3)
        rl = rel[:, :, None]
        dv = pl[..., 0] * rl[..., 0] + pl[..., 1] * rl[..., 1] + pl[..., 2] * rl[..., 2]
        active = active & torch.all(torch.any(dv >= 0.0, dim=-1), dim=2)

    apex, spread = _apex_spread(origins_c, S, n_tiles)
    if backface:
        # exact per triangle: x on its plane has n·x = n·a, so the largest
        # n·(o − x) over the tile's origins is n·(apex − a) + spread
        a_t = v[:, :, 0]
        n_t = torch.linalg.cross(v[:, :, 1] - a_t, v[:, :, 2] - a_t)
        n_t = n_t / (_norm3(n_t)[..., None] + 1e-12)
        front = (torch.sum(n_t[:, None] * (apex[:, :, None] - a_t[:, None]), -1)
                 + spread[..., None]) > 0.0
        active = active & front

    centroid = v.mean(2)  # (S, T, 3)
    dist = _norm3(centroid[:, None] - apex[:, :, None])  # (S, tiles, T)
    ids = _nearest_first(active, dist, cap)
    # |d| = 1, so a hit t is at least the distance: centroid distance less the
    # triangle's circumradius less the spread of the tile's origins
    rad = _norm3(v - centroid[:, :, None]).amax(-1)
    lb_all = torch.clamp(dist - rad[:, None] - spread[..., None], min=0.0)
    lb_all = torch.where(active, lb_all, BIG)
    return (ids.to(torch.int32), active.sum(-1).to(torch.int32), torch.gather(lb_all, 2, ids))


def _cluster_activity(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, lo: Tensor, hi: Tensor,
                      img_w: Optional[int], cluster: int = CLUSTER, backface: bool = False
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Visibility of ``cluster``-triangle blocks: active (S, tiles, C),
    apex-to-centre distance (S, tiles, C) and the blocks' hit-t lower bounds
    (S, tiles, C), BIG where inactive. ``backface`` also drops blocks whose
    whole normal cone faces away from every origin of the tile (exact on
    closed, consistently wound meshes)."""
    S, T = tris.shape[0], tris.shape[1]
    C = T // cluster
    n_tiles = lo.shape[1]
    v = tris.reshape(S, C, cluster, 3, 3)
    clo, chi = v.amin((2, 3)), v.amax((2, 3))  # (S, C, 3)
    nonzero = torch.any(tris.abs().reshape(S, C, -1) > 0, -1)
    active = torch.all((lo[:, :, None] <= chi[:, None]) & (hi[:, :, None] >= clo[:, None]), -1)
    active = active & nonzero[:, None]
    cen = (clo + chi) * 0.5
    half = (chi - clo) * 0.5

    if img_w is not None and TILE % img_w == 0:
        planes, apex_w = _tile_planes(origins_c, dirs_c, S, n_tiles, img_w)
        # conservative box against wedge: centre distance + Σ|n|·half ≥ 0
        pl = planes[:, :, :, None, :]  # (S, tiles, 4, 1, 3)
        cc = cen[:, None, None]  # (S, 1, 1, C, 3)
        hh = half[:, None, None]
        d_cen = (pl[..., 0] * cc[..., 0] + pl[..., 1] * cc[..., 1] + pl[..., 2] * cc[..., 2]
                 - torch.sum(planes * apex_w[:, :, None], -1)[..., None])
        ap = pl.abs()
        r_eff = ap[..., 0] * hh[..., 0] + ap[..., 1] * hh[..., 1] + ap[..., 2] * hh[..., 2]
        active = active & torch.all(d_cen + r_eff >= 0.0, dim=2)

    apex, spread = _apex_spread(origins_c, S, n_tiles)
    dist = _norm3(cen[:, None] - apex[:, :, None])
    hd = _norm3(half)  # (S, C)

    if backface:
        a = v[..., 0, :]
        nt = torch.linalg.cross(v[..., 1, :] - a, v[..., 2, :] - a)  # (S, C, k, 3)
        nt = nt / (_norm3(nt)[..., None] + 1e-12)
        nbar = nt.sum(2)
        nbar = nbar / (_norm3(nbar)[..., None] + 1e-12)
        # padding rows have n = 0: cos 0, sin 1, the cone covers everything
        cos_min = torch.sum(nt * nbar[:, :, None], -1).amin(2)  # (S, C)
        # past a hemisphere sqrt(1 − cos²) no longer bounds the cone
        sin_max = torch.where(cos_min <= 0.0, 1.0,
                              torch.sqrt(torch.clamp(1.0 - cos_min * cos_min, min=0.0)))
        d = apex[:, :, None] - cen[:, None]  # (S, tiles, C, 3)
        front = (torch.sum(nbar[:, None] * d, -1) + dist * sin_max[:, None]
                 + spread[..., None] + hd[:, None]) > 0.0
        active = active & front

    # any hit lies in the block's box: t ≥ dist(apex, box) − spread
    gap = torch.maximum(clo[:, None] - apex[:, :, None], apex[:, :, None] - chi[:, None])
    d_aabb = _norm3(torch.clamp(gap, min=0.0))
    lb_all = torch.clamp(d_aabb - spread[..., None], min=0.0)
    return active, dist, torch.where(active, lb_all, BIG)


def _cluster_cull_compact(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float,
                          cap: int, lo: Tensor, hi: Tensor, img_w: Optional[int],
                          backface: bool = False) -> Tuple[Tensor, Tensor, Tensor]:
    """Two-level cull of a Morton-ordered mesh: whole ``CLUSTER``-triangle
    clusters are culled, sorted and kept (``cap // CLUSTER`` of them); ids and
    lb are per slot as in :func:`tri_cull_compact`, counts in whole
    clusters."""
    S, T = tris.shape[0], tris.shape[1]
    n_tiles = lo.shape[1]
    active, dist, lb_all = _cluster_activity(tris, origins_c, dirs_c, lo, hi, img_w,
                                             backface=backface)
    cap_c = max(1, min(cap, T) // CLUSTER)
    order = _nearest_first(active, dist, cap_c)
    counts = (active.sum(-1) * CLUSTER).to(torch.int32)
    lb = torch.gather(lb_all, 2, order).repeat_interleave(CLUSTER, dim=-1)
    ids = (order[..., None] * CLUSTER + torch.arange(CLUSTER, device=tris.device))
    return ids.reshape(S, n_tiles, cap_c * CLUSTER).to(torch.int32), counts, lb


def _cluster_ids_prepass(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float,
                         cap: int, img_w: Optional[int], backface: bool = False,
                         soup_cluster: Optional[int] = None
                         ) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Dense-mesh prepass: per tile a list of block ids into the shared soup
    → (cids (S, tiles, cap_c) int32, counts (S, tiles) int32 of visible
    blocks, lb_c (S, tiles, cap_c), block size). Consecutive Morton clusters
    pair into 128-triangle blocks where the mesh allows; ``soup_cluster``
    asks for another block size. Either is halved until it divides the
    mesh."""
    T = tris.shape[1]
    lo, hi = _tile_aabb(origins_c, dirs_c, max_depth)
    cluster = soup_cluster or (2 * CLUSTER if T % (2 * CLUSTER) == 0 else CLUSTER)
    while T % cluster:
        cluster //= 2
    active, dist, lb_all = _cluster_activity(tris, origins_c, dirs_c, lo, hi, img_w,
                                             cluster=cluster, backface=backface)
    cap_c = max(1, min(cap, T) // cluster)
    cids = _nearest_first(active, dist, cap_c)
    return (cids.to(torch.int32), active.sum(-1).to(torch.int32),
            torch.gather(lb_all, 2, cids), cluster)


def cull_stats(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float = 20.0,
               cap: int = 256, img_w: Optional[int] = None) -> dict:
    """Visible triangles per tile and the share of tiles above ``cap``, for
    sizing ``cap``."""
    _, counts, _ = tri_cull_compact(tris, origins_c, dirs_c, max_depth, cap=1, img_w=img_w)
    c = counts.cpu().numpy()
    return {"max": int(c.max()), "mean": float(c.mean()), "p99": float(np.percentile(c, 99)),
            "overflow_frac": float((c > cap).mean())}


def _exact_aabb_lists(tris: Tensor, origins_c: Tensor, lists: TileLists) -> TileLists:
    """Block lists with each block's bound replaced by the distance from the
    tile's apex to the block's box, written per axis, less the spread of the
    tile's origins, and the list sorted again by that bound."""
    S, T = tris.shape[0], tris.shape[1]
    cluster = lists.block
    n_tiles = origins_c.shape[2] // TILE
    v = tris.reshape(S, T // cluster, cluster, 3, 3)
    clo, chi = v.amin((2, 3)), v.amax((2, 3))
    apex, spread = _apex_spread(origins_c, S, n_tiles)
    cen, half = (clo + chi) * 0.5, (chi - clo) * 0.5
    dd = torch.clamp((cen[:, None] - apex[:, :, None]).abs() - half[:, None], min=0.0)
    lb_all = torch.clamp(_norm3(dd) - spread[..., None], min=0.0)
    ids = lists.ids.to(torch.int64)
    lb = torch.where(lists.lb < BIG, torch.gather(lb_all, 2, ids), BIG)  # unseen blocks stay last
    order = torch.argsort(lb, dim=-1, stable=True)
    return lists._replace(ids=torch.gather(ids, 2, order).to(torch.int32).contiguous(),
                          lb=torch.gather(lb, 2, order).contiguous())


def stage_stats(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float = 20.0,
                cap: Optional[int] = None, img_w: Optional[int] = None,
                exact_aabb: bool = False) -> dict:
    """How well the occlusion early-out works on block lists into the soup:
    mean, p50, p90 and max of the stages a tile executes, beside the mean of
    the blocks it sees, and the share of rays that hit (the counterpart of
    ``examples/_tri_probe.py::probe``: the Möller–Trumbore body over 64- or
    128-triangle blocks, ``cap`` by default the whole mesh). ``exact_aabb``
    swaps in the per-axis box distance as the bound and sorts by it. The
    count is the list walk's, on the card and on the CPU alike: a tile's
    stages summed over its blocks of ``"block_rays"`` rays, each voting on
    its own rays over the blocks the cull kept (:func:`walk_order`), so at
    most ``1024 / block_rays`` times the blocks it sees. Also returns
    ``"stages"`` (S, tiles) int32, ``"t"`` and ``"hit"``."""
    T = tris.shape[1]
    o_c, d_c = origins_c.detach().contiguous(), dirs_c.detach().contiguous()
    prepass = _cluster_ids_prepass(tris, o_c, d_c, max_depth, T if cap is None else min(cap, T),
                                   img_w)
    lists, visible = _as_block_lists(*prepass), prepass[1]
    if exact_aabb:
        lists = _exact_aabb_lists(tris, o_c, lists)
    t, hit, _, stages = tri_first_hit(tris, walk_order(lists), o_c, d_c, max_depth, "mt", 1,
                                      count_stages=True)
    c = stages.cpu().numpy()
    return {"mean": float(c.mean()), "p50": float(np.percentile(c, 50)),
            "p90": float(np.percentile(c, 90)), "max": int(c.max()),
            "visible_mean": float(visible.float().mean()), "n_stage": int(lists.lb.shape[2]),
            "block_rays": TILE_BLOCK_RAYS, "hit_frac": float(hit.float().mean()),
            "stages": stages, "t": t, "hit": hit}


def knockout_trace(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float = 20.0,
                   cap: int = 256, img_w: Optional[int] = None, cam_rays: Optional[int] = None,
                   backface: bool = False, body: bool = True, pin_stage: bool = False,
                   plan: Optional[TilePlan] = None) -> Tensor:
    """t (S, R), in tile order, of the merged per-camera kernel with parts
    knocked out (the counterpart of ``examples/_tri_kernel_exp.py::
    camsoup_exp``): ``body=False`` keeps the guard and the staging and removes
    the tests, so every ray ends at ``max_depth``; ``pin_stage=True`` makes
    every stage load the list's first block, so t is the first hit over that
    block alone. All four cases run the list walk that B7a's render launches
    (``csrc/tri_tile.cu``), with its stage shares. The rays must be whole
    cameras on a mesh of whole
    64-triangle clusters (the per-camera tier is forced, whatever the mesh
    size); ``plan`` reuses a prepass."""
    if plan is None:
        plan = plan_tiles(tris, origins_c, dirs_c, max_depth, cap, img_w, cam_rays, backface,
                          soup_min_t=0, variant="merged")
    if plan.form != "sv_cam":
        raise ValueError("the knock-outs belong to the per-camera tier: rays must be whole "
                         f"cameras and the mesh whole {CLUSTER}-triangle clusters")
    return tri_first_hit(tris, plan.lists, plan.origins_c, plan.dirs_c, max_depth, plan.form,
                         plan.origin_tiles, "merged", body=body, pin_stage=pin_stage)[0]


# ---------------------------------------------------------------------------
# the tiers
# ---------------------------------------------------------------------------


def tile_lists(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float, cap: int,
               img_w: Optional[int], backface: bool) -> TileLists:
    """The per-triangle and cluster tiers' prepass as the kernel takes it:
    slots in stages of 64 triangles (128 for caps above 1,024), padded with
    empty slots to whole stages; a stage's bound is the least of its slots';
    ``count`` the visible triangles a tile kept, at most the cap (the slots
    past it hold culled triangles or none; the tile kernel walks no slot past
    it), ``order`` the tiles most of them first (the tile kernel's launch
    order)."""
    ids, counts, lb = tri_cull_compact(tris, origins_c, dirs_c, max_depth, cap, img_w, backface)
    cap = ids.shape[2]  # the cluster path rounds to whole clusters
    counts = torch.clamp(counts, max=cap)
    chunk = min(cap, STAGE if cap <= 1024 else 2 * STAGE)
    pad = -cap % chunk
    if pad:
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        lb = torch.nn.functional.pad(lb, (0, pad), value=BIG)
    n_stage = (cap + pad) // chunk
    nst = torch.clamp((counts + chunk - 1) // chunk, min=1).to(torch.int32)
    lbc = lb.reshape(*lb.shape[:2], n_stage, chunk).amin(-1)
    counts = counts.to(torch.int32).contiguous()
    return TileLists(ids.contiguous(), nst, lbc.contiguous(), chunk, 1, count=counts,
                     order=longest_first(counts))


def block_lists(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float, cap: int,
                img_w: Optional[int], backface: bool,
                soup_cluster: Optional[int] = None) -> TileLists:
    """The dense tiers' prepass as the kernel takes it: one block a stage."""
    return _as_block_lists(*_cluster_ids_prepass(tris, origins_c, dirs_c, max_depth, cap, img_w,
                                                 backface, soup_cluster))


def _as_block_lists(cids: Tensor, counts: Tensor, lb_c: Tensor, cluster: int) -> TileLists:
    """Block lists, one block a stage. A block of ``k`` stages (the cull
    decided at its size) becomes ``k`` consecutive stage-sized blocks:
    block ``c`` turns into ids ``k·c … k·c + k − 1``, each with ``c``'s
    bound, and a tile's count is multiplied by ``k``; the first hit is the
    same function."""
    if cluster > MAX_CHUNK:
        if cluster % MAX_CHUNK:
            raise ValueError(f"blocks of {cluster} triangles are no whole number of stages of "
                             f"{MAX_CHUNK}")
        k = cluster // MAX_CHUNK
        S, tiles, cap_c = cids.shape
        cids = (cids.to(torch.int64)[..., None] * k
                + torch.arange(k, device=cids.device)).reshape(S, tiles, cap_c * k)
        lb_c = lb_c.repeat_interleave(k, dim=-1)
        counts = counts * k
        cluster = MAX_CHUNK
    nst = torch.clamp(counts, 1, cids.shape[2]).to(torch.int32)
    return TileLists(cids.to(torch.int32).contiguous(), nst, lb_c.contiguous(), cluster, cluster)


def walk_order(lists: TileLists) -> TileLists:
    """Block lists with ``count``, the slots of the blocks the cull kept (a
    block's bound is BIG where it did not, and the kept come first; a tile
    that sees none walks nothing), and ``order``, the tiles most of them
    first: what the list walk takes of B7a and of the soup's stage count
    (:func:`stage_stats`), and no other tier of block lists reads."""
    count = ((lists.lb < BIG).sum(-1) * lists.chunk).to(torch.int32).contiguous()
    return lists._replace(count=count, order=longest_first(count))


def worklist_lists(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float, cap: int,
                   img_w: Optional[int], backface: bool,
                   work_budget: Optional[int] = None) -> TileLists:
    """The worklist tier's prepass (plain PyTorch, as it is plain XLA in
    ``_tri_trace_pallas_worklist``) → a CSR :class:`TileLists`.

    Clusters of ``WL_CLUSTER`` triangles are culled per tile and kept nearest
    first, eight to a stage of ``WL_CHUNK``; a stage's bound is the least of
    its clusters'. A scene has ``tiles · W`` stages to give out, ``W`` the
    budget ``work_budget`` (default a third of a tile's cap in stages, at
    least 8): every tile gets one stage and, of the stages it still needs, the
    share ``min(1, free / needed)`` rounded down, so an over-budget scene drops
    each tile's farthest stages (far geometry turns into background, never the
    reverse). ``start`` is the prefix sum of the quotas. Slots past a tile's
    count of visible clusters are empty (−1): ``count`` is the slots of the
    visible clusters a tile's quota holds, ``order`` the tiles most of them
    first (the list walk's real slots and launch order). The JAX function
    splits a scene's tiles into groups that fit its scalar memory and
    budgets each group on its own; here a scene is one group."""
    S, T = tris.shape[0], tris.shape[1]
    tiles = origins_c.shape[2] // TILE
    cluster, per = WL_CLUSTER, WL_CHUNK // WL_CLUSTER
    C = T // cluster
    dev = tris.device
    lo, hi = _tile_aabb(origins_c, dirs_c, max_depth)
    active, dist, lb_all = _cluster_activity(tris, origins_c, dirs_c, lo, hi, img_w,
                                             cluster=cluster, backface=backface)
    cap_c = max(1, min(cap, T) // cluster)
    cap_c = min(-(-cap_c // per) * per, -(-C // per) * per)
    n_chunks = cap_c // per
    cids = _nearest_first(active, dist, min(cap_c, C))
    if cap_c > C:  # the cap holds more clusters than the mesh has
        cids = torch.nn.functional.pad(cids, (0, cap_c - C))
    counts = torch.clamp(active.sum(-1), max=cap_c)  # (S, tiles)
    in_count = torch.arange(cap_c, device=dev) < counts[..., None]
    lb_c = torch.where(in_count, torch.gather(lb_all, 2, cids), BIG)
    cids = torch.where(in_count, cids, -1)
    lb_ch = lb_c.reshape(S, tiles, n_chunks, per).amin(-1)
    cnt_ch = torch.clamp(-(-counts // per), 1, n_chunks)

    W = min(work_budget or max(8, n_chunks // 3), n_chunks)
    NW = tiles * W
    extra = (cnt_ch - 1).to(torch.float32)
    scale = torch.clamp((NW - tiles) / torch.clamp(extra.sum(-1, keepdim=True), min=1.0), max=1.0)
    quota = 1 + torch.floor(extra * scale).to(torch.int64)  # (S, tiles)
    start = torch.cumsum(quota, dim=-1) - quota
    total = start[:, -1] + quota[:, -1]  # (S,)
    e = torch.arange(NW, device=dev).expand(S, NW)
    tile_of = torch.searchsorted(start, e.contiguous(), right=True) - 1
    within = e - torch.gather(start, 1, tile_of)
    valid = e < total[:, None]
    stage = tile_of * n_chunks + torch.clamp(within, max=n_chunks - 1)  # into (tiles, n_chunks)
    lb_w = torch.where(valid, torch.gather(lb_ch.reshape(S, -1), 1, stage), BIG)
    slot = (stage[..., None] * per + torch.arange(per, device=dev)).reshape(S, NW * per)
    ids_w = torch.gather(cids.reshape(S, -1), 1, slot)
    ids_w = torch.where(valid.repeat_interleave(per, dim=-1), ids_w, -1)
    kept = (torch.minimum(counts, quota * per) * cluster).to(torch.int32).contiguous()
    return TileLists(ids_w.to(torch.int32).contiguous(), quota.to(torch.int32).contiguous(),
                     lb_w.contiguous(), WL_CHUNK, cluster, start.to(torch.int32).contiguous(),
                     count=kept, order=longest_first(kept))


class TilePlan(NamedTuple):
    """Everything :func:`tri_trace_tiled` decides before the kernel: the rays
    in tile order, the tiles' lists, the kernel's body, and how to put
    per-ray results back into the caller's order."""

    origins_c: Tensor  # (3, S, R) contiguous, repacked where cameras allow
    dirs_c: Tensor
    lists: TileLists
    form: str  # "mt" | "sv_tile" | "sv_cam"
    origin_tiles: int  # tiles that share one origin
    unpack: Optional[Callable[[Tensor], Tensor]]  # (S, R, ...) tile order → caller's order
    mode: str = "scalar"  # the variant of the per-camera body: "scalar" | "merged" | "mx"


def plan_tiles(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float = 20.0,
               cap: int = 256, img_w: Optional[int] = None, cam_rays: Optional[int] = None,
               backface: bool = False, soup_min_t: int = SHARED_SOUP_MIN_T,
               variant: str = "scalar", work_budget: Optional[int] = None,
               soup_cluster: Optional[int] = None) -> TilePlan:
    """The repack, the tier and its cull prepass for rays (3, S, R);
    ``soup_cluster`` is the block size of the lists above ``soup_min_t``
    (:func:`_cluster_ids_prepass`; the worklist keeps its own)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}; got {variant!r}")
    _, S, R = origins_c.shape
    if R % TILE:
        raise ValueError(f"rays per scene ({R}) must be a multiple of {TILE}")
    T = tris.shape[1]
    cap = min(cap, T)
    o_c, d_c = origins_c.detach(), dirs_c.detach()
    whole_cams = (img_w is not None and cam_rays is not None and cam_rays % TILE == 0
                  and R % cam_rays == 0 and cam_rays % img_w == 0)
    unpack = None
    if whole_cams and img_w > 32 and img_w % 32 == 0 and (cam_rays // img_w) % (TILE // 32) == 0:
        # square pixel blocks: a tile's wedge is a compact 32×32 square, not a
        # full-width strip
        bw, bh = 32, TILE // 32
        cams, hb, wb = R // cam_rays, cam_rays // img_w // bh, img_w // bw
        o_c, d_c = (x.reshape(3, S, cams, hb, bh, wb, bw).transpose(4, 5).reshape(3, S, R)
                    for x in (o_c, d_c))
        img_w = bw

        def unpack(y):
            y = y.reshape(S, cams, hb, wb, bh, bw, *y.shape[2:])
            return y.transpose(3, 4).reshape(S, R, *y.shape[6:])

    o_c, d_c = o_c.contiguous(), d_c.contiguous()
    if T > soup_min_t and T % CLUSTER == 0:
        if whole_cams and variant == "wl":
            lists = worklist_lists(tris, o_c, d_c, max_depth, cap, img_w, backface, work_budget)
            return TilePlan(o_c, d_c, lists, "sv_tile", 1, unpack)
        lists = block_lists(tris, o_c, d_c, max_depth, cap, img_w, backface, soup_cluster)
        if whole_cams:
            if variant == "merged":  # B7a: the list walk's real slots, longest walk first
                lists = walk_order(lists)
            return TilePlan(o_c, d_c, lists, "sv_cam", cam_rays // TILE, unpack, variant)
        return TilePlan(o_c, d_c, lists, "mt", 1, unpack)
    lists = tile_lists(tris, o_c, d_c, max_depth, cap, img_w, backface)
    if img_w is not None:  # camera tiles have one origin each
        return TilePlan(o_c, d_c, lists, "sv_tile", 1, unpack)
    return TilePlan(o_c, d_c, lists, "mt", 1, unpack)


def tri_trace_tiled(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float = 20.0,
                    cap: int = 256, img_w: Optional[int] = None,
                    cam_rays: Optional[int] = None, backface: bool = False,
                    soup_min_t: int = SHARED_SOUP_MIN_T, variant: str = "scalar",
                    work_budget: Optional[int] = None, soup_cluster: Optional[int] = None
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(S, T, 9) × (3, S, R) → (t (S, R), hit (S, R), normal (S, R, 3),
    id (S, R) int32); R a multiple of 1,024. ``img_w`` says that a tile is
    whole rows of one camera (wedge cull, one origin a tile); ``cam_rays``
    (H·W, rays arriving as whole row-major cameras) unlocks the 32×32-pixel
    repack and, above ``soup_min_t``, the per-camera signed volumes.
    ``variant`` picks how that last tier runs (module docstring) and
    ``work_budget`` the stages a tile of its ``"wl"`` variant gets on
    average; ``soup_cluster`` the block size of the lists above
    ``soup_min_t`` (default 128 where the mesh allows)."""
    plan = plan_tiles(tris, origins_c, dirs_c, max_depth, cap, img_w, cam_rays, backface,
                      soup_min_t, variant, work_budget, soup_cluster)
    t, hit, gid = tri_first_hit(tris, plan.lists, plan.origins_c, plan.dirs_c, max_depth,
                                plan.form, plan.origin_tiles, plan.mode)
    dirs = plan.dirs_c.permute(1, 2, 0)
    if plan.form != "mt":  # the signed volumes' t, taken again on the winner's plane
        t = _winner_plane_t(tris, gid, plan.origins_c.permute(1, 2, 0), dirs, hit, t, max_depth)
    out = (t, hit, normals_from_gid(tris, gid, dirs, hit), gid)
    return out if plan.unpack is None else tuple(plan.unpack(y) for y in out)


# ---------------------------------------------------------------------------
# differentiable entry
# ---------------------------------------------------------------------------


class _TriTraceIFT(torch.autograd.Function):
    """Forward: :func:`tri_trace_tiled` or :func:`tri_trace_brute`. Backward: the
    closed form for a planar hit surface; nothing for the triangles, ``hit``,
    the normals or the ids."""

    @staticmethod
    def forward(ctx, origins_c, dirs_c, tris, kw):
        if kw["tiled"]:
            out = tri_trace_tiled(tris, origins_c, dirs_c, kw["max_depth"], kw["cap"],
                                  kw["img_w"], kw["cam_rays"], kw["backface"], kw["soup_min_t"],
                                  kw["variant"], kw["work_budget"], kw["soup_cluster"])
        else:
            out = tri_trace_brute(tris, origins_c.permute(1, 2, 0), dirs_c.permute(1, 2, 0),
                                  kw["max_depth"])
        t, hit, n, gid = out
        ctx.save_for_backward(dirs_c, t, hit, n)
        ctx.mark_non_differentiable(hit, n, gid)
        return t, hit, n, gid

    @staticmethod
    def backward(ctx, g_t, *_):
        dirs_c, t, hit, n = ctx.saved_tensors
        denom = torch.sum(n * dirs_c.permute(1, 2, 0), dim=-1)
        scale = torch.where(hit & (denom.abs() > 1e-3), 1.0 / denom, 0.0)
        common = (g_t * scale)[..., None] * n
        return -common.permute(2, 0, 1), -(common * t[..., None]).permute(2, 0, 1), None, None


def tri_trace_diff(tris: Tensor, origins_c: Tensor, dirs_c: Tensor, max_depth: float = 20.0,
                   cap: int = 256, img_w: Optional[int] = None, tiled: bool = True,
                   cam_rays: Optional[int] = None, backface: bool = False,
                   soup_min_t: int = SHARED_SOUP_MIN_T, variant: str = "scalar",
                   work_budget: Optional[int] = None, soup_cluster: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Differentiable trace → (t, hit, normal, id), the counterpart of
    ``tri_trace_diff`` (``tiled`` is its ``use_pallas``). Gradients reach
    ``origins_c`` and ``dirs_c`` through t: ∂t/∂o = −n/(n·d),
    ∂t/∂d = −t·n/(n·d), zero where the ray missed or |n·d| ≤ 1e-3."""
    kw = dict(max_depth=max_depth, cap=cap, img_w=img_w, tiled=tiled, cam_rays=cam_rays,
              backface=backface, soup_min_t=soup_min_t, variant=variant,
              work_budget=work_budget, soup_cluster=soup_cluster)
    return _TriTraceIFT.apply(origins_c, dirs_c, tris, kw)
