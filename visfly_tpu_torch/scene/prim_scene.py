"""Packed analytic-primitive scenes (counterpart of
``visfly_tpu/scene/prim_scene.py``).

Every scene's primitives pack into a dense ``(S, K, 12)`` parameter tensor;
the SDF of K primitives at a point is plain elementwise arithmetic,
min-reduced over K.

Primitive families (packed in the same row layout):
  family 0: rounded box, optionally yaw-rotated and sign-inverted
            (sphere = he=0+radius; room = inverted box; gate = 4 bars)
  family 1: capsule (columns, moving obstacles)

Row layout (12 floats):
  [0:3]  center (family 0) / endpoint a (family 1)
  [3:6]  half_extents (family 0) / endpoint b (family 1)
  [6]    radius (rounding / capsule radius)
  [7]    cos(yaw), [8] sin(yaw)
  [9]    sign (+1 solid, −1 inverted room)
  [10]   family
  [11]   active (0 ⇒ +inf distance; pads scenes to a common K)

The packing is numpy, copied from the JAX module, so both packages give
bitwise-equal arrays for one ``SceneSpec``.
"""
from __future__ import annotations

import warnings
from typing import List, NamedTuple, Sequence

import numpy as np
import torch
from torch import Tensor

from .scene import SceneSpec

BIG = 1e9
SURFACE_EPS = 0.01  # the march's hit epsilon


def _family_split(params: np.ndarray, min_kb: int = 0, min_kc: int = 0) -> tuple:
    """Split packed (S, K, 12) rows into box/capsule arrays for the trace
    kernel, padding counts up to multiples of 4, and at least to ``min_kb``
    / ``min_kc``. A trailing column carries each row's original packed index
    (boxes col 12, capsules col 8)."""
    S = params.shape[0]
    boxes_per, caps_per = [], []
    for s in range(S):
        rows = params[s]
        active = rows[:, 11] > 0.5
        fam = rows[:, 10]
        idx = np.arange(rows.shape[0], dtype=np.float32)[:, None]
        bsel = active & (fam < 0.5)
        boxes_per.append(np.concatenate([rows[bsel], idx[bsel]], axis=1))
        csel = active & (fam >= 0.5)
        caps = rows[csel]
        caps_per.append(
            np.concatenate(
                [caps[:, 0:6], caps[:, 6:7], np.ones((len(caps), 1), np.float32), idx[csel]],
                axis=1,
            )
        )

    def pad4(n):
        return max(4, -(-n // 4) * 4)

    kb = pad4(max(max(len(b) for b in boxes_per), min_kb))
    kc = pad4(max(max(len(c) for c in caps_per), min_kc))
    boxes = np.zeros((S, kb, 13), np.float32)
    capsules = np.zeros((S, kc, 9), np.float32)
    for s in range(S):
        if len(boxes_per[s]):
            boxes[s, : len(boxes_per[s])] = boxes_per[s]
        if len(caps_per[s]):
            capsules[s, : len(caps_per[s])] = caps_per[s]
    return boxes, capsules


class PrimitiveScene(NamedTuple):
    params: Tensor  # (S, K, 12)
    colors: Tensor  # (S, K, 3) float32 (0..255)
    semantic: Tensor  # (S, K) int32
    bbox: Tensor  # (2, 3)
    eps: Tensor  # () nominal surface epsilon
    # family-split views for the trace kernel: boxes (S, KB, 13) rows
    # [… 12 packed cols …, orig_row_id], capsules (S, KC, 9) rows
    # [ax ay az bx by bz r active orig_row_id]
    boxes: Tensor
    capsules: Tensor

    @property
    def num_scene(self) -> int:
        return self.params.shape[0]


def _rows_for_primitive(pr: dict) -> List[np.ndarray]:
    """Lower one SceneSpec primitive dict into packed rows."""
    t = pr["type"]
    rows = []

    def row(center, he, radius=0.0, yaw=0.0, sign=1.0, family=0.0):
        r = np.zeros(12, np.float32)
        r[0:3] = center
        r[3:6] = he
        r[6] = radius
        r[7] = np.cos(yaw)
        r[8] = np.sin(yaw)
        r[9] = sign
        r[10] = family
        r[11] = 1.0
        return r

    def capsule(a, b, rad):
        r = np.zeros(12, np.float32)
        r[0:3], r[3:6], r[6], r[10], r[9], r[11] = a, b, rad, 1.0, 1.0, 1.0
        return r

    if t == "box":
        rows.append(row(pr["center"], pr["half_extents"]))
    elif t == "sphere":
        rows.append(row(pr["center"], [0.0, 0.0, 0.0], radius=pr["radius"]))
    elif t == "room":
        lo = np.asarray(pr["bounds_min"], np.float32)
        hi = np.asarray(pr["bounds_max"], np.float32)
        rows.append(row((lo + hi) / 2, (hi - lo) / 2, sign=-1.0))
    elif t == "cylinder":
        c = np.asarray(pr["center"], np.float32)
        hh, rad = float(pr["half_height"]), float(pr["radius"])
        rows.append(capsule(c + [0, 0, -(hh - rad)], c + [0, 0, +(hh - rad)], rad))
    elif t == "capsule":
        rows.append(capsule(np.asarray(pr["a"], np.float32), np.asarray(pr["b"], np.float32),
                            float(pr["radius"])))
    elif t == "gate":
        c = np.asarray(pr["center"], np.float32)
        yaw = float(pr.get("yaw", 0.0))
        ih, th_ = float(pr["inner_half"]), float(pr["thickness"])
        outer = ih + 2 * th_
        cy, sy = np.cos(yaw), np.sin(yaw)

        def world(local):
            lx, ly, lz = local
            return c + np.asarray([cy * lx - sy * ly, sy * lx + cy * ly, lz])

        bar = th_
        # top/bottom bars span the full outer width; side bars fill between
        rows.append(row(world([0, 0, +(ih + bar)]), [bar, outer, bar], yaw=yaw))
        rows.append(row(world([0, 0, -(ih + bar)]), [bar, outer, bar], yaw=yaw))
        rows.append(row(world([0, +(ih + bar), 0]), [bar, bar, ih], yaw=yaw))
        rows.append(row(world([0, -(ih + bar), 0]), [bar, bar, ih], yaw=yaw))
    else:
        raise ValueError(f"unsupported primitive type {t!r}")
    return rows


def pack_arrays(specs: Sequence[SceneSpec], min_k: int = 0, min_kb: int = 0,
                min_kc: int = 0) -> dict:
    """SceneSpec list → numpy arrays (params, colors, semantic, bbox, boxes,
    capsules), scenes padded to a common K; the ``min_*`` floors keep the
    shapes of an earlier scene when scenes rotate."""
    all_rows, all_colors, all_sems = [], [], []
    for spec in specs:
        rows, colors, sems = [], [], []
        for pr in spec.primitives:
            col = np.asarray(pr.get("color", [180, 180, 180]), np.float32)
            sem = int(pr.get("semantic", 0))
            for r in _rows_for_primitive(pr):
                rows.append(r)
                colors.append(col)
                sems.append(sem)
        all_rows.append(np.stack(rows))
        all_colors.append(np.stack(colors))
        all_sems.append(np.asarray(sems, np.int32))

    for rows_i in all_rows:
        # a box-family row with BOTH half_extents>0 and radius>0 is only a
        # lower-bound slab candidate for the analytic tracer
        rounded = ((rows_i[:, 10] < 0.5) & (rows_i[:, 6] > 1e-6)
                   & (rows_i[:, 3:6].sum(-1) > 1e-6))
        if rounded.any():
            warnings.warn(
                "scene contains a GENERAL rounded box (half_extents>0 AND "
                "radius>0): the analytic tracer's candidate for it is a lower "
                "bound. Render it with analytic_refine >= 4.",
                stacklevel=3)

    K = max(max(r.shape[0] for r in all_rows), min_k)
    S = len(specs)
    params = np.zeros((S, K, 12), np.float32)
    colors = np.zeros((S, K, 3), np.float32)
    sems = np.zeros((S, K), np.int32)
    for i, (r, c, s) in enumerate(zip(all_rows, all_colors, all_sems)):
        params[i, : r.shape[0]] = r
        colors[i, : c.shape[0]] = c
        sems[i, : s.shape[0]] = s

    lo = np.min([s.bounds_min for s in specs], axis=0)
    hi = np.max([s.bounds_max for s in specs], axis=0)
    boxes, capsules = _family_split(params, min_kb, min_kc)
    return dict(params=params, colors=colors, semantic=sems,
                bbox=np.stack([lo, hi]).astype(np.float32), boxes=boxes, capsules=capsules)


def scene_from_arrays(arrays: dict, eps: float, device=None) -> PrimitiveScene:
    """Numpy arrays (as :func:`pack_arrays` returns them) → PrimitiveScene."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return PrimitiveScene(
        params=t(arrays["params"]),
        colors=t(arrays["colors"]),
        semantic=t(arrays["semantic"], torch.int32),
        bbox=t(arrays["bbox"]),
        eps=t(eps),
        boxes=t(arrays["boxes"]),
        capsules=t(arrays["capsules"]),
    )


def pack_scenes(specs: Sequence[SceneSpec], device=None, min_k: int = 0, min_kb: int = 0,
                min_kc: int = 0) -> PrimitiveScene:
    """SceneSpec list → PrimitiveScene on ``device``, padded at least to the
    ``min_*`` floors."""
    return scene_from_arrays(pack_arrays(specs, min_k, min_kb, min_kc), SURFACE_EPS, device)


# ---------------------------------------------------------------------------
# dense evaluation
# ---------------------------------------------------------------------------


def prim_distances(params: Tensor, p: Tensor) -> Tensor:
    """All primitive distances. params (..., K, 12) broadcast against
    p (..., 3) → (..., K)."""
    pe = p[..., None, :]  # (..., 1, 3)
    c = params[..., 0:3]
    he = params[..., 3:6]
    radius = params[..., 6]
    cy, sy = params[..., 7], params[..., 8]
    sign = params[..., 9]
    family = params[..., 10]
    active = params[..., 11]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)

    # family 0: yaw-rotated rounded box
    d0 = pe - c
    x = cy * d0[..., 0] + sy * d0[..., 1]
    y = -sy * d0[..., 0] + cy * d0[..., 1]
    z = d0[..., 2]
    qx = torch.abs(x) - he[..., 0]
    qy = torch.abs(y) - he[..., 1]
    qz = torch.abs(z) - he[..., 2]
    ox = torch.maximum(qx, zero)
    oy = torch.maximum(qy, zero)
    oz = torch.maximum(qz, zero)
    outside = torch.sqrt(ox * ox + oy * oy + oz * oz + 1e-12)
    inside = torch.minimum(torch.maximum(qx, torch.maximum(qy, qz)), zero)
    d_box = (outside + inside - radius) * sign

    # family 1: capsule a→b
    pa = pe - c
    ba = he - c
    denom = torch.sum(ba * ba, dim=-1) + 1e-9
    h = torch.minimum(torch.maximum(torch.sum(pa * ba, dim=-1) / denom, zero), zero + 1.0)
    diff = pa - ba * h[..., None]
    d_cap = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12) - radius

    d = torch.where(family < 0.5, d_box, d_cap)
    return torch.where(active > 0.5, d, zero + BIG)


def prim_sdf(params: Tensor, p: Tensor) -> Tensor:
    """Scene SDF: min over K. ``amin`` splits the gradient evenly between
    tied minima, as ``jnp.min`` does."""
    return torch.amin(prim_distances(params, p), dim=-1)


def prim_normal_single(prow: Tensor, p: Tensor) -> Tensor:
    """Closed-form outward unit normal of ONE primitive per point. prow
    (..., 12) is a per-point parameter row (the winning primitive), p
    (..., 3) → (..., 3). Equals the gradient of :func:`prim_distances`: the
    rounded-slab gradient rotated through the yaw frame for a box, radial
    from the closest axis point for a capsule."""
    c = prow[..., 0:3]
    he = prow[..., 3:6]
    cy, sy = prow[..., 7], prow[..., 8]
    sign = prow[..., 9]
    family = prow[..., 10]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)

    # box family: local frame
    d0 = p - c
    x = cy * d0[..., 0] + sy * d0[..., 1]
    y = -sy * d0[..., 0] + cy * d0[..., 1]
    z = d0[..., 2]
    qx = torch.abs(x) - he[..., 0]
    qy = torch.abs(y) - he[..., 1]
    qz = torch.abs(z) - he[..., 2]
    ox = torch.maximum(qx, zero)
    oy = torch.maximum(qy, zero)
    oz = torch.maximum(qz, zero)
    out_norm = torch.sqrt(ox * ox + oy * oy + oz * oz + 1e-12)
    outside = out_norm > 1e-6
    # outside: gradient of |max(q, 0)|; inside: the face of max q
    m = torch.maximum(qx, torch.maximum(qy, qz))
    nlx = torch.where(outside, ox / out_norm, (qx >= m).to(p.dtype)) * torch.sign(x)
    nly = torch.where(outside, oy / out_norm, (qy >= m).to(p.dtype)) * torch.sign(y)
    nlz = torch.where(outside, oz / out_norm, (qz >= m).to(p.dtype)) * torch.sign(z)
    n_box = torch.stack([cy * nlx - sy * nly, sy * nlx + cy * nly, nlz], dim=-1) * sign[..., None]

    # capsule family: the h-dependence cancels at the optimum, so the
    # gradient of the distance is diff/|diff| exactly
    ba = he - c
    pa = p - c
    denom = torch.sum(ba * ba, dim=-1) + 1e-9
    h = torch.clamp(torch.sum(pa * ba, dim=-1) / denom, 0.0, 1.0)
    diff = pa - ba * h[..., None]
    n_cap = diff / (torch.linalg.vector_norm(diff, dim=-1, keepdim=True) + 1e-9)

    n = torch.where(family[..., None] < 0.5, n_box, n_cap)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)


def scene_sdf_grouped(scene: PrimitiveScene, p: Tensor) -> Tensor:
    """p (S, Ns, 3) → (S, Ns): each scene's points against its own rows."""
    return prim_sdf(scene.params[:, None], p)


def scene_sdf_flat(scene: PrimitiveScene, sid: Tensor, p: Tensor) -> Tensor:
    """Flat API (N,3)+(N,): gathers the per-scene params only when S > 1."""
    if scene.num_scene == 1:
        return prim_sdf(scene.params[0], p)
    return prim_sdf(scene.params[sid], p)


def scene_normal_grouped(scene: PrimitiveScene, p: Tensor) -> Tensor:
    """Outward unit normals (S, Ns, 3) at points p (S, Ns, 3): the
    normalised gradient of each scene's min-SDF, by autograd (each output
    depends on its own point only, so the gradient of the sum is per
    point). Works under ``torch.no_grad()``; the result carries a graph only
    where p requires a gradient."""
    keep = p.requires_grad
    with torch.enable_grad():
        x = p if keep else p.detach().requires_grad_(True)
        g, = torch.autograd.grad(prim_sdf(scene.params[:, None], x).sum(), x, create_graph=keep)
        n = g / (torch.linalg.vector_norm(g, dim=-1, keepdim=True) + 1e-9)
    return n if keep else n.detach()


def nearest_primitive_grouped(scene: PrimitiveScene, p: Tensor) -> Tensor:
    """(S, Ns) index of the nearest primitive row at each point (the first
    on a tie), for colour and semantic shading."""
    return torch.argmin(prim_distances(scene.params[:, None], p), dim=-1)
