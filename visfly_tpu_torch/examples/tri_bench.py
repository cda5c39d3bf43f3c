"""Exact-triangle rendering benchmark on dense stage meshes (counterpart of
``examples/tri_bench.py``).

A garage OBJ of 30 boxes (floor, ceiling, four walls, 24 pillars; 360
triangles) is subdivided 1:4 ``level`` times (5,760 / 23,040 / 92,160
triangles at levels 2 / 3 / 4) and seen by ``--cams`` cameras at
``--res``×``--res`` depth, 1,048,576 rays at the defaults. For each level
three things are timed, each the median of ``--iters`` calls between CUDA
events (the host clock on the CPU), with the origins of call ``i`` moved by
``1e-4·i`` m as the JAX script moves them:

- the frame batch, :func:`~visfly_tpu_torch.render.tri_trace.tri_trace_tiled`
  with the cameras as whole cameras (``img_w``, ``cam_rays``): the prepass,
  the kernel and the normals;
- the prepass alone, :func:`~visfly_tpu_torch.render.tri_trace.plan_tiles`;
- the kernel alone, :func:`~visfly_tpu_torch.render.tri_kernel.tri_first_hit`
  on that plan.

It prints ms a frame batch, cam-fps, Mray/s, the prepass's and the kernel's
ms and the kernel the tier launches. Nothing is subtracted from any time.
``--check`` holds the first 8 cameras, traced as the frame batch traces them,
against :func:`~visfly_tpu_torch.render.tri_trace.tri_trace_brute` and prints
the rays whose hit flag differs, the largest depth error where both hit and
the rays that hit both ways with different triangles that do not tie: over
all rays, and over the rays of the tiles that see no more than the cap keeps.
Past the cap a tile drops the blocks whose centres are farthest, and a ray
whose first hit lies in one sees what is behind it (``--cap`` with the mesh's
size makes every tile exact).

    python -m visfly_tpu_torch.examples.tri_bench [--levels 2 3 4] [--cams 256] [--res 64]
        [--iters 20] [--cap N] [--check] [--cluster B] [--backface]
        [--variant scalar|merged|mx|wl]
"""
from __future__ import annotations

import argparse
import os
import statistics
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import quaternion as quat
from ..render.camera import camera_rays_components
from ..render.tri_kernel import TILE, count_name, tri_first_hit
from ..render.tri_trace import (VARIANTS, _cluster_ids_prepass, default_tri_cap, pack_triangles,
                                plan_tiles, tri_cull_compact, tri_trace_brute, tri_trace_tiled)
from .mesh_assets import make_garage_obj

MAX_DEPTH = 20.0
CHECK_CAMS = 8
TIE_TOL = 1e-3  # m: two winners closer than this along the ray tie


def subdivide(v: np.ndarray, f: np.ndarray, levels: int):
    """1:4 midpoint subdivision, ``levels`` times."""
    for _ in range(levels):
        tris = v[f.reshape(-1)].reshape(-1, 3, 3)
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        new = np.concatenate([
            np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)])
        v = new.reshape(-1, 3)
        f = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    return v, f


def load_garage(levels: int):
    """The 24-pillar garage OBJ, written and read back as a user's file is,
    subdivided ``levels`` times → (verts (V, 3) float32, faces (F, 3) int32)."""
    with tempfile.TemporaryDirectory(prefix="tri_bench_") as tmp:
        path = make_garage_obj(os.path.join(tmp, "tri_bench_garage.obj"), n_pillars=24)
        verts, faces = [], []
        with open(path) as fh:
            for line in fh:
                p = line.split()
                if not p:
                    continue
                if p[0] == "v":
                    verts.append([float(x) for x in p[1:4]])
                elif p[0] == "f":
                    faces.append([int(x.split("/")[0]) - 1 for x in p[1:4]])
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
    return subdivide(v, f, levels)


def camera_batch(n: int, seed: int = 0, device="cuda"):
    """``n`` cameras inside the garage, level, at random yaw → (pos (n, 3),
    q (n, 4))."""
    rng = np.random.RandomState(seed)
    pos = np.stack([rng.uniform(2, 14, n), rng.uniform(-3, 3, n),
                    rng.uniform(0.8, 2.8, n)], -1).astype(np.float32)
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, n).astype(np.float32), device=device)
    zero = torch.zeros(n, device=device)
    return torch.as_tensor(pos, device=device), quat.from_euler(zero, zero, yaw)


def batch_rays(cams: int, res: int, device="cuda"):
    """The rays of :func:`camera_batch`'s cameras, component-major and
    camera after camera: (origins (3, 1, cams·res²), dirs (3, 1, cams·res²))."""
    spec = {"sensor_type": "depth", "resolution": [res, res]}
    pos, q = camera_batch(cams, device=device)
    o_c, d_c, _ = camera_rays_components(spec, pos, q)  # (3, N), (3, N, HW)
    hw = res * res
    o_full = o_c[:, :, None].expand(3, cams, hw).reshape(3, 1, -1).contiguous()
    return o_full, d_c.reshape(3, 1, -1).contiguous()


def median_ms(fn: Callable[[int], object], iters: int, device) -> float:
    """Median ms of ``fn(i)`` over ``i = 0 … iters − 1``, after one
    untimed call: CUDA events around each call on the card (its host time
    included), the host clock on the CPU."""
    fn(0)
    times = []
    for i in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(i)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(i)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def untied(tris: torch.Tensor, o_c: torch.Tensor, d_c: torch.Tensor, gid_a: torch.Tensor,
           gid_b: torch.Tensor) -> torch.Tensor:
    """Rays (S, R) whose winners ``gid_a`` and ``gid_b`` differ although the
    ray does not meet both triangles within ``TIE_TOL`` of one t (shared
    edges and coplanar neighbours tie; either id is then right)."""
    differ = gid_a != gid_b
    idx = differ.nonzero(as_tuple=True)
    out = torch.zeros_like(differ)
    if idx[0].numel() == 0:
        return out
    o = o_c[:, idx[0], idx[1]].T
    d = d_c[:, idx[0], idx[1]].T
    ts = []
    for gid in (gid_a, gid_b):
        rows = tris[idx[0], gid[idx].long()]
        a, e1, e2 = rows[:, 0:3], rows[:, 3:6] - rows[:, 0:3], rows[:, 6:9] - rows[:, 0:3]
        p = torch.linalg.cross(d, e2)
        det = (e1 * p).sum(-1)
        inv = 1.0 / torch.where(det.abs() > 1e-9, det, 1.0)
        tv = o - a
        u = (tv * p).sum(-1) * inv
        q = torch.linalg.cross(tv, e1)
        v = (d * q).sum(-1) * inv
        on = (det.abs() > 1e-9) & (u >= -1e-3) & (v >= -1e-3) & (u + v <= 1 + 1e-3)
        ts.append(torch.where(on, (e2 * q).sum(-1) * inv, float("nan")))
    out[idx] = ~((ts[0] - ts[1]).abs() <= TIE_TOL)
    return out


def overflowing_rays(tris, o_c, d_c, cap, res, hw, backface=False, soup_cluster=None):
    """Rays (1, R) of the tiles that see more blocks or triangles than
    ``cap`` keeps (the block lists' cap; the worklist's budget is not
    counted): only there may the image differ from the brute force."""
    plan = plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap, res, hw, backface,
                      soup_cluster=soup_cluster)
    img_w = 32 if plan.unpack is not None else res
    cap = min(cap, tris.shape[1])
    if plan.lists.block > 1:
        _, visible, _, block = _cluster_ids_prepass(tris, plan.origins_c, plan.dirs_c, MAX_DEPTH,
                                                    cap, img_w, backface, soup_cluster)
        over = visible > max(1, cap // block)
    else:
        ids, visible, _ = tri_cull_compact(tris, plan.origins_c, plan.dirs_c, MAX_DEPTH, cap,
                                           img_w, backface)
        over = visible > ids.shape[2]
    per_ray = over.repeat_interleave(TILE, dim=1)
    return per_ray if plan.unpack is None else plan.unpack(per_ray)


def check_level(tris, o_full, d_full, hw, trace, over) -> dict:
    """The first :data:`CHECK_CAMS` cameras through ``trace(o, d)`` against
    the brute force → the numbers the check prints, all rays and those of
    the tiles within the cap (``over(o, d)`` marks the others), and both
    results and the rays under ``"got"``, ``"want"`` and ``"rays_c"``."""
    k = min(CHECK_CAMS, o_full.shape[2] // hw)
    o_s = o_full[:, :, :k * hw].contiguous()
    d_s = d_full[:, :, :k * hw].contiguous()
    got = trace(o_s, d_s)[:4]
    want = tri_trace_brute(tris, o_s.permute(1, 2, 0), d_s.permute(1, 2, 0), MAX_DEPTH)
    t_p, hit_p, _, gid_p = got
    t_x, hit_x, _, gid_x = want
    past = over(o_s, d_s)
    both = hit_p & hit_x
    err = torch.where(both, (t_p - t_x).abs(), 0.0)
    ids_off = untied(tris, o_s, d_s, gid_p, gid_x) & both
    flip = hit_p != hit_x
    return {"cams": k, "rays": k * hw, "hit_mismatches": int(flip.sum()),
            "depth_err_max": float(err.max()), "untied_id_mismatches": int(ids_off.sum()),
            "rays_past_cap": int(past.sum()),
            "hit_mismatches_within_cap": int((flip & ~past).sum()),
            "depth_err_max_within_cap": float(torch.where(past, 0.0, err).max()),
            "untied_id_mismatches_within_cap": int((ids_off & ~past).sum()),
            "got": (t_p, hit_p, gid_p), "want": (t_x, hit_x, gid_x), "rays_c": (o_s, d_s)}


def bench_level(level: int, args, o_full: torch.Tensor, d_full: torch.Tensor,
                device: torch.device) -> dict:
    """One mesh size: the three timings, and the check where asked."""
    v, f = load_garage(level)
    tris = torch.as_tensor(pack_triangles(v, f)[None], device=device)
    T = tris.shape[1]
    cap = args.cap or default_tri_cap(T)
    hw = args.res * args.res
    cams = (args.res, hw, args.backface)  # img_w, cam_rays, backface: whole cameras
    kw = dict(variant=args.variant or "scalar", soup_cluster=args.cluster or None)
    origins = [o_full + 1e-4 * (i + 1) for i in range(args.iters)]

    def frame(i):
        return tri_trace_tiled(tris, origins[i], d_full, MAX_DEPTH, cap, *cams, **kw)

    plans = [None] * args.iters

    def prepass(i):
        plans[i] = plan_tiles(tris, origins[i], d_full, MAX_DEPTH, cap, *cams, **kw)

    def kernel(i):
        p = plans[i]
        return tri_first_hit(tris, p.lists, p.origins_c, p.dirs_c, MAX_DEPTH, p.form,
                             p.origin_tiles, p.mode)

    ms = median_ms(frame, args.iters, device)
    prepass_ms = median_ms(prepass, args.iters, device)
    kernel_ms = median_ms(kernel, args.iters, device)
    p = plans[0]
    tier = count_name(p.form, p.lists.block, p.mode, p.lists.start is not None)
    out = {"level": level, "T": T, "cap": cap, "tier": tier, "block": p.lists.block,
           "ms": ms, "cam_fps": args.cams / ms * 1e3,
           "mray_s": args.cams * hw / ms / 1e3, "prepass_ms": prepass_ms,
           "kernel_ms": kernel_ms}
    print(f"T={T:6d} cap={cap:6d}: {ms:7.2f} ms/frame-batch = {out['cam_fps']:8,.0f} cam-fps "
          f"({out['mray_s']:.1f} Mray/s); prepass {prepass_ms:.2f} ms, kernel "
          f"{kernel_ms:.2f} ms ({tier})", flush=True)
    if args.check:
        out["check"] = check_level(
            tris, o_full, d_full, hw,
            lambda o, d: tri_trace_tiled(tris, o, d, MAX_DEPTH, cap, *cams, **kw),
            lambda o, d: overflowing_rays(tris, o, d, cap, *cams, kw["soup_cluster"]))
        c = out["check"]
        print(f"   check ({c['cams']} cams): hit mismatches {c['hit_mismatches']} / {c['rays']}, "
              f"depth err max {c['depth_err_max']:.2e}, untied id mismatches "
              f"{c['untied_id_mismatches']}; on the {c['rays'] - c['rays_past_cap']} rays of "
              f"tiles within the cap: {c['hit_mismatches_within_cap']}, "
              f"{c['depth_err_max_within_cap']:.2e}, {c['untied_id_mismatches_within_cap']}",
              flush=True)
        out["tris"] = tris
    return out


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Run the benchmark → {"levels": [per level: "level", "T", "cap",
    "tier", "block", "ms", "cam_fps", "mray_s", "prepass_ms", "kernel_ms",
    with ``--check`` also "check" and "tris"]}."""
    p = argparse.ArgumentParser()
    p.add_argument("--levels", type=int, nargs="+", default=[2, 3, 4])
    p.add_argument("--cams", type=int, default=256)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--cap", type=int, default=0, help="override tri_cap")
    p.add_argument("--check", action="store_true",
                   help="verify exactness vs the brute force on the first 8 cameras")
    p.add_argument("--cluster", type=int, default=0,
                   help="the block size of the dense tier's lists (default 128)")
    p.add_argument("--backface", action="store_true",
                   help="cull backfacing clusters (exact: closed mesh)")
    p.add_argument("--variant", choices=list(VARIANTS), default=None,
                   help="force the dense camera kernel body")
    args = p.parse_args(argv)
    device = torch.device(device)
    o_full, d_full = batch_rays(args.cams, args.res, device)
    return {"levels": [bench_level(lvl, args, o_full, d_full, device) for lvl in args.levels]}


if __name__ == "__main__":
    main()
