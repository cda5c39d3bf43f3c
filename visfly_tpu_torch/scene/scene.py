"""Host-side scene description and the procedural presets (counterpart of
``visfly_tpu/scene/scene.py``).

Named presets mirror the reference dataset scene families:
``box15_wall_empty``, ``garage_simple``, ``garage_crossing``,
``garage_landing``, ``racing``, ``forest`` and ``box_random``. The generators
draw from ``numpy.random.default_rng(seed)`` in the same order as the JAX
package, so one seed gives the same scene in both.

``load_scenes_for_env`` builds an env's scene: a procedural preset packs
into a ``PrimitiveScene``; a mesh file (OBJ, GLB) with ``backend: "grid"``
bakes into a :class:`SceneData` (SDF grid plus the exact triangles), and
``scene_kwargs["data"]`` hands over one already baked. Not ported yet, each
raising ``NotImplementedError``: the default backend of a mesh file (box
decomposition), habitat datasets and directories of scene JSONs.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch
from torch import Tensor

from . import primitives as prim


@dataclasses.dataclass
class SceneSpec:
    """One scene: bounds + primitive list (with color/semantic metadata)."""

    bounds_min: np.ndarray
    bounds_max: np.ndarray
    primitives: List[Dict[str, Any]]
    name: str = "scene"

    def sdf(self, p: np.ndarray) -> np.ndarray:
        return prim.eval_scene_sdf(p, self.primitives)


def best_candidate_points(
    rng: np.random.Generator,
    n: int,
    bounds_min: np.ndarray,
    bounds_max: np.ndarray,
    n_candidates: int = 16,
) -> np.ndarray:
    """Mitchell best-candidate (blue-noise) placement: each new point is the
    candidate farthest from all previously chosen points."""
    pts: List[np.ndarray] = []
    for _ in range(n):
        cand = rng.uniform(bounds_min, bounds_max, size=(n_candidates, len(bounds_min)))
        if not pts:
            pts.append(cand[0])
            continue
        d = np.linalg.norm(cand[:, None, :] - np.asarray(pts)[None, :, :], axis=-1).min(axis=1)
        pts.append(cand[int(np.argmax(d))])
    return np.asarray(pts)


_COLORS = np.asarray(
    [
        [188, 143, 143],
        [112, 128, 144],
        [160, 82, 45],
        [85, 107, 47],
        [70, 130, 180],
        [205, 133, 63],
        [119, 136, 153],
        [139, 69, 19],
    ],
    dtype=np.uint8,
)


def _room(bmin, bmax, open_top: bool = True) -> Dict[str, Any]:
    """Hollow room. ``open_top`` lifts the ceiling out of the geometry; the
    flight volume's z bound is enforced by the out-of-bounds test."""
    bmax_geo = np.asarray(bmax, np.float32).copy()
    if open_top:
        bmax_geo[2] += 50.0
    return {
        "type": "room",
        "bounds_min": np.asarray(bmin, np.float32),
        "bounds_max": bmax_geo,
        "color": np.asarray([210, 210, 205], np.uint8),
        "semantic": 1,
    }


def _column(x, y, z, radius, half_height, i, semantic):
    return {
        "type": "cylinder",
        "center": np.asarray([x, y, z], np.float32),
        "radius": radius,
        "half_height": half_height,
        "color": _COLORS[i % len(_COLORS)],
        "semantic": semantic,
    }


def make_scene(name: str, seed: int = 42, **kwargs) -> SceneSpec:
    """Procedural scene presets."""
    rng = np.random.default_rng(seed)

    if name in ("box15_wall_empty", "empty"):
        bmin, bmax = np.asarray([-30.0, -30.0, 0.0]), np.asarray([30.0, 30.0, 8.0])
        return SceneSpec(bmin, bmax, [_room(bmin, bmax)], name)

    if name in ("garage_simple", "garage_simple_l_medium", "cluttered"):
        # rectangular garage with random columns and boxes between spawn
        # (x≈1) and target (x≈9..14); ``obstacle_scale`` shrinks obstacle
        # cross-sections without changing the primitive count
        bmin, bmax = np.asarray([-2.0, -6.0, 0.0]), np.asarray([18.0, 6.0, 5.0])
        prims = [_room(bmin, bmax)]
        n_obs = kwargs.get("n_obstacles", 14)
        scale = float(kwargs.get("obstacle_scale", 1.0))
        pts = best_candidate_points(rng, n_obs, np.asarray([2.5, -5.0]), np.asarray([13.0, 5.0]))
        for i, (x, y) in enumerate(pts):
            if rng.uniform() < 0.6:
                prims.append(_column(x, y, 2.5, float(rng.uniform(0.25, 0.5)) * scale, 2.5,
                                     i, 2 + (i % 8)))
            else:
                prims.append(
                    {
                        "type": "box",
                        "center": np.asarray([x, y, float(rng.uniform(0.6, 1.8))], np.float32),
                        "half_extents": np.asarray(
                            [
                                rng.uniform(0.3, 0.8) * scale,
                                rng.uniform(0.3, 0.8) * scale,
                                rng.uniform(0.6, 1.8),
                            ],
                            np.float32,
                        ),
                        "color": _COLORS[i % len(_COLORS)],
                        "semantic": 2 + (i % 8),
                    }
                )
        return SceneSpec(bmin, bmax, prims, name)

    if name in ("garage_crossing", "crossing"):
        bmin, bmax = np.asarray([-8.0, -8.0, 0.0]), np.asarray([8.0, 8.0, 5.0])
        prims = [_room(bmin, bmax)]
        for i, (x, y) in enumerate(
            best_candidate_points(rng, kwargs.get("n_obstacles", 10),
                                  np.asarray([-6.0, -6.0]), np.asarray([6.0, 6.0]))
        ):
            prims.append(_column(x, y, 2.5, float(rng.uniform(0.2, 0.45)), 2.5, i, 2 + (i % 8)))
        return SceneSpec(bmin, bmax, prims, name)

    if name in ("garage_landing", "landing"):
        bmin, bmax = np.asarray([-4.0, -4.0, 0.0]), np.asarray([8.0, 4.0, 5.0])
        prims = [_room(bmin, bmax)]
        # landing pad: a dark flat box
        prims.append(
            {
                "type": "box",
                "center": np.asarray(kwargs.get("pad_center", [2.0, 0.0, 0.05]), np.float32),
                "half_extents": np.asarray([0.5, 0.5, 0.05], np.float32),
                "color": np.asarray([35, 35, 40], np.uint8),
                "semantic": 9,
            }
        )
        return SceneSpec(bmin, bmax, prims, name)

    if name in ("racing", "racing_gates"):
        bmin, bmax = np.asarray([-12.0, -12.0, 0.0]), np.asarray([12.0, 12.0, 6.0])
        prims = [_room(bmin, bmax)]
        gates = kwargs.get(
            "gates",
            [
                ([6.0, 0.0, 2.0], np.pi / 2),
                ([0.0, 6.0, 2.0], 0.0),
                ([-6.0, 0.0, 2.0], np.pi / 2),
                ([0.0, -6.0, 2.0], 0.0),
            ],
        )
        for i, (c, yaw) in enumerate(gates):
            prims.append(
                {
                    "type": "gate",
                    "center": np.asarray(c, np.float32),
                    "yaw": float(yaw),
                    "inner_half": 0.7,
                    "thickness": 0.08,
                    "color": np.asarray([240, 120, 20], np.uint8),
                    "semantic": 10 + i,
                }
            )
        return SceneSpec(bmin, bmax, prims, name)

    if name == "forest":
        bmin, bmax = np.asarray([-10.0, -10.0, 0.0]), np.asarray([10.0, 10.0, 6.0])
        prims = [_room(bmin, bmax)]
        for i, (x, y) in enumerate(
            best_candidate_points(rng, kwargs.get("n_obstacles", 24), bmin[:2] + 1, bmax[:2] - 1)
        ):
            prims.append(_column(x, y, 3.0, float(rng.uniform(0.15, 0.35)), 3.0, i, 2))
        return SceneSpec(bmin, bmax, prims, name)

    if name == "box_random":
        bmin, bmax = np.asarray([-8.0, -8.0, 0.0]), np.asarray([8.0, 8.0, 5.0])
        prims = [_room(bmin, bmax)]
        for i, (x, y) in enumerate(
            best_candidate_points(rng, kwargs.get("n_obstacles", 12), bmin[:2] + 1, bmax[:2] - 1)
        ):
            prims.append(
                {
                    "type": "sphere" if rng.uniform() < 0.3 else "box",
                    "center": np.asarray([x, y, rng.uniform(0.5, 2.0)], np.float32),
                    "radius": float(rng.uniform(0.3, 0.8)),
                    "half_extents": np.asarray([rng.uniform(0.3, 0.9)] * 3, np.float32),
                    "color": _COLORS[i % len(_COLORS)],
                    "semantic": 2 + (i % 8),
                }
            )
        return SceneSpec(bmin, bmax, prims, name)

    raise ValueError(f"unknown scene preset {name!r}")


SCENE_PATH_ALIASES = {
    # reference dataset paths → presets
    "box15_wall_empty": "box15_wall_empty",
    "box15_center_wall_empty": "box15_wall_empty",
    "garage_simple_l_medium": "garage_simple",
    "garage_crossing": "garage_crossing",
    "garage_landing": "garage_landing",
    "racing": "racing",
}


def resolve_scene_path(path: str) -> str:
    """Map a reference-style dataset path to a preset name."""
    base = path.rstrip("/").split("/")[-1]
    return SCENE_PATH_ALIASES.get(base, base)


# ---------------------------------------------------------------------------
# baked scenes: dense grids plus the exact triangles
# ---------------------------------------------------------------------------


class SceneData(NamedTuple):
    """Stacked multi-scene grids on the device.

    sdf       (S, X, Y, Z) float32 signed distance
    albedo    (S, X, Y, Z, 3) uint8 nearest-surface colour
    semantic  (S, X, Y, Z) uint8 nearest-surface semantic id
    origin    (3,) float32 grid frame origin, shared by the scenes
    spacing   () float32 cell size
    bbox      (2, 3) float32 world bounds (union)
    triangles (S, T, 9) float32 zero-padded soup [a | b | c], or ``()``:
              when present cameras trace the true mesh
              (``render/tri_trace.py``) and collision queries answer exactly
              (``queries.tri_closest_point``)
    tri_uv, tri_rect, atlas   texture tables of the exact-triangle camera;
              always ``()`` here (textures are not ported)
    """

    sdf: Tensor
    albedo: Tensor
    semantic: Tensor
    origin: Tensor
    spacing: Tensor
    bbox: Tensor
    triangles: Any = ()
    tri_uv: Any = ()
    tri_rect: Any = ()
    atlas: Any = ()

    @property
    def num_scene(self) -> int:
        return self.sdf.shape[0]

    @property
    def has_triangles(self) -> bool:
        return isinstance(self.triangles, Tensor) and self.triangles.dim() == 3


def scene_data_from_arrays(arrays: dict, device=None) -> SceneData:
    """Numpy arrays (keys sdf, albedo, semantic, origin, spacing, bbox and,
    optionally, triangles) → :class:`SceneData` on ``device``."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    tris = arrays.get("triangles", ())
    return SceneData(
        sdf=t(arrays["sdf"], torch.float32),
        albedo=t(arrays["albedo"], torch.uint8),
        semantic=t(arrays["semantic"], torch.uint8),
        origin=t(arrays["origin"], torch.float32),
        spacing=t(arrays["spacing"], torch.float32),
        bbox=t(arrays["bbox"], torch.float32),
        triangles=t(tris, torch.float32) if getattr(tris, "ndim", 0) == 3 else (),
    )


def _tile_scene_data(data: SceneData, num_scene: int) -> SceneData:
    """A single-scene SceneData repeated along the scene axis."""
    def tile(x):
        if not isinstance(x, Tensor) or x.dim() == 0:
            return x
        return x.repeat(num_scene, *([1] * (x.dim() - 1)))

    return data._replace(sdf=tile(data.sdf), albedo=tile(data.albedo),
                         semantic=tile(data.semantic), triangles=tile(data.triangles))


_MESH_EXT = (".glb", ".gltf", ".obj")


def load_scenes_for_env(env):
    """Build the device scene from an env's ``scene_kwargs``: a pre-baked
    ``data``, a mesh file with ``backend: "grid"`` (one bake, repeated over
    ``env.num_scene``), or a procedural preset, one scene per
    ``env.num_scene`` with seeds ``seed, seed + 1, ...``."""
    kw = dict(env.scene_kwargs)
    path = kw.get("path", "box15_wall_empty")
    seed = kw.get("seed", env.seed)
    if "data" in kw:
        data = kw["data"]
        if not isinstance(data, SceneData):
            raise TypeError(f"scene_kwargs['data'] must be a SceneData; got {type(data).__name__}")
        data = SceneData(*(x.to(env.device) if isinstance(x, Tensor) else x for x in data))
        if data.num_scene == 1 and env.num_scene > 1:
            data = _tile_scene_data(data, env.num_scene)
        return data
    if isinstance(path, str) and os.path.isfile(path) and path.lower().endswith(_MESH_EXT):
        if kw.get("backend", "primitive") != "grid":
            raise NotImplementedError(
                "a mesh file loads with scene_kwargs backend='grid' only; the default, its "
                "decomposition into boxes (scene/decompose.py), is not ported yet (ROADMAP: "
                "Queue A item 18, imported meshes: decompose)")
        from .mesh import bake_mesh_scene

        data = bake_mesh_scene(path, spacing=kw.get("sdf_spacing", 0.1),
                               margin=kw.get("margin", 0.5), device=env.device)
        return _tile_scene_data(data, env.num_scene) if env.num_scene > 1 else data
    if isinstance(path, str) and (os.path.isfile(path) or os.path.isdir(path)):
        raise NotImplementedError(
            "habitat scene instances, dataset configs and directories of scene JSONs are not "
            "ported yet (ROADMAP: Queue A item 20, habitat datasets and scene directories)")
    preset = resolve_scene_path(path)
    specs = [make_scene(preset, seed=seed + i, **kw.get("scene_gen_kwargs", {}))
             for i in range(env.num_scene)]
    return _build_scene(env, specs)


def _build_scene(env, specs):
    kw = dict(env.scene_kwargs)
    if kw.get("backend", "primitive") != "primitive":
        raise NotImplementedError(
            "baking a procedural preset into a dense grid (bake_scenes) is not ported yet "
            "(ROADMAP: Queue A item 18, imported meshes: grids of presets)")
    from .prim_scene import pack_scenes

    old = getattr(env, "scene", None)
    floors = {}
    if old is not None and hasattr(old, "params"):
        # a rotated scene keeps at least the rows of the one it replaces, as
        # the JAX package keeps its compiled shapes
        floors = dict(min_k=old.params.shape[1], min_kb=old.boxes.shape[1],
                      min_kc=old.capsules.shape[1])
    return pack_scenes(specs, device=env.device, **floors)
