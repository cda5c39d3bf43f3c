"""Host-side scene description and the procedural presets (counterpart of
``visfly_tpu/scene/scene.py``).

Named presets mirror the reference dataset scene families:
``box15_wall_empty``, ``garage_simple``, ``garage_crossing``,
``garage_landing``, ``racing``, ``forest`` and ``box_random``. The generators
draw from ``numpy.random.default_rng(seed)`` in the same order as the JAX
package, so one seed gives the same scene in both.

``load_scenes_for_env`` builds an env's scene from ``scene_kwargs``:

- ``"data"``: a :class:`SceneData` already baked, tiled over the scenes;
- a mesh file (OBJ, GLB): by default decomposed into boxes and cylinders
  (``decompose.py``) for the analytic trace kernel; with ``backend: "grid"``
  baked into a :class:`SceneData` (SDF grid, the exact triangles and a GLB's
  texture tables) for the triangle kernel;
- a habitat scene instance, a directory of them or a dataset config
  (``habitat_dataset.py``): one file per scene from the env's
  :class:`~..utils.dataloader.SimpleDataLoader`, decomposed by default, or
  with ``backend: "grid"`` baked with per-instance ids, material colours and
  textures;
- a directory of scene JSONs (``save_scene_spec``), one per scene from the
  loader;
- of a dataset or a directory, an env that holds scenes ``first ..`` of a
  larger env of ``total`` scenes (``scene_kwargs["scenes_of"] = (first,
  total)``, set by ``parallel.make_rank_env``) takes, of each batch of
  ``total`` files its loader gives, the files ``first ..``: the ones the
  larger env would put there, at the first load and at every rotation;
- a procedural preset, seeds ``seed, seed + 1, ...``; with
  ``backend: "grid"`` baked into a dense grid without triangles
  (:func:`bake_scenes`).

Primitive scenes pack into a ``PrimitiveScene``. The env keeps what a
rotation or a swap needs beside ``env.scene`` (the specs or meshes of its
scenes, the loader); :func:`swap_scene_for_env` replaces one scene in place.
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
    tri_uv    (S, T, 6) float32 each packed face's corner texcoords, or ``()``
    tri_rect  (S, T, 4) float32 its image's rectangle in the atlas, [tw th y0
              x0] in texels (tw = 0 on padding rows), or ``()``
    atlas     (S, AH, AW, 3) uint8 each scene's images stacked, or ``()``:
              with these tables the exact-triangle camera renders textured
              colour in place of the grid's albedo
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
    optionally, triangles and the texture tables tri_uv, tri_rect, atlas) →
    :class:`SceneData` on ``device``."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    def opt(key, ndim, dtype):
        x = arrays.get(key, ())
        return t(x, dtype) if getattr(x, "ndim", 0) == ndim else ()

    return SceneData(
        sdf=t(arrays["sdf"], torch.float32),
        albedo=t(arrays["albedo"], torch.uint8),
        semantic=t(arrays["semantic"], torch.uint8),
        origin=t(arrays["origin"], torch.float32),
        spacing=t(arrays["spacing"], torch.float32),
        bbox=t(arrays["bbox"], torch.float32),
        triangles=opt("triangles", 3, torch.float32),
        tri_uv=opt("tri_uv", 3, torch.float32),
        tri_rect=opt("tri_rect", 3, torch.float32),
        atlas=opt("atlas", 4, torch.uint8),
    )


def _tile_scene_data(data: SceneData, num_scene: int) -> SceneData:
    """A single-scene SceneData repeated along the scene axis: every
    per-scene field, the texture tables too (the textured camera indexes
    the stacked atlas by scene)."""
    def tile(x):
        if not isinstance(x, Tensor) or x.dim() == 0:
            return x
        return x.repeat(num_scene, *([1] * (x.dim() - 1)))

    return data._replace(**{f: tile(getattr(data, f)) for f in
                            ("sdf", "albedo", "semantic", "triangles", "tri_uv", "tri_rect",
                             "atlas")})


def bake_scenes(specs, spacing: float = 0.1, margin: float = 0.4, with_color: bool = True,
                max_cells: int = 384, device=None) -> SceneData:
    """Primitive SDFs evaluated on one dense grid shared by the scenes (the
    union of their bounds plus ``margin``), with each cell's nearest
    primitive's colour and semantic id: a grid scene without triangles,
    which cameras sphere-trace (``render_backend`` "grid"). ``with_color``
    False leaves the albedo empty."""
    lo = np.min([s.bounds_min for s in specs], axis=0) - margin
    hi = np.max([s.bounds_max for s in specs], axis=0) + margin
    shape = np.minimum(np.ceil((hi - lo) / spacing).astype(int) + 1, max_cells)
    spacing = float(np.max((hi - lo) / (shape - 1)))
    axes = [lo[i] + np.arange(shape[i]) * spacing for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).astype(np.float32)

    sdfs, colors, sems = [], [], []
    for spec in specs:
        d, nearest = None, None
        for idx, prm in enumerate(spec.primitives):
            di = prim.eval_primitive(pts, prm).astype(np.float32)
            if d is None:
                d, nearest = di, np.zeros(di.shape, np.int16)
            else:
                closer = di < d
                d = np.where(closer, di, d)
                nearest = np.where(closer, idx, nearest)
        sdfs.append(d)
        col = np.zeros((*d.shape, 3), np.uint8)
        sem = np.zeros(d.shape, np.uint8)
        for idx, prm in enumerate(spec.primitives):
            m = nearest == idx
            col[m] = prm.get("color", np.asarray([180, 180, 180], np.uint8))
            sem[m] = prm.get("semantic", 0)
        colors.append(col)
        sems.append(sem)
    return scene_data_from_arrays({
        "sdf": np.stack(sdfs),
        "albedo": np.stack(colors) if with_color else np.zeros((len(specs), 0, 0, 0, 3),
                                                               np.uint8),
        "semantic": np.stack(sems),
        "origin": lo.astype(np.float32),
        "spacing": np.float32(spacing),
        "bbox": np.stack([lo + margin, hi - margin]).astype(np.float32),
    }, device)


def save_scene_spec(spec: SceneSpec, path: str) -> None:
    """A SceneSpec as JSON, the format a directory-of-scenes dataset holds."""
    import json

    def enc(v):
        return v.tolist() if isinstance(v, np.ndarray) else v

    data = {
        "name": spec.name,
        "bounds_min": spec.bounds_min.tolist(),
        "bounds_max": spec.bounds_max.tolist(),
        "primitives": [{k: enc(v) for k, v in p.items()} for p in spec.primitives],
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def load_scene_spec(path: str) -> SceneSpec:
    """The SceneSpec :func:`save_scene_spec` wrote: lists become float32
    arrays, colours uint8, semantic ids ints."""
    import json

    with open(path) as f:
        data = json.load(f)
    prims = []
    for p in data["primitives"]:
        prm = {k: (np.asarray(v, np.float32) if isinstance(v, list) else v) for k, v in p.items()}
        if "color" in prm:
            prm["color"] = prm["color"].astype(np.uint8)
        if "semantic" in prm:
            prm["semantic"] = int(prm["semantic"])
        prims.append(prm)
    return SceneSpec(bounds_min=np.asarray(data["bounds_min"], np.float32),
                     bounds_max=np.asarray(data["bounds_max"], np.float32),
                     primitives=prims, name=data.get("name", "scene"))


def generate_scene_dataset(out_dir: str, preset: str, count: int, seed: int = 42,
                           **kwargs) -> List[str]:
    """``count`` scenes of a preset (seeds ``seed, seed + 1, ...``) written as
    ``<preset>_<i>.scene_instance.json`` under ``out_dir``; their paths."""
    paths = []
    for i in range(count):
        p = os.path.join(out_dir, f"{preset}_{i:04d}.scene_instance.json")
        save_scene_spec(make_scene(preset, seed=seed + i, **kwargs), p)
        paths.append(p)
    return paths




_MESH_EXT = (".glb", ".gltf", ".obj")
# the keys of scene_kwargs that load_habitat_scene takes
_HABITAT_KEYS = ("spacing", "margin", "max_prims", "min_cover", "max_cells")


def _is_mesh_file(path) -> bool:
    return isinstance(path, str) and os.path.isfile(path) and path.lower().endswith(_MESH_EXT)


def _habitat_mesh(env, path: str):
    """One habitat scene instance as the grid backend bakes it: (verts,
    faces, face instance ids, instance colours, texinfo)."""
    from .habitat_dataset import load_habitat_scene_mesh

    v, f, _bounds, inst, colors, tex = load_habitat_scene_mesh(
        path, env._habitat_dataset, return_instances=True, return_textures=True)
    return v, f, inst, colors, tex


def _bake_meshes(env, meshes):
    from .mesh import bake_scenes_from_meshes

    kw = env.scene_kwargs
    return bake_scenes_from_meshes(meshes, spacing=kw.get("sdf_spacing", 0.1),
                                   margin=kw.get("margin", 0.5),
                                   max_cells=kw.get("max_cells", 384), device=env.device)


def _next_files(env, kw) -> List[str]:
    """The loader's next files for the env's scenes: of the next batch of
    the larger env's scenes (``scenes_of``), the ones this env holds."""
    first, total = kw.get("scenes_of", (0, env.num_scene))
    return env._scene_loader.next(total)[first:first + env.num_scene]


def load_scenes_for_env(env):
    """Build the device scene from an env's ``scene_kwargs`` (see the module
    docstring). What a later rotation or swap needs is kept on the env:
    ``_scene_specs`` (primitive specs, one per scene), ``_scene_meshes``
    (a habitat grid scene's meshes), ``_scene_loader`` and
    ``_habitat_dataset`` (dataset paths) and ``_pack_floor``."""
    kw = dict(env.scene_kwargs)
    path = kw.get("path", "box15_wall_empty")
    seed = kw.get("seed", env.seed)
    grid = kw.get("backend", "primitive") == "grid"
    if "data" in kw:
        data = kw["data"]
        if not isinstance(data, SceneData):
            raise TypeError(f"scene_kwargs['data'] must be a SceneData; got {type(data).__name__}")
        data = SceneData(*(x.to(env.device) if isinstance(x, Tensor) else x for x in data))
        if data.num_scene == 1 and env.num_scene > 1:
            data = _tile_scene_data(data, env.num_scene)
        return data

    if _is_mesh_file(path):
        if grid:
            from .mesh import bake_mesh_scene

            data = bake_mesh_scene(path, spacing=kw.get("sdf_spacing", 0.1),
                                   margin=kw.get("margin", 0.5), device=env.device)
            return _tile_scene_data(data, env.num_scene) if env.num_scene > 1 else data
        from .decompose import decompose_mesh_scene

        spec = decompose_mesh_scene(path, spacing=kw.get("sdf_spacing", 0.1),
                                    margin=kw.get("margin", 0.5),
                                    max_prims=kw.get("max_prims", 48),
                                    min_cover=kw.get("min_cover", 0.98))
        env._scene_specs = [spec] * env.num_scene
        return _build_scene(env, env._scene_specs)

    from .habitat_dataset import is_habitat_scene_path

    if is_habitat_scene_path(path):
        from ..utils.dataloader import SimpleDataLoader
        from .habitat_dataset import (HabitatDataset, find_dataset_config,
                                      list_habitat_scenes, load_habitat_scene)

        if getattr(env, "_scene_loader", None) is None:
            files = list_habitat_scenes(path)
            if not files:
                raise FileNotFoundError(f"no scene instances under {path}")
            env._scene_loader = SimpleDataLoader(files, seed=seed)
            cfg = (path if path.endswith(".scene_dataset_config.json")
                   else find_dataset_config(files[0]))
            env._habitat_dataset = HabitatDataset(cfg) if cfg else None
        files = _next_files(env, kw)
        if grid:
            env._scene_meshes = [_habitat_mesh(env, f) for f in files]
            return _bake_meshes(env, env._scene_meshes)
        hab_kw = {k: kw[k] for k in _HABITAT_KEYS if k in kw}
        specs = [load_habitat_scene(f, env._habitat_dataset, **hab_kw) for f in files]
        # dataset scenes decompose into different primitive counts: the pack
        # is floored at the largest so far, rounded up to a whole ×8 bucket,
        # so that a swap keeps the other scenes' rows and the shapes
        n_max = max(len(s.primitives) for s in specs)
        env._pack_floor = max(int(getattr(env, "_pack_floor", 0)), -(-(n_max + 4) // 8) * 8)
        env._scene_specs = specs
        return _build_scene(env, specs)

    if os.path.isdir(path):
        from ..utils.dataloader import ChildrenPathDataset, SimpleDataLoader

        if getattr(env, "_scene_loader", None) is None:
            env._scene_loader = SimpleDataLoader(ChildrenPathDataset(path, seed=seed), seed=seed)
        specs = [load_scene_spec(f) for f in _next_files(env, kw)]
    else:
        preset = resolve_scene_path(path)
        specs = [make_scene(preset, seed=seed + i, **kw.get("scene_gen_kwargs", {}))
                 for i in range(env.num_scene)]
    env._scene_specs = specs
    return _build_scene(env, specs)


def _build_scene(env, specs):
    """Specs → the env's scene: a dense grid with ``backend: "grid"``, else a
    packed primitive scene floored at ``env._pack_floor`` and at the rows of
    the scene it replaces."""
    kw = dict(env.scene_kwargs)
    if kw.get("backend", "primitive") == "grid":
        return bake_scenes(specs, spacing=kw.get("sdf_spacing", 0.1),
                           with_color=kw.get("with_color", True), device=env.device)
    from .prim_scene import pack_scenes

    floor = int(getattr(env, "_pack_floor", 0))
    floors = dict(min_k=floor, min_kb=floor, min_kc=floor)
    old = getattr(env, "scene", None)
    if old is not None and hasattr(old, "params"):
        floors = dict(min_k=max(floor, old.params.shape[1]),
                      min_kb=max(floor, old.boxes.shape[1]),
                      min_kc=max(floor, old.capsules.shape[1]))
    return pack_scenes(specs, device=env.device, **floors)


def swap_scene_for_env(env, scene_id: int):
    """Replace scene ``scene_id`` of the env's scene with the next one of its
    source: the loader's next file for a dataset, a fresh seed for a preset.
    The other scenes keep their packed rows, or their grids and triangles,
    bit for bit. A mesh file's or a pre-baked ``data`` scene is fixed, and
    swapping one of its scenes changes nothing. Sets and returns
    ``env.scene``."""
    kw = dict(env.scene_kwargs)
    path = kw.get("path", "box15_wall_empty")
    if "data" in kw or (isinstance(path, str) and path.lower().endswith(_MESH_EXT)):
        return env.scene
    from .habitat_dataset import is_habitat_scene_path

    if is_habitat_scene_path(path):
        f = env._scene_loader.next(1)[0]
        if kw.get("backend", "primitive") == "grid":
            from .mesh import rebake_scene

            mesh = _habitat_mesh(env, f)
            env._scene_meshes[scene_id] = mesh
            scene = rebake_scene(env.scene, scene_id, mesh, margin=kw.get("margin", 0.5))
            env.scene = scene if scene is not None else _bake_meshes(env, env._scene_meshes)
            return env.scene
        from .habitat_dataset import load_habitat_scene

        hab_kw = {k: kw[k] for k in _HABITAT_KEYS if k in kw}
        spec = load_habitat_scene(f, getattr(env, "_habitat_dataset", None), **hab_kw)
    elif os.path.isdir(path):
        spec = load_scene_spec(env._scene_loader.next(1)[0])
    else:
        env._scene_swap_count = getattr(env, "_scene_swap_count", 0) + 1
        seed = kw.get("seed", env.seed) + env.num_scene * 1000 + env._scene_swap_count
        spec = make_scene(resolve_scene_path(path), seed=seed, **kw.get("scene_gen_kwargs", {}))
    specs = list(env._scene_specs)
    specs[scene_id] = spec
    env._scene_specs = specs
    env.scene = _build_scene(env, specs)
    return env.scene
