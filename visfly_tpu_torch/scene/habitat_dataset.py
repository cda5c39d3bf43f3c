"""Habitat-format composite scenes and datasets (counterpart of
``visfly_tpu/scene/habitat_dataset.py``, host-side numpy).

A habitat scene is a stage mesh plus object placements, resolved through a
``*.scene_dataset_config.json``. Every referenced render asset (GLB or OBJ)
is loaded with the port's mesh loader, instanced into world coordinates,
mapped from habitat's y-up frame to the z-up "std" frame (``_H2S``) and
merged into one triangle soup. The default backend decomposes that soup into
boxes and cylinders (``decompose.py``) for the analytic trace kernel; with
``backend: "grid"`` the env bakes it with its exact triangles, per-instance
ids, material colours and textures (``mesh.bake_scenes_from_meshes``) for
the triangle kernel.

Inputs (:func:`is_habitat_scene_path`, :func:`list_habitat_scenes`):

- a ``*.scene_instance.json`` file (one composite scene),
- a directory of scene-instance JSONs (a scene set, rotated through by the
  env's loader),
- a ``*.scene_dataset_config.json`` file (every scene it declares).

Schema: ``stages``/``objects``/``scene_instances`` path globs in the dataset
config; per instance ``translation``, ``rotation`` ([w, x, y, z]),
``uniform_scale``/``non_uniform_scale``; ``render_asset`` (and ``scale``)
in stage and object configs. A template name matches a config by its file
stem (``garage`` ↔ ``.../garage.stage_config.json``).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .scene import SceneSpec

# habitat (y-up, row-vector) → std (z-up) position map: std = hab @ _H2S
_H2S = np.array([[0.0, -1.0, 0.0],
                 [0.0, 0.0, 1.0],
                 [-1.0, 0.0, 0.0]], np.float64)


def _quat_to_mat(q) -> np.ndarray:
    """[w,x,y,z] → 3×3 rotation matrix (acts on column vectors)."""
    w, x, y, z = [float(v) for v in q]
    n = max((w * w + x * x + y * y + z * z) ** 0.5, 1e-12)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _read_json(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)


class HabitatDataset:
    """Index of one ``*.scene_dataset_config.json``: template stem →
    stage/object config path, plus the declared scene-instance files."""

    def __init__(self, config_path: str):
        self.config_path = os.path.abspath(config_path)
        self.root = os.path.dirname(self.config_path)
        cfg = _read_json(self.config_path)
        self.stages = self._index(cfg.get("stages", {}))
        self.objects = self._index(cfg.get("objects", {}))
        self.scenes = sorted(self._glob(cfg.get("scene_instances", {})))

    def _glob(self, section: dict) -> List[str]:
        out: List[str] = []
        for patterns in section.get("paths", {}).values():
            for pat in patterns:
                hits = glob.glob(os.path.join(self.root, pat))
                # habitat treats non-glob path entries as directories too
                for h in hits:
                    if os.path.isdir(h):
                        out.extend(
                            glob.glob(os.path.join(h, "**", "*.json"),
                                      recursive=True))
                    else:
                        out.append(h)
        return out

    @staticmethod
    def _stem(path: str) -> str:
        base = os.path.basename(path)
        # strip habitat's double suffixes: x.stage_config.json → x
        for suf in (".stage_config.json", ".object_config.json",
                    ".scene_instance.json", ".json"):
            if base.endswith(suf):
                return base[: -len(suf)]
        return base

    def _index(self, section: dict) -> Dict[str, str]:
        return {self._stem(p): p for p in self._glob(section)}

    def resolve_template(self, name: str, kind: str) -> str:
        """Template name (possibly a relative path) → config JSON path."""
        table = self.stages if kind == "stage" else self.objects
        stem = self._stem(name)
        if stem in table:
            return table[stem]
        # habitat also accepts direct relative paths
        for cand in (os.path.join(self.root, name),
                     os.path.join(self.root, name + f".{kind}_config.json")):
            if os.path.isfile(cand):
                return cand
        raise FileNotFoundError(
            f"{kind} template {name!r} not found in dataset "
            f"{self.config_path} (known: {sorted(table)[:8]}…)")


def find_dataset_config(start: str) -> Optional[str]:
    """Walk up from ``start`` (at most 8 levels) to the first directory
    holding a ``*.scene_dataset_config.json``; that file, or None."""
    d = os.path.abspath(start if os.path.isdir(start)
                        else os.path.dirname(start))
    for _ in range(8):
        hits = glob.glob(os.path.join(d, "*.scene_dataset_config.json"))
        if hits:
            return sorted(hits)[0]
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None


def _is_habitat_instance_file(path: str) -> bool:
    """True for HABITAT-schema scene instances (stage/object placements);
    the repo's own procedural dataset files reuse the same suffix but carry
    a ``primitives`` list instead (`scene.generate_scene_dataset`)."""
    try:
        doc = _read_json(path)
    except (OSError, ValueError):
        return False
    return isinstance(doc, dict) and "primitives" not in doc and (
        "stage_instance" in doc or "object_instances" in doc)


def is_habitat_scene_path(path: str) -> bool:
    if not isinstance(path, str):
        return False
    if path.endswith(".scene_instance.json"):
        return os.path.isfile(path) and _is_habitat_instance_file(path)
    if path.endswith(".scene_dataset_config.json"):
        return os.path.isfile(path)
    if os.path.isdir(path):
        hits = glob.glob(os.path.join(path, "**", "*.scene_instance.json"),
                         recursive=True)
        return bool(hits) and _is_habitat_instance_file(sorted(hits)[0])
    return False


def list_habitat_scenes(path: str) -> List[str]:
    """All scene-instance files reachable from ``path`` (sorted)."""
    if path.endswith(".scene_instance.json"):
        return [path]
    if path.endswith(".scene_dataset_config.json"):
        return HabitatDataset(path).scenes
    return sorted(glob.glob(
        os.path.join(path, "**", "*.scene_instance.json"), recursive=True))


_MESH_CACHE: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}


def _load_asset(config_path: str, kind: str):
    """Stage/object config JSON → (verts, faces, base_scale, asset_color,
    texinfo) in the asset's habitat-local frame. Raw meshes are cached per
    asset file (objects repeat across instances/scenes). ``texinfo`` is the
    :func:`mesh.load_glb_textured` dict for textured GLBs, else None."""
    cfg = _read_json(config_path)
    asset = cfg.get("render_asset") or cfg.get("collision_asset")
    if asset is None:
        raise ValueError(f"{config_path}: no render_asset")
    mesh_path = os.path.normpath(
        os.path.join(os.path.dirname(config_path), asset))
    if mesh_path not in _MESH_CACHE:
        from .mesh import load_glb_textured, load_mesh, mesh_base_color

        if mesh_path.endswith((".glb", ".gltf")):
            verts, faces, texinfo = load_glb_textured(mesh_path)
        else:
            verts, faces = load_mesh(mesh_path)
            texinfo = None
        _MESH_CACHE[mesh_path] = (verts, faces,
                                  mesh_base_color(mesh_path), texinfo)
    verts, faces, color, texinfo = _MESH_CACHE[mesh_path]
    scale = np.asarray(cfg.get("scale", [1.0, 1.0, 1.0]), np.float64)
    if scale.ndim == 0:
        scale = np.full(3, float(scale))
    return verts, faces, scale, color, texinfo


def _instance_world_verts(dataset: HabitatDataset, inst: dict, kind: str):
    """One stage/object instance → (verts_std, faces, asset_color,
    texinfo) in the z-up frame (asset_color (3,) uint8 or None — material
    base color)."""
    cfg_path = dataset.resolve_template(inst["template_name"], kind)
    verts, faces, base_scale, color, texinfo = _load_asset(cfg_path, kind)
    v = np.asarray(verts, np.float64) * base_scale
    s = inst.get("non_uniform_scale")
    if s is None and "uniform_scale" in inst:
        s = [inst["uniform_scale"]] * 3
    if s is not None:
        v = v * np.asarray(s, np.float64)
    if "rotation" in inst:
        v = v @ _quat_to_mat(inst["rotation"]).T
    if "translation" in inst:
        v = v + np.asarray(inst["translation"], np.float64)
    return (v @ _H2S).astype(np.float32), faces, color, texinfo


def load_habitat_scene_mesh(
    scene_instance_path: str,
    dataset: Optional[HabitatDataset] = None,
    return_instances: bool = False,
    return_textures: bool = False,
):
    """One scene instance → merged std-frame triangle soup:
    (verts, faces, stage_bounds). With ``return_instances`` two more arrays
    are appended: per-face instance ids (0 = stage, 1.. = object placements
    in file order) — the exact-backend bake labels its semantic grid with
    these, reproducing habitat's per-instance semantic sensor — and
    per-instance colors (id-indexed (K, 3) uint8: the asset's material base
    color when it has one, the deterministic palette otherwise)."""
    if dataset is None:
        cfg = find_dataset_config(scene_instance_path)
        if cfg is None:
            raise FileNotFoundError(
                f"no *.scene_dataset_config.json found above "
                f"{scene_instance_path}")
        dataset = HabitatDataset(cfg)

    inst_cfg = _read_json(scene_instance_path)
    all_v: List[np.ndarray] = []
    all_f: List[np.ndarray] = []
    face_ids: List[np.ndarray] = []
    asset_colors: Dict[int, Optional[np.ndarray]] = {}
    stage_bounds = None
    # merged texture registry: per-asset texinfo images are appended once
    # (instances of the same asset share them) and face `tex` ids remapped
    mrg_uv: List[np.ndarray] = []
    mrg_tex: List[np.ndarray] = []
    mrg_images: List[np.ndarray] = []
    image_base: Dict[int, int] = {}  # id(texinfo) → offset into mrg_images
    flat_slot: Dict[bytes, int] = {}

    def add(v, f, iid, color, texinfo=None):
        base = sum(len(x) for x in all_v)
        all_v.append(v)
        all_f.append(np.asarray(f, np.int64) + base)
        face_ids.append(np.full(len(f), iid, np.int32))
        asset_colors[iid] = color
        if not return_textures:
            return
        if texinfo is not None:
            key = id(texinfo)
            if key not in image_base:
                image_base[key] = len(mrg_images)
                mrg_images.extend(texinfo["images"])
            mrg_uv.append(texinfo["uv"])
            mrg_tex.append(texinfo["tex"] + image_base[key])
        else:
            # untextured instance: a shared 1×1 texel of its flat color
            c = (np.asarray(color, np.uint8) if color is not None
                 else np.asarray([180, 180, 180], np.uint8))
            ck = c.tobytes()
            if ck not in flat_slot:
                flat_slot[ck] = len(mrg_images)
                mrg_images.append(c.reshape(1, 1, 3))
            mrg_uv.append(np.full((len(f), 3, 2), 0.5, np.float32))
            mrg_tex.append(np.full(len(f), flat_slot[ck], np.int32))

    stage = inst_cfg.get("stage_instance")
    if stage is not None and stage.get("template_name", "NONE") != "NONE":
        v, f, col, ti = _instance_world_verts(dataset, stage, "stage")
        add(v, f, 0, col, ti)
        stage_bounds = (v.min(axis=0), v.max(axis=0))
    for k, inst in enumerate(inst_cfg.get("object_instances", [])):
        v, f, col, ti = _instance_world_verts(dataset, inst, "object")
        add(v, f, k + 1, col, ti)

    if not all_v:
        raise ValueError(f"{scene_instance_path}: empty scene instance")
    out = (np.concatenate(all_v, axis=0), np.concatenate(all_f, axis=0),
           stage_bounds)
    if return_instances:
        # per-instance colors indexed by instance id: asset material base
        # color where the mesh carries one, the deterministic palette
        # otherwise
        from .mesh import instance_palette

        colors = instance_palette(max(asset_colors) + 1)
        for iid, c in asset_colors.items():
            if c is not None:
                colors[iid] = c
        out = out + (np.concatenate(face_ids, axis=0), colors)
    if return_textures:
        texinfo = {"uv": np.concatenate(mrg_uv),
                   "tex": np.concatenate(mrg_tex),
                   "images": mrg_images}
        out = out + (texinfo,)
    return out


def load_habitat_scene(
    scene_instance_path: str,
    dataset: Optional[HabitatDataset] = None,
    spacing: float = 0.1,
    margin: float = 0.5,
    max_prims: int = 64,
    min_cover: float = 0.98,
    max_cells: int = 384,
) -> SceneSpec:
    """One ``*.scene_instance.json`` → box/cylinder-decomposed
    :class:`SceneSpec`.

    The stage mesh and every object instance are merged into a single
    triangle soup in the std (z-up) frame, baked to an SDF grid and covered
    with primitives (`decompose.sdf_grid_to_boxes`). The env flight volume
    is the stage's bounding box. For EXACT rendering instead, pass
    ``scene_kwargs={"backend": "grid"}`` — the env then bakes the merged
    mesh with the true triangles attached (`mesh.bake_scene_from_arrays`)
    and cameras ray-trace them.

    Each decomposed primitive is labeled with the instance nearest its
    center (semantic id = instance + 1, palette color), so the semantic
    sensor reports per-instance ids in the DEFAULT backend too."""
    verts, faces, stage_bounds, face_inst, inst_colors = \
        load_habitat_scene_mesh(scene_instance_path, dataset,
                                return_instances=True)

    from .decompose import decompose_verts_faces

    name = HabitatDataset._stem(scene_instance_path)
    spec = decompose_verts_faces(
        verts, faces, name=name, spacing=spacing, margin=margin,
        max_prims=max_prims, min_cover=min_cover, max_cells=max_cells)

    ids = np.unique(face_inst)
    if len(ids) > 1:
        # vertex sets per instance (vertex distance ≈ surface distance at
        # the scale of a primitive that hugs the instance)
        vsets = [np.unique(faces[face_inst == iid].reshape(-1))
                 for iid in ids]
        for prm in spec.primitives:
            c = np.asarray(prm["center"], np.float32)
            d = [np.linalg.norm(verts[vs] - c, axis=-1).min()
                 for vs in vsets]
            iid = int(ids[int(np.argmin(d))])
            prm["semantic"] = iid % 255 + 1
            prm["color"] = inst_colors[iid]
    if stage_bounds is not None:
        # flight volume = the stage's extent, not the union with objects
        spec = SceneSpec(
            bounds_min=stage_bounds[0].astype(np.float32),
            bounds_max=stage_bounds[1].astype(np.float32),
            primitives=spec.primitives,
            name=name,
        )
    return spec
