from .prim_scene import (
    PrimitiveScene,
    pack_scenes,
    prim_distances,
    prim_normal_single,
    prim_sdf,
    scene_sdf_grouped,
)
from .queries import closest_point_query, point_is_collision, sample_sdf, sdf_normal
from .scene import (
    SceneSpec,
    best_candidate_points,
    load_scenes_for_env,
    make_scene,
    resolve_scene_path,
)

__all__ = [
    "PrimitiveScene",
    "pack_scenes",
    "prim_distances",
    "prim_sdf",
    "prim_normal_single",
    "scene_sdf_grouped",
    "SceneSpec",
    "make_scene",
    "best_candidate_points",
    "load_scenes_for_env",
    "resolve_scene_path",
    "sample_sdf",
    "sdf_normal",
    "closest_point_query",
    "point_is_collision",
]
