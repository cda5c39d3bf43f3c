"""Carry the JAX package's state into this package's objects.

Each function takes the JAX objects after ``np.asarray`` on every leaf
(``jax.tree_util.tree_map(np.asarray, x)``), i.e. the same NamedTuples
holding numpy arrays, so both packages can compute from identical
parameters, scenes and states. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .core.types import Bound
from .dynamics.config import DroneParams
from .dynamics.dynamics import DynState
from .envs.base import CollisionInfo, EnvState
from .envs.landing import LandingAux
from .render.sphere_trace import Lighting
from .render.trace_kernel import KernelScene
from .scene.prim_scene import PrimitiveScene, scene_from_arrays
from .scene.scene import SceneData, scene_data_from_arrays

# env-specific aux states the port knows, by their field names
_AUX_TYPES = {LandingAux._fields: LandingAux}


def _t(x, device, dtype=None) -> torch.Tensor:
    """A tensor holding a copy of ``x`` (JAX hands out read-only buffers);
    the dtype is kept unless given."""
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def drone_params_from_numpy(p, device=None) -> DroneParams:
    """``visfly_tpu.dynamics.DroneParams`` of numpy arrays → DroneParams."""
    fields = {f: _t(getattr(p, f), device) for f in DroneParams._fields
              if f != "thrust_bound"}
    bound = Bound(min=_t(p.thrust_bound.min, device), max=_t(p.thrust_bound.max, device))
    return DroneParams(thrust_bound=bound, **fields)


def dyn_state_from_numpy(s, device=None) -> DynState:
    """``visfly_tpu.dynamics.DynState`` of numpy arrays → DynState."""
    if not isinstance(getattr(s, "linear_drag", ()), tuple):
        raise NotImplementedError("per-agent drag (drag_random > 0) is not ported yet "
                                  "(ROADMAP: drag randomisation)")
    return DynState(**{f: _t(getattr(s, f), device) for f in DynState._fields})


def scene_from_numpy(scene, device=None) -> PrimitiveScene:
    """``visfly_tpu.scene.PrimitiveScene`` of numpy arrays → PrimitiveScene."""
    arrays = {f: getattr(scene, f) for f in
              ("params", "colors", "semantic", "bbox", "boxes", "capsules")}
    return scene_from_arrays(arrays, float(scene.eps), device)


def scene_data_from_numpy(data, device=None) -> SceneData:
    """``visfly_tpu.scene.SceneData`` of numpy arrays (sdf, albedo, semantic,
    origin, spacing, bbox, triangles) → SceneData. Texture tables do not
    cross over."""
    if not isinstance(getattr(data, "tri_uv", ()), tuple):
        raise NotImplementedError("textured scenes are not ported yet (ROADMAP: Queue A item "
                                  "18, imported meshes: textures)")
    fields = ("sdf", "albedo", "semantic", "origin", "spacing", "bbox", "triangles")
    return scene_data_from_arrays({f: getattr(data, f) for f in fields}, device)


def kernel_scene_from_numpy(kscene, device=None) -> KernelScene:
    """``visfly_tpu.render.pallas_trace.KernelScene`` of numpy arrays →
    KernelScene."""
    return KernelScene(_t(kscene.boxes, device), _t(kscene.capsules, device))


def lighting_from_numpy(lighting, device=None) -> Optional[Lighting]:
    """The tuple ``visfly_tpu.render.sphere_trace.bake_lighting`` returns
    (numpy leaves, the ``shadows`` bool last), or None → Lighting or None."""
    if lighting is None:
        return None
    return Lighting(*(_t(x, device, torch.float32) for x in lighting[:5]),
                    shadows=bool(lighting[5]))


def aux_from_numpy(aux, device=None):
    """An env's ``EnvState.aux`` NamedTuple of numpy arrays → the port's
    NamedTuple of the same fields; ``()`` stays ``()``."""
    if isinstance(aux, tuple) and not hasattr(aux, "_fields"):
        if len(aux):
            raise NotImplementedError("only NamedTuple aux states cross over")
        return ()
    if aux._fields not in _AUX_TYPES:
        raise NotImplementedError(f"EnvState.aux of type {type(aux).__name__} is not ported "
                                  "yet (ROADMAP: Queue A item 15, the rest of the env zoo)")
    return _AUX_TYPES[aux._fields](*(_t(x, device) for x in aux))


def env_state_from_numpy(st, gen: Optional[torch.Generator] = None,
                         device=None) -> EnvState:
    """``visfly_tpu.envs.EnvState`` of numpy arrays → EnvState. The JAX PRNG
    key has no counterpart; ``gen`` (default: a generator on ``device``
    seeded with 0) takes its place. ``aux`` crosses over for the envs the
    port has (``LandingAux``)."""
    for name, item in (("objects", "Queue A item 16, dynamic objects"),
                       ("latent", "Queue A item 14, world_model.py")):
        if not isinstance(getattr(st, name, ()), tuple):
            raise NotImplementedError(f"EnvState.{name} is not ported yet (ROADMAP: {item})")
    if gen is None:
        gen = torch.Generator(device=device or "cpu").manual_seed(0)
    c = st.collision
    return EnvState(
        dyn=dyn_state_from_numpy(st.dyn, device),
        gen=gen,
        step_count=_t(st.step_count, device, torch.int32),
        episode_done=_t(st.episode_done, device, torch.bool),
        success=_t(st.success, device, torch.bool),
        failure=_t(st.failure, device, torch.bool),
        collision=CollisionInfo(
            point=_t(c.point, device),
            vector=_t(c.vector, device),
            dis=_t(c.dis, device),
            is_collision=_t(c.is_collision, device, torch.bool),
            is_out_bounds=_t(c.is_out_bounds, device, torch.bool),
        ),
        once_collided=_t(st.once_collided, device, torch.bool),
        returns=_t(st.returns, device),
        aux=aux_from_numpy(getattr(st, "aux", ()), device),
    )
