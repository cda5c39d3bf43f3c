"""Dynamic objects: moving obstacles and targets (counterpart of
``visfly_tpu/scene/objects.py``).

Each object follows a circle, a closed polygon or a periodic cubic spline
through random control points, arc-length parameterised. The paths are
tabulated on the host (numpy, the same ``default_rng(seed)`` order as the
JAX package, so one seed gives the same tables in both) into dense
position-over-time tables; a step linearly interpolates the tables on the
device. Collision sees each object as its bounding sphere; cameras see the
sphere or, where the setting names a ``model_path``, a triangle template
(``scene/templates.py``).
"""
from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

TABLE_SAMPLES = 512


class DynamicObjects(NamedTuple):
    """M objects across S scenes, on the env's device."""

    table: Tensor  # (M, T, 3) position over one period (uniform in time)
    period: Tensor  # (M,) seconds per cycle
    radius: Tensor  # (M,) bounding-sphere radius
    scene_of: Tensor  # (M,) int64 owning scene
    mesh: Optional[Tensor] = None  # (M, K, 9) local-frame render triangles (zero rows
    #                                pad; an all-zero object renders as its sphere), or None

    @property
    def num_objects(self) -> int:
        return self.table.shape[0]


class ObjectsState(NamedTuple):
    t: Tensor  # (S,) per-scene clocks
    pos: Tensor  # (M, 3)
    vel: Tensor  # (M, 3)


# ---------------------------------------------------------------------------
# host-side trajectory table construction
# ---------------------------------------------------------------------------


def _circle_table(kwargs: Dict, velocity: float, n: int) -> Tuple[np.ndarray, float]:
    radius = float(kwargs["radius"])
    center = np.asarray(kwargs["center"], np.float32)
    omega = velocity / radius
    period = 2 * np.pi / abs(omega)
    ts = np.linspace(0.0, period, n, endpoint=False)
    pos = np.stack(
        [
            radius * np.cos(omega * ts) + center[0],
            radius * np.sin(omega * ts) + center[1],
            np.full_like(ts, center[2]),
        ],
        axis=-1,
    )
    return pos.astype(np.float32), float(period)


def _polygon_table(kwargs: Dict, velocity: float, n: int) -> Tuple[np.ndarray, float]:
    """Waypoint chase at constant speed, closed."""
    pts = np.asarray(kwargs["points"], np.float32)
    loop = np.concatenate([pts, pts[:1]], axis=0)
    seg = np.diff(loop, axis=0)
    seg_len = np.linalg.norm(seg, axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = cum[-1]
    period = total / velocity
    s = np.linspace(0.0, total, n, endpoint=False)
    idx = np.clip(np.searchsorted(cum, s, side="right") - 1, 0, len(seg) - 1)
    frac = (s - cum[idx]) / np.maximum(seg_len[idx], 1e-9)
    pos = loop[idx] + seg[idx] * frac[:, None]
    return pos.astype(np.float32), float(period)


def _cubic_table(
    kwargs: Dict, velocity: Optional[float], n: int, rng: np.random.Generator
) -> Tuple[np.ndarray, float]:
    """Periodic cubic spline through random control points, arc-length
    parameterised."""
    from scipy.interpolate import CubicSpline

    pts_info = kwargs["points"]
    kw = pts_info.get("kwargs", {})
    pmean = np.asarray(kw.get("position", {}).get("mean", [0, 0, 2]), np.float32)
    phalf = np.asarray(kw.get("position", {}).get("half", [2, 2, 1]), np.float32)
    n_ctrl = int(kw.get("num", kwargs.get("num_points", 6)))
    ctrl = (2 * rng.uniform(size=(n_ctrl, 3)).astype(np.float32) - 1) * phalf + pmean
    vhalf = np.asarray(kw.get("velocity", {}).get("half", [1, 1, 1]), np.float32)
    ctrl_v = np.linalg.norm(
        (2 * rng.uniform(size=(n_ctrl, 3)).astype(np.float32) - 1) * vhalf, axis=-1
    )
    ctrl = np.concatenate([ctrl, ctrl[:1]], axis=0)
    ctrl_v = np.concatenate([ctrl_v, ctrl_v[:1]], axis=0)

    dists = np.linalg.norm(np.diff(ctrl, axis=0), axis=-1)
    cum = np.concatenate([[0.0], np.cumsum(dists)]).astype(np.float32)
    cs = [CubicSpline(cum, ctrl[:, i], bc_type="periodic") for i in range(3)]

    # dense arc-length parameterisation
    p_samples = np.linspace(0, cum[-1], 1000)
    dense = np.stack([c(p_samples) for c in cs], axis=-1)
    arc = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(dense, axis=0), axis=-1))]
    )
    total_arc = arc[-1]

    if velocity:
        period = total_arc / velocity
        s = (np.linspace(0, period, n, endpoint=False) * velocity) % total_arc
    else:
        # speed varies along the path per control-point speeds; integrate
        v_of_param = CubicSpline(cum, np.maximum(ctrl_v, 0.1))
        # time to traverse each dense segment
        seg_v = np.maximum(v_of_param(p_samples[:-1]), 0.1)
        seg_t = np.diff(arc) / seg_v
        t_of_arc = np.concatenate([[0.0], np.cumsum(seg_t)])
        period = t_of_arc[-1]
        t_targets = np.linspace(0, period, n, endpoint=False)
        s = np.interp(t_targets, t_of_arc, arc)

    param_of_arc = np.interp(s, arc, p_samples)
    pos = np.stack([c(param_of_arc) for c in cs], axis=-1)
    return pos.astype(np.float32), float(period)


def build_objects(obj_settings: Sequence[Dict], num_scene: int = 1, seed: int = 42,
                  table_samples: int = TABLE_SAMPLES, device=None) -> DynamicObjects:
    """Tables from object settings (entries of ``name``, ``path`` {``class``,
    ``kwargs``}, ``velocity``, ``num``, ``radius``, ``model_path``). Each
    setting is instantiated in every scene."""
    from .templates import object_template, pad_templates

    rng = np.random.default_rng(seed)
    tables, periods, radii, scene_of, meshes = [], [], [], [], []
    for sid in range(num_scene):
        for setting in obj_settings:
            for _ in range(int(setting.get("num", 1))):
                path = setting["path"]
                vel = setting.get("velocity")
                if isinstance(vel, dict):
                    vel = float(np.mean(vel.get("kwargs", {}).get("mean", 1.0)))
                cls = path["class"]
                if cls == "circle":
                    tab, per = _circle_table(path["kwargs"], float(vel or 1.0), table_samples)
                elif cls == "polygon":
                    tab, per = _polygon_table(path["kwargs"], float(vel or 1.0), table_samples)
                elif cls == "cubic":
                    tab, per = _cubic_table(path["kwargs"], vel, table_samples, rng)
                else:
                    raise ValueError(f"unknown path class {cls!r}")
                tables.append(tab)
                periods.append(per)
                rad = float(setting.get("radius", 0.25))
                radii.append(rad)
                scene_of.append(sid)
                # a ``model_path`` renders as its triangle template, anything
                # else as its bounding sphere
                model = setting.get("model_path") or setting.get("mesh")
                meshes.append(None if model is None else object_template(model, rad))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return DynamicObjects(
        table=t(np.stack(tables)),
        period=t(np.asarray(periods, np.float32)),
        radius=t(np.asarray(radii, np.float32)),
        scene_of=t(np.asarray(scene_of), torch.int64),
        mesh=None if all(m is None for m in meshes) else t(pad_templates(meshes)),
    )


def load_obj_settings(path_or_settings) -> List[Dict]:
    """A JSON file's ``"objects"`` list, or an inline list of settings."""
    if isinstance(path_or_settings, str):
        with open(path_or_settings) as f:
            return json.load(f)["objects"]
    return list(path_or_settings)


# ---------------------------------------------------------------------------
# stepping and queries on the device
# ---------------------------------------------------------------------------


def init_objects_state(objs: DynamicObjects, num_scene: int) -> ObjectsState:
    pos = objs.table[:, 0, :]
    return ObjectsState(t=torch.zeros((num_scene,), dtype=torch.float32, device=pos.device),
                        pos=pos, vel=torch.zeros_like(pos))


def step_objects(objs: DynamicObjects, state: ObjectsState, dt: float) -> ObjectsState:
    """Advance the clocks by ``dt`` and interpolate the tables; the velocity
    is the finite difference over the step."""
    n_t = objs.table.shape[1]
    t = state.t + dt
    t_obj = t[objs.scene_of]  # (M,)
    phase = torch.remainder(t_obj, objs.period) / objs.period * n_t
    i0 = torch.remainder(torch.floor(phase).to(torch.int64), n_t)
    i1 = torch.remainder(i0 + 1, n_t)
    frac = (phase - torch.floor(phase))[:, None]
    m_idx = torch.arange(objs.num_objects, device=t.device)
    pos = objs.table[m_idx, i0] * (1 - frac) + objs.table[m_idx, i1] * frac
    return ObjectsState(t=t, pos=pos, vel=(pos - state.pos) / dt)


def _scene_distances(objs: DynamicObjects, obj_pos: Tensor, sid: Tensor, p: Tensor):
    diff = p[:, None, :] - obj_pos[None, :, :]
    dist_c = torch.linalg.vector_norm(diff, dim=-1)
    d = dist_c - objs.radius[None, :]
    d = torch.where(sid[:, None] == objs.scene_of[None, :], d, torch.inf)
    return diff, dist_c, d


def objects_sdf(objs: DynamicObjects, obj_pos: Tensor, sid: Tensor, p: Tensor) -> Tensor:
    """Distance from points ``p`` (N, 3) in scenes ``sid`` (N,) to the
    nearest object sphere of their scene → (N,)."""
    return torch.amin(_scene_distances(objs, obj_pos, sid, p)[2], dim=-1)


def objects_closest(objs: DynamicObjects, obj_pos: Tensor, sid: Tensor, p: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """(closest object surface point (N, 3), its distance (N,)) per point."""
    diff, dist_c, d = _scene_distances(objs, obj_pos, sid, p)
    j = torch.argmin(d, dim=-1)
    n = torch.arange(p.shape[0], device=p.device)
    dirn = diff[n, j] / torch.clamp(dist_c[n, j], min=1e-9)[:, None]
    point = obj_pos[j] + dirn * objs.radius[j][:, None]
    return point, d[n, j]
