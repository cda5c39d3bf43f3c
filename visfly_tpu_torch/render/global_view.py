"""Global evaluation view: the scene from a free camera with drone markers,
trajectories and debug overlays (counterpart of
``visfly_tpu/render/global_view.py``).

Camera modes fix / follow / object × views top / near / side / back /
custom, driven by the ``render_settings`` dict the experiment configs use.
The scene image is one colour camera of :func:`render_camera` at the
requested resolution (default 480×640, 307,200 rays): on the card the
analytic trace kernel with the winning row's id (B1-kid), with the per-tile
cull where the ray count is whole 1,024-ray tiles (without frustum planes
unless the width divides 1,024), else without the cull. A multi-scene env
renders its scene 0. Markers and polylines are rasterised on the host in
numpy: this path renders a handful of frames for humans, not observations.

``mode="object"`` tracks the first dynamic object. (The JAX package's test
for it, ``isinstance(state.objects, tuple)``, holds for its ``ObjectsState``
NamedTuple too, so there it always falls back to ``"follow"``; here it
tracks.)
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import quaternion as quat
from ..scene.prim_scene import PrimitiveScene
from ..scene.scene import SceneData
from .sphere_trace import render_camera

_AGENT_COLORS = np.asarray(
    [
        [255, 70, 70], [70, 160, 255], [90, 220, 90], [250, 200, 60],
        [200, 110, 250], [80, 230, 230], [250, 140, 60], [180, 180, 180],
    ],
    np.uint8,
)


def _look_at_quat(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Quaternion rotating body-x onto (target-eye) with z-up roll."""
    f = target - eye
    f = f / (np.linalg.norm(f) + 1e-9)
    up = np.asarray([0.0, 0.0, 1.0])
    if abs(f @ up) > 0.99:
        up = np.asarray([0.0, 1.0, 0.0])
    right = np.cross(f, up)
    right = right / (np.linalg.norm(right) + 1e-9)
    u = np.cross(right, f)
    # columns of R map body axes to world: body-x→f, body-y→−right, body-z→u
    rot = np.stack([f, -right, u], axis=1)
    w = math.sqrt(max(1.0 + rot[0, 0] + rot[1, 1] + rot[2, 2], 1e-9)) / 2
    x = (rot[2, 1] - rot[1, 2]) / (4 * w)
    y = (rot[0, 2] - rot[2, 0]) / (4 * w)
    z = (rot[1, 0] - rot[0, 1]) / (4 * w)
    q = np.asarray([w, x, y, z])
    return q / np.linalg.norm(q)


def _camera_pose(view: str, scene_bbox: np.ndarray, focus: np.ndarray,
                 position=None) -> Tuple[np.ndarray, np.ndarray]:
    lo, hi = scene_bbox
    center = (lo + hi) / 2
    margin = 0.3

    def clamp_inside(p):
        # cameras must stay inside the hollow room (outside = wall solid)
        return np.clip(p, lo + margin, hi - margin)

    if position is not None:
        position = np.asarray(position, np.float32)
        if position.ndim == 2:  # [eye, lookat] (reference custom view)
            return clamp_inside(position[0]), position[1]
        return clamp_inside(position), focus
    if view == "top":
        # open-topped rooms: place the camera high enough to frame the scene
        height = max(float(np.max(hi[:2] - lo[:2])) * 0.6, hi[2] + 1.0)
        eye = np.asarray([center[0], center[1] + 1e-3, lo[2] + height])
        return eye, np.asarray([center[0], center[1], lo[2]])
    if view == "near":
        return clamp_inside(focus + np.asarray([-2.0, -2.0, 1.5])), focus
    if view == "side":
        eye = np.asarray([center[0], lo[1] + margin, hi[2] * 0.7])
        return eye, center
    if view == "back":
        return clamp_inside(focus + np.asarray([-3.0, 0.0, 1.5])), focus
    eye = np.asarray([center[0], center[1] + 1e-3, hi[2] - margin])
    return eye, np.asarray([center[0], center[1], lo[2]])


def _project(points: np.ndarray, eye: np.ndarray, q: np.ndarray,
             hfov: float, hw: Tuple[int, int]) -> np.ndarray:
    """World points → pixel (row, col, in_front) using the pinhole model of
    render/camera.py."""
    H, W = hw
    w_, x_, y_, z_ = q
    rot = np.asarray([
        [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - z_ * w_), 2 * (x_ * z_ + y_ * w_)],
        [2 * (x_ * y_ + z_ * w_), 1 - 2 * (x_ * x_ + z_ * z_), 2 * (y_ * z_ - x_ * w_)],
        [2 * (x_ * z_ - y_ * w_), 2 * (y_ * z_ + x_ * w_), 1 - 2 * (x_ * x_ + y_ * y_)],
    ])
    f, r, u = rot[:, 0], -rot[:, 1], rot[:, 2]
    d = points - eye
    xf = d @ f
    tan_h = math.tan(math.radians(hfov) / 2)
    tan_v = tan_h * H / W
    uu = (d @ r) / np.maximum(xf, 1e-6) / tan_h
    vv = (d @ u) / np.maximum(xf, 1e-6) / tan_v
    col = (uu + 1) / 2 * (W - 1)
    row = (1 - vv) / 2 * (H - 1)
    return np.stack([row, col, xf > 0.05], axis=-1)


def _draw_disk(img: np.ndarray, row: float, col: float, radius: int,
               color: np.ndarray):
    H, W = img.shape[:2]
    r0, r1 = int(max(row - radius, 0)), int(min(row + radius + 1, H))
    c0, c1 = int(max(col - radius, 0)), int(min(col + radius + 1, W))
    if r0 >= r1 or c0 >= c1:
        return
    yy, xx = np.mgrid[r0:r1, c0:c1]
    mask = (yy - row) ** 2 + (xx - col) ** 2 <= radius**2
    img[r0:r1, c0:c1][mask] = color


def _draw_polyline(img: np.ndarray, pts: np.ndarray, color: np.ndarray,
                   width: int = 1):
    for a, b in zip(pts[:-1], pts[1:]):
        if not (a[2] and b[2]):
            continue
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1])) * 1.5) + 1
        rows = np.linspace(a[0], b[0], n)
        cols = np.linspace(a[1], b[1], n)
        for rr, cc in zip(rows, cols):
            _draw_disk(img, rr, cc, max(width // 2, 1), color)



def scene_zero(data):
    """The first scene of a (possibly multi-scene) primitive or mesh scene:
    every per-scene field cut to its first row."""
    if isinstance(data, PrimitiveScene):
        return data._replace(params=data.params[:1], colors=data.colors[:1],
                             semantic=data.semantic[:1], boxes=data.boxes[:1],
                             capsules=data.capsules[:1])
    if isinstance(data, SceneData):
        return data._replace(**{f: getattr(data, f)[:1] for f in
                                ("sdf", "albedo", "semantic", "triangles", "tri_uv", "tri_rect",
                                 "atlas") if isinstance(getattr(data, f), torch.Tensor)})
    raise TypeError(f"cannot render a {type(data).__name__}")


def render_global(
    env,
    state,
    mode: str = "fix",
    view: str = "top",
    resolution: Sequence[int] = (480, 640),
    position=None,
    trajectory: bool = False,
    traj_history: Optional[np.ndarray] = None,  # (T, N, 3)
    velocity: bool = False,
    collision: bool = False,
    approaching: bool = False,
    axes: bool = False,
    line_width: float = 2.0,
    hfov: float = 90.0,
    n_steps: int = 48,
    **_ignored,
) -> np.ndarray:
    """One (H, W, 3) uint8 frame. ``mode='follow'`` tracks the agents'
    centroid; ``'object'`` the first dynamic object (``'follow'`` without
    objects); ``'fix'`` uses the static view or ``position``. Overlays:
    ``velocity`` the last-10-segment motion trail, ``collision`` a line from
    each agent to its closest obstacle point, ``approaching`` a line to the
    scene hit along each agent's velocity (``env.approaching_point``),
    green fading to white over 10 m, ``axes`` each agent's body frame."""
    H, W = int(resolution[0]), int(resolution[1])
    pos = state.dyn.pos.detach().cpu().numpy()
    focus = pos.mean(axis=0)
    if mode == "object":
        objs = getattr(state, "objects", ())
        if isinstance(objs, tuple) and hasattr(objs, "_fields"):
            focus = objs.pos[0].detach().cpu().numpy()
        else:
            mode = "follow"  # no dynamic objects
    bbox = env.bbox.detach().cpu().numpy()
    eye, lookat = _camera_pose(view, bbox, focus, position)
    if mode in ("follow", "object"):
        lookat = focus
        if position is None and view in ("top", "side"):
            # tracking modes keep the configured offset but re-aim
            eye = np.asarray(focus) + (np.asarray(eye) - np.asarray(lookat)
                                       if view != "top" else np.asarray([0.0, 1e-3, 6.0]))
    q = _look_at_quat(np.asarray(eye, np.float64), np.asarray(lookat, np.float64))

    spec = {"sensor_type": "color", "resolution": [H, W], "hfov": hfov, "tile": 1}
    dev = env.device
    frame = render_camera(
        scene_zero(env.scene),
        torch.as_tensor(np.asarray(eye, np.float32), device=dev)[None],
        torch.as_tensor(np.asarray(q, np.float32), device=dev)[None],
        spec, n_steps=n_steps, num_scene=1,
    )["color"]
    img = np.ascontiguousarray(frame[0].permute(1, 2, 0).cpu().numpy())

    # trajectory polylines
    if trajectory and traj_history is not None:
        for i in range(traj_history.shape[1]):
            px = _project(np.asarray(traj_history[:, i]), eye, q, hfov, (H, W))
            _draw_polyline(img, px, _AGENT_COLORS[i % len(_AGENT_COLORS)], int(line_width))

    # velocity trail: only the last 10 trajectory segments, drawn brighter
    if velocity and traj_history is not None:
        tail = np.asarray(traj_history[-11:])
        for i in range(tail.shape[1]):
            px = _project(tail[:, i], eye, q, hfov, (H, W))
            c = np.minimum(_AGENT_COLORS[i % len(_AGENT_COLORS)] * 1.5, 255).astype(np.uint8)
            _draw_polyline(img, px, c, int(line_width) + 1)

    # collision lines: agent → closest obstacle point, in a warning colour
    if collision and getattr(state, "collision", None) is not None:
        cpts = state.collision.point.detach().cpu().numpy()
        for i in range(pos.shape[0]):
            seg = _project(np.stack([pos[i], cpts[i]]), eye, q, hfov, (H, W))
            _draw_polyline(img, seg, np.asarray([255, 40, 40], np.uint8), int(line_width))

    # approaching lines: agent → the scene hit along its velocity
    if approaching:
        apts = env.approaching_point(state).detach().cpu().numpy()
        for i in range(pos.shape[0]):
            d = min(float(np.linalg.norm(apts[i] - pos[i])) / 10.0, 1.0)
            c = ((1 - d) * np.asarray([60, 250, 60])
                 + d * np.asarray([250, 250, 250])).astype(np.uint8)
            seg = _project(np.stack([pos[i], apts[i]]), eye, q, hfov, (H, W))
            _draw_polyline(img, seg, c, int(line_width))

    # body axes: x red, y green, z blue
    if axes:
        R = quat.to_rotation_matrix(state.dyn.q).detach().cpu().numpy()  # (N, 3, 3)
        for i in range(pos.shape[0]):
            for ax, c in ((0, [255, 60, 60]), (1, [60, 255, 60]), (2, [80, 80, 255])):
                tip = pos[i] + R[i, :, ax] * (1.0 if ax == 0 else 0.5)
                seg = _project(np.stack([pos[i], tip]), eye, q, hfov, (H, W))
                _draw_polyline(img, seg, np.asarray(c, np.uint8), max(int(line_width) - 1, 1))

    # drone markers
    px = _project(pos, eye, q, hfov, (H, W))
    for i, (row, col, front) in enumerate(px):
        if front:
            _draw_disk(img, row, col, max(int(line_width) + 2, 3),
                       _AGENT_COLORS[i % len(_AGENT_COLORS)])
    return img
