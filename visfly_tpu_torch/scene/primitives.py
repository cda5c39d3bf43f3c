"""Analytic signed-distance primitives on numpy arrays (counterpart of
``visfly_tpu/scene/primitives.py``, host side only).

ENU world frame (z-up), distances in metres, negative inside. All functions
broadcast over the leading dims of ``p`` (..., 3).
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


def sd_sphere(p, center, radius):
    return np.linalg.norm(p - np.asarray(center), axis=-1) - radius


def sd_box(p, center, half_extents):
    """Axis-aligned box."""
    q = np.abs(p - np.asarray(center)) - np.asarray(half_extents)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(np.max(q, axis=-1), 0.0)
    return outside + inside


def sd_cylinder(p, center, radius, half_height):
    """Vertical (z-axis) capped cylinder: the 'column' obstacle."""
    d = p - np.asarray(center)
    r = np.linalg.norm(d[..., :2], axis=-1) - radius
    h = np.abs(d[..., 2]) - half_height
    outside = np.linalg.norm(np.stack([np.maximum(r, 0.0), np.maximum(h, 0.0)], axis=-1),
                             axis=-1)
    inside = np.minimum(np.maximum(r, h), 0.0)
    return outside + inside


def sd_capsule(p, a, b, radius):
    a = np.asarray(a)
    b = np.asarray(b)
    pa = p - a
    ba = b - a
    h = np.clip(np.sum(pa * ba, axis=-1) / np.sum(ba * ba, axis=-1), 0.0, 1.0)
    return np.linalg.norm(pa - ba * h[..., None], axis=-1) - radius


def sd_room(p, bounds_min, bounds_max):
    """Hollow axis-aligned room: free space is inside, so the interior box
    SDF is negated."""
    lo = np.asarray(bounds_min)
    hi = np.asarray(bounds_max)
    return -sd_box(p, (lo + hi) * 0.5, (hi - lo) * 0.5)


def sd_gate(p, center, yaw, inner_half, thickness):
    """Square racing gate: a frame around an opening of half-width
    ``inner_half``, facing along its local x axis."""
    d = p - np.asarray(center)
    c, s = np.cos(-yaw), np.sin(-yaw)
    x = d[..., 0] * c - d[..., 1] * s
    y = d[..., 0] * s + d[..., 1] * c
    z = d[..., 2]
    outer = inner_half + thickness
    qy = np.abs(y)
    qz = np.abs(z)
    box_outer = np.stack([np.abs(x) - thickness, qy - outer, qz - outer], axis=-1)
    d_outer = (np.linalg.norm(np.maximum(box_outer, 0.0), axis=-1)
               + np.minimum(np.max(box_outer, axis=-1), 0.0))
    d_inner_2d = np.minimum(inner_half - qy, inner_half - qz)  # >0 inside hole
    return np.maximum(d_outer, d_inner_2d)


PRIM_EVAL = {
    "sphere": lambda p, s: sd_sphere(p, s["center"], s["radius"]),
    "box": lambda p, s: sd_box(p, s["center"], s["half_extents"]),
    "cylinder": lambda p, s: sd_cylinder(p, s["center"], s["radius"], s["half_height"]),
    "capsule": lambda p, s: sd_capsule(p, s["a"], s["b"], s["radius"]),
    "room": lambda p, s: sd_room(p, s["bounds_min"], s["bounds_max"]),
    "gate": lambda p, s: sd_gate(p, s["center"], s.get("yaw", 0.0), s["inner_half"],
                                 s["thickness"]),
}


def eval_primitive(p, spec: Dict[str, Any]):
    return PRIM_EVAL[spec["type"]](p, spec)


def eval_scene_sdf(p, primitives: Sequence[Dict[str, Any]]):
    """min-composition over all primitives."""
    d = None
    for spec in primitives:
        di = eval_primitive(p, spec)
        d = di if d is None else np.minimum(d, di)
    return d
