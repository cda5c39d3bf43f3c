"""The plain reference of the ``crossing_swarm`` configuration: the swarm
crossing env's step and its depth camera, worked out again from the
configuration. ``crossing_scene`` and ``drone_template`` are frozen copies
of ``make_scene("garage_crossing")`` (with ``best_candidate_points``,
``_room``, ``_column``) of ``visfly_tpu_torch/scene/scene.py`` and of
``drone_template`` of ``visfly_tpu_torch/scene/templates.py``, and the reward
of ``MultiNavigationEnv.get_reward`` of ``visfly_tpu_torch/envs/multi.py``,
at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117. The scene's first hits
(the room's walls from inside, the columns as capsules) are closed forms.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import geometry as G
from portbench.reference.common import Reference as Base
from portbench.reference.frozen.core import quaternion as quat


def best_candidate_points(rng, n, lo, hi, n_candidates=16):
    pts = []
    for _ in range(n):
        cand = rng.uniform(lo, hi, size=(n_candidates, len(lo)))
        if not pts:
            pts.append(cand[0])
            continue
        d = np.linalg.norm(cand[:, None, :] - np.asarray(pts)[None, :, :], axis=-1).min(axis=1)
        pts.append(cand[int(np.argmax(d))])
    return np.asarray(pts)


def crossing_scene(seed, n_obstacles=10):
    """(room lo, room hi with the open top lifted 50 m, [(a, b, radius)] of
    the columns as capsules, flight bounds lo, hi)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray([-8.0, -8.0, 0.0]), np.asarray([8.0, 8.0, 5.0])
    caps = []
    for x, y in best_candidate_points(rng, n_obstacles, np.asarray([-6.0, -6.0]),
                                      np.asarray([6.0, 6.0])):
        r = float(rng.uniform(0.2, 0.45))
        c = np.asarray([x, y, 2.5], np.float32)
        caps.append(((c + [0, 0, -(2.5 - r)]).astype(np.float32),
                     (c + [0, 0, +(2.5 - r)]).astype(np.float32), np.float32(r)))
    geo_hi = hi.astype(np.float32).copy()
    geo_hi[2] += 50.0
    return lo.astype(np.float32), geo_hi, caps, lo, hi


def _box(center, half):
    cx, cy, cz = center
    hx, hy, hz = half
    v = np.array([[sx * hx + cx, sy * hy + cy, sz * hz + cz]
                  for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _disc(center, radius, n=6):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rim = np.stack([center[0] + radius * np.cos(ang), center[1] + radius * np.sin(ang),
                    np.full(n, center[2])], -1).astype(np.float32)
    v = np.concatenate([np.asarray(center, np.float32)[None], rim])
    f = np.stack([np.zeros(n, np.int32), 1 + np.arange(n, dtype=np.int32),
                  1 + (np.arange(n, dtype=np.int32) + 1) % n], -1)
    return v, f


def drone_template(radius):
    """The quadrotor template: a body, four arms, four rotor discs (84, 9)."""
    r = float(radius)
    arm, rot_r, body_h = 0.72 * r, 0.26 * r, 0.16 * r
    parts = [_box((0.0, 0.0, 0.0), (0.42 * r, 0.30 * r, body_h))]
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        ax, ay = dx * arm * c, dy * arm * s
        parts.append(_box((ax / 2, ay / 2, 0.0), (abs(ax) / 2 + 0.05 * r, 0.06 * r, 0.05 * r)))
        parts.append(_disc((ax, ay, body_h + 0.04 * r), rot_r))
    return np.concatenate([v[f.reshape(-1)].reshape(-1, 9) for v, f in parts]).astype(np.float32)


class Reference(Base):
    image_keys = ("depth",)
    terminal_keys = ("depth",)
    uav_radius = 0.1

    def __init__(self, config, device, dtype=torch.float32):
        super().__init__(config, device, dtype)
        seed = int(self.kw.get("scene_kwargs", {}).get("seed", self.kw.get("seed", 42)))
        self.scenes = []
        for i in range(self.S):
            lo, hi, caps, blo, bhi = crossing_scene(seed + i)
            t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device).to(dtype)
            self.scenes.append((t(lo), t(hi), [(t(a), t(b), t(r)) for a, b, r in caps]))
        self.bbox = (torch.as_tensor(blo, device=self.device).to(dtype),
                     torch.as_tensor(bhi, device=self.device).to(dtype))
        self.template = torch.as_tensor(drone_template(self.uav_radius), device=self.device).to(dtype)
        base = torch.tensor([[13.0, -2.0, 1.5], [13.0, 0.0, 1.5], [13.0, 2.0, 1.5]],
                            dtype=dtype, device=self.device)
        self.target = base.repeat(-(-self.A // 3), 1)[:self.A].repeat(self.S, 1)

    def render(self, pos, q, cams):
        """Depth of the cameras ``cams`` (indices) with the agents at pos, q:
        the scene, then each other drone of the camera's scene as its posed
        template (a drone whose bounding sphere holds the camera is out)."""
        spec = self.sensors[0]
        H, W = spec["resolution"]
        pos, q = self.cast(pos), self.cast(q)
        out = torch.empty((len(cams), 1, H, W), dtype=self.dtype, device=self.device)
        rot = quat.to_rotation_matrix(q)
        for j, c in enumerate(cams.tolist()):
            s = c // self.A
            o, d, cos_f = G.camera_rays(spec, pos[c:c + 1], q[c:c + 1])
            d = d[0]
            o = o.expand_as(d)
            lo, hi, caps = self.scenes[s]
            t = G.room_exit(lo, hi, o, d)
            for a, b, r in caps:
                t = torch.minimum(t, G.capsule_hit(a, b, r, o, d))
            t = torch.clamp(t, 0.0, G.MAX_DEPTH)
            hit = t < G.MAX_DEPTH
            t_obj = torch.full_like(t, G.BIG)
            for m in range(s * self.A, (s + 1) * self.A):
                e = pos[m] - pos[c]
                if float(torch.sum(e * e)) <= self.uav_radius ** 2:
                    continue  # the camera's own body
                v = self.template.reshape(-1, 3, 3) @ rot[m].T + pos[m]
                tm = G.ray_triangles(v.reshape(-1, 9), o, d)
                t_obj = torch.minimum(t_obj, tm)
            obj = (t_obj < G.MAX_DEPTH) & (t_obj < torch.where(hit, t, G.MAX_DEPTH))
            t = torch.where(obj, t_obj, t)
            hit = hit | obj
            out[j, 0] = torch.where(hit, t * cos_f, G.MAX_DEPTH).reshape(H, W)
        return {"depth": out}

    def collision(self, pos):
        """(point, distance, collided, out of bounds) of each agent: the
        nearest of its scene's walls and columns, then the nearest other
        drone of its scene where that is nearer; a collision within one
        radius of the scene or two of a drone."""
        pos = self.cast(pos)
        point = torch.empty_like(pos)
        dis = torch.empty(pos.shape[0], dtype=self.dtype, device=self.device)
        for s, (lo, hi, caps) in enumerate(self.scenes):
            rows = slice(s * self.A, (s + 1) * self.A)
            p = pos[rows]
            bp, bd = G.room_closest(lo, hi, p)
            for a, b, r in caps:
                cp, cd = G.capsule_closest(a, b, r, p)
                better = cd < bd
                bp = torch.where(better[:, None], cp, bp)
                bd = torch.where(better, cd, bd)
            point[rows], dis[rows] = bp, torch.clamp(bd, min=0.0)
        is_col = dis < self.uav_radius
        ps = pos.reshape(self.S, self.A, 3)
        dd = torch.linalg.vector_norm(ps[:, :, None] - ps[:, None], dim=-1)
        dd = dd + torch.eye(self.A, device=self.device, dtype=self.dtype)[None] * G.BIG
        dmin, k = torch.min(dd, dim=-1)
        near = torch.gather(ps, 1, k[..., None].expand(-1, -1, 3)).reshape(-1, 3)
        dmin = dmin.reshape(-1)
        closer = dmin < dis
        point = torch.where(closer[:, None], near, point)
        dis = torch.where(closer, dmin, dis)
        is_col = (dis < 2 * self.uav_radius) | is_col
        lo, hi = self.bbox
        out = ((pos < lo) | (pos > hi)).any(-1)
        return point, dis, is_col, out

    def transition(self, pre, dyn, col):
        """(reward, done) of the step: the swarm's shaping, success when every
        agent of a scene is past x = 10, a scene done when any agent is."""
        point, col_dis, is_col, out = col
        col_vec = point - dyn.pos
        step = pre.step_count.to(self.device) + 1
        success = (dyn.pos[:, 0] > 10.0).reshape(self.S, self.A).all(1, keepdim=True)
        success = success.expand(self.S, self.A).reshape(-1)
        vel = self.velocity(dyn)
        direction = self.direction(dyn)
        to_target = self.target - dyn.pos
        dis = torch.linalg.vector_norm(to_target, dim=-1)
        vel_norm = torch.linalg.vector_norm(vel, dim=-1)
        q_ref = dyn.q.new_tensor([1.0, 0.0, 0.0, 0.0])
        approach = torch.clamp(torch.sum(vel * to_target, -1) / (1e-6 + dis), max=10.0)
        view_cos = torch.clamp(torch.sum(direction * vel, -1) / (1e-6 + vel_norm), -1.0, 1.0)
        thrd = math.pi / 18
        view_pen = torch.clamp(torch.arccos(view_cos), min=thrd) - thrd
        closing = torch.clamp(torch.sum(col_vec * vel, -1) / (1e-6 + col_dis), min=0.0)
        reward = (approach * 0.01 + view_pen * -0.01
                  + torch.linalg.vector_norm(dyn.q - q_ref, dim=-1) * -0.00001
                  + vel_norm * -0.002 + torch.linalg.vector_norm(dyn.omega, dim=-1) * -0.002
                  + 1.0 / (col_dis + 0.2) * -0.01
                  + torch.clamp(1.0 - col_dis, min=0.0) * closing * -0.005
                  + success * (self.max_steps - step) * 0.1 * (0.5 + 0.5 / (1.0 + vel_norm)))
        ep_done = pre.episode_done.to(self.device) | success | out | is_col
        done = ep_done | (step >= self.max_steps)
        done = done.reshape(self.S, self.A).any(1, keepdim=True).expand(self.S, self.A).reshape(-1)
        return reward, done

    def work(self, pos, q):
        """(operations, bytes) one render of every camera needs (``bounds``)."""
        from portbench import bounds as B

        spec = self.sensors[0]
        H, W = spec["resolution"]
        pos, q = pos.to(self.device, torch.float32), q.to(self.device, torch.float32)
        ops = 0.0
        for s, (lo, hi, caps) in enumerate(self.scenes):
            rows = slice(s * self.A, (s + 1) * self.A)
            o, d, _ = G.camera_rays(spec, pos[rows], q[rows])  # (A, HW, 3)
            tiles = d.reshape(-1, B.TILE, 3)
            o_t = o.repeat_interleave(H * W // B.TILE, 0)
            corners = torch.stack([torch.stack([torch.minimum(a, b) - r, torch.maximum(a, b) + r])
                                   for a, b, r in caps]).float()  # (K, 2, 3)
            idx = torch.tensor([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                               device=self.device)
            pts = torch.stack([corners[:, idx[:, 0], 0], corners[:, idx[:, 1], 1],
                               corners[:, idx[:, 2], 2]], -1)  # (K, 8, 3)
            n_caps = B.visible(pts, o_t, tiles, W, G.MAX_DEPTH).sum(1).double()  # (tiles,)
            ops += float((B.TILE * (B.OPS["box_ray"] + n_caps * B.OPS["cap_ray"])
                          + B.OPS["box_origin"] + n_caps * B.OPS["cap_origin"]).sum())
            for c in range(self.A):
                for m in range(self.A):
                    if m == c:
                        continue
                    near = B.sphere_rays(o[c], d[c], pos[rows][m], self.uav_radius)
                    ops += H * W * B.OPS["sphere_ray"]
                    ops += float(near.sum()) * self.template.shape[0] * B.OPS["tri_mt"]
        n_cams = pos.shape[0]
        rows_bytes = self.S * (13 * 4 + len(self.scenes[0][2]) * 9 * 4)
        nbytes = n_cams * (28 + H * W * 4) + rows_bytes + n_cams * self.template.shape[0] * 36
        return ops, float(nbytes)
