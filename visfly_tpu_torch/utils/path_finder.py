"""PRM path planning: a probabilistic roadmap and A* over a k-NN graph
(counterpart of ``visfly_tpu/utils/path_finder.py``).

Host-side planning that samples collision-free vertices with numpy's seeded
generator, connects k nearest neighbours whose segments are clear, and
A*-searches start → goal. Collision tests are one batched call of the
scene's ``point_is_collision`` per query set, on the env's device.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional

import numpy as np
import torch

from .common import to_numpy


class PRMPlanner:
    def __init__(
        self,
        is_collision_fn: Callable[[np.ndarray], np.ndarray],
        bounds_min,
        bounds_max,
        n_samples: int = 400,
        k_neighbors: int = 10,
        segment_checks: int = 8,
        seed: int = 42,
    ):
        self.is_collision = is_collision_fn
        self.lo = np.asarray(bounds_min, np.float32)
        self.hi = np.asarray(bounds_max, np.float32)
        self.n_samples = n_samples
        self.k = k_neighbors
        self.segment_checks = segment_checks
        self.rng = np.random.default_rng(seed)
        self.vertices: Optional[np.ndarray] = None
        self.edges: Optional[List[List[int]]] = None

    def build(self):
        """Sample free vertices and connect clear k-NN edges."""
        pts = self.rng.uniform(self.lo, self.hi, size=(self.n_samples * 2, 3)).astype(
            np.float32
        )
        free = ~np.asarray(self.is_collision(pts))
        verts = pts[free][: self.n_samples]
        d = np.linalg.norm(verts[:, None] - verts[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        nn = np.argsort(d, axis=1)[:, : self.k]

        # batched segment clearance: sample interior points of every edge
        edges: List[List[int]] = [[] for _ in range(len(verts))]
        seg_pts, seg_ids = [], []
        for i in range(len(verts)):
            for j in nn[i]:
                if j <= i:
                    continue
                ts = np.linspace(0, 1, self.segment_checks + 2)[1:-1, None]
                seg_pts.append(verts[i] * (1 - ts) + verts[j] * ts)
                seg_ids.append((i, int(j)))
        if seg_pts:
            flat = np.concatenate(seg_pts).astype(np.float32)
            col = np.asarray(self.is_collision(flat)).reshape(
                len(seg_ids), self.segment_checks
            )
            for (i, j), blocked in zip(seg_ids, col.any(axis=1)):
                if not blocked:
                    edges[i].append(j)
                    edges[j].append(i)
        self.vertices, self.edges = verts, edges
        return self

    def _nearest_free(self, p: np.ndarray) -> int:
        return int(np.argmin(np.linalg.norm(self.vertices - p, axis=-1)))

    def plan(self, start, goal) -> Optional[np.ndarray]:
        """A* start→goal through the roadmap; returns (P, 3) waypoints or
        None when disconnected."""
        if self.vertices is None:
            self.build()
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        s = self._nearest_free(start)
        g = self._nearest_free(goal)
        verts, edges = self.vertices, self.edges

        dist = {s: 0.0}
        prev = {}
        pq = [(np.linalg.norm(verts[s] - verts[g]), s)]
        visited = set()
        while pq:
            _, u = heapq.heappop(pq)
            if u in visited:
                continue
            visited.add(u)
            if u == g:
                break
            for v in edges[u]:
                nd = dist[u] + float(np.linalg.norm(verts[u] - verts[v]))
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(
                        pq, (nd + float(np.linalg.norm(verts[v] - verts[g])), v)
                    )
        if g not in visited:
            return None
        path = [g]
        while path[-1] != s:
            path.append(prev[path[-1]])
        waypoints = verts[np.asarray(path[::-1])]
        return np.concatenate([start[None], waypoints, goal[None]], axis=0)


def find_paths(env, positions, targets, indices=None):
    """Plan a path per agent from its current position to its target
    through the scene (``None`` where the env has no scene or no path was
    found)."""
    if env.scene is None:
        return [None] * env.num_envs
    from ..scene import point_is_collision

    bbox = env.bbox.detach().cpu().numpy()

    def coll(pts):
        p = torch.as_tensor(np.asarray(pts, np.float32), device=env.device)
        return point_is_collision(env.scene, p, radius=env.uav_radius * 3).cpu().numpy()

    planner = PRMPlanner(coll, bbox[0], bbox[1]).build()
    positions = to_numpy(positions)
    targets = to_numpy(targets)
    idx = range(env.num_envs) if indices is None else indices
    return [planner.plan(positions[i], targets[i]) for i in idx]

