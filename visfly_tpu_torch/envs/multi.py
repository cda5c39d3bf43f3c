"""Multi-drone (swarm) environments (counterpart of
``visfly_tpu/envs/multi.py``).

Drones of one scene see each other: each camera sees the other drones as
posed quadrotor templates, a neighbour nearer than the nearest obstacle
takes over the collision point, and success and done aggregate per scene
(all agents / any agent).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from ..core import quaternion as quat
from ..core.math_utils import safe_norm
from ..dynamics import DynState
from ..dynamics import dynamics as dyn_mod
from .base import CollisionInfo, DroneGymEnv, EnvState

# the 4-colour agent cycle of the drone bodies
_DRONE_COLORS = ((200.0, 60.0, 60.0), (60.0, 180.0, 60.0), (70.0, 90.0, 220.0),
                 (230.0, 140.0, 40.0))


class MultiDroneGymEnv(DroneGymEnv):
    """Per-scene aggregation and inter-drone collision awareness."""

    def __init__(self, *args, **kwargs):
        kwargs["multi_drone"] = True
        super().__init__(*args, **kwargs)
        if self.num_agent_per_scene == 1:
            raise ValueError("Num of agents should not be 1 in multi drone env.")
        from ..scene.templates import drone_template

        S, A = self.num_scene, self.num_agent_per_scene
        # built once on the env's device: (K, 9) template, (S, A, 3) colours
        self._drone_template = torch.as_tensor(drone_template(self.uav_radius),
                                               dtype=self.dtype, device=self.device)
        cycle = torch.tensor(_DRONE_COLORS, dtype=self.dtype, device=self.device)
        self._drone_colors = cycle[torch.arange(A, device=self.device) % 4].expand(S, A, 3)

    def _per_scene(self, x: Tensor) -> Tensor:
        return x.reshape(self.num_scene, self.num_agent_per_scene)

    def aggregate_success(self, success: Tensor) -> Tensor:
        """A scene succeeds only when all its agents do."""
        all_s = self._per_scene(success).all(dim=1, keepdim=True)
        return all_s.expand(self.num_scene, self.num_agent_per_scene).reshape(-1)

    def aggregate_done(self, done: Tensor) -> Tensor:
        """A scene ends when any of its agents does."""
        any_d = self._per_scene(done).any(dim=1, keepdim=True)
        return any_d.expand(self.num_scene, self.num_agent_per_scene).reshape(-1)

    def render_objects(self, state: EnvState):
        """The drones as quadrotor templates posed with their attitude, in
        the 4-colour cycle, after the env's dynamic objects; a camera inside
        a drone's bounding sphere (its own body) does not see it."""
        S, A = self.num_scene, self.num_agent_per_scene
        tmpl = self._drone_template
        drone_pos = state.dyn.pos.reshape(S, A, 3)
        drone_rad = torch.full((S, A), self.uav_radius, dtype=drone_pos.dtype,
                               device=drone_pos.device)
        drone_q = state.dyn.q.reshape(S, A, 4)
        drone_mesh = tmpl.expand(S, A, *tmpl.shape)
        parent = super().render_objects(state)
        if parent is None:
            return drone_pos, drone_rad, self._drone_colors, drone_mesh, drone_q
        obj_pos, obj_rad, obj_col = parent[:3]
        m = obj_pos.shape[1]
        K = max(parent[3].shape[2] if len(parent) > 3 else 0, tmpl.shape[0])

        def pad_k(x):
            return torch.nn.functional.pad(x, (0, 0, 0, K - x.shape[2]))

        obj_mesh = (pad_k(parent[3]) if len(parent) > 3
                    else torch.zeros((S, m, K, 9), dtype=tmpl.dtype, device=tmpl.device))
        obj_q = quat.identity((S, m), drone_q.dtype, drone_q.device)
        return (torch.cat([obj_pos, drone_pos], dim=1),
                torch.cat([obj_rad, drone_rad], dim=1),
                torch.cat([obj_col, self._drone_colors], dim=1),
                torch.cat([obj_mesh, pad_k(drone_mesh)], dim=1),
                torch.cat([obj_q, drone_q], dim=1))

    def _update_collision(self, dyn: DynState, once: Tensor, objects=()
                          ) -> Tuple[CollisionInfo, Tensor]:
        """The nearest other drone of the scene takes over the collision
        point where it is nearer than the scene; two drones collide within
        two radii."""
        info, once = super()._update_collision(dyn, once, objects)
        S, A = self.num_scene, self.num_agent_per_scene
        pos = dyn.pos.detach().reshape(S, A, 3)
        d = torch.linalg.vector_norm(pos[:, :, None, :] - pos[:, None, :, :], dim=-1)
        eye = torch.eye(A, dtype=torch.bool, device=pos.device)[None]
        d = torch.where(eye, torch.inf, d)
        nearest = torch.argmin(d, dim=-1)  # (S, A)
        drone_dis = torch.gather(d, -1, nearest[..., None])[..., 0].reshape(-1)
        nearest_pos = torch.gather(pos, 1, nearest[..., None].expand(S, A, 3)).reshape(-1, 3)
        closer = drone_dis < info.dis
        point = torch.where(closer[:, None], nearest_pos, info.point)
        dis = torch.where(closer, drone_dis, info.dis)
        is_col = (dis < self.uav_radius * 2) | info.is_collision
        return (CollisionInfo(point, point - pos.reshape(-1, 3), dis, is_col,
                              info.is_out_bounds), once | is_col)


class MultiNavigationEnv(MultiDroneGymEnv):
    """Swarm navigation: each agent observes its own state, its target and
    the other agents' states of its scene; success is x > 10. With
    ``scene_kwargs["is_find_path"]`` every reset plans a PRM waypoint path per
    agent to its target (``utils/path_finder.py``, on the host), exposed as
    :attr:`path`: guidance for controllers and figures, not part of a step."""

    def __init__(self, *args, target: Optional[Tensor] = None, sensor_kwargs=None,
                 max_episode_steps: int = 256, **kwargs):
        if kwargs.get("visual", True) and not sensor_kwargs:
            sensor_kwargs = [{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}]
        super().__init__(*args, sensor_kwargs=sensor_kwargs,
                         max_episode_steps=max_episode_steps, **kwargs)
        if target is None:
            base = torch.tensor([[13.0, -2.0, 1.5], [13.0, 0.0, 1.5], [13.0, 2.0, 1.5]],
                                dtype=self.dtype, device=self.device)
            A = self.num_agent_per_scene
            per_scene = base.repeat(-(-A // 3), 1)[:A]
            self.target = per_scene.repeat(self.num_scene, 1)
        else:
            self.target = torch.as_tensor(target, dtype=self.dtype, device=self.device)
        self.success_radius = 0.5
        self.is_find_path = bool(dict(kwargs.get("scene_kwargs") or {}).get("is_find_path",
                                                                           False))
        self._paths = [None] * self.num_envs
        A = self.num_agent_per_scene
        self._others = torch.tensor([[j for j in range(A) if j != i] for i in range(A)],
                                    dtype=torch.long, device=self.device).reshape(A, A - 1)

    @property
    def path(self):
        """Per-agent PRM waypoints (P, 3) from the latest reset; ``None``
        where planning is off or no path was found."""
        return self._paths

    def reset(self, gen: Optional[torch.Generator] = None):
        st, obs = super().reset(gen)
        if self.is_find_path:
            from ..utils.path_finder import find_paths

            self._paths = find_paths(self, st.dyn.pos, self.target)
        return st, obs

    def reset_env_by_id(self, state: EnvState, scene_id: int) -> EnvState:
        """The base swap and respawn; with ``is_find_path`` the swapped
        scene's agents are planned anew."""
        st = super().reset_env_by_id(state, scene_id)
        if self.is_find_path:
            from ..utils.path_finder import find_paths

            A = self.num_agent_per_scene
            idx = range(scene_id * A, (scene_id + 1) * A)
            for i, p in zip(idx, find_paths(self, st.dyn.pos, self.target, indices=idx)):
                self._paths[i] = p
        return st

    def get_observation(self, state: EnvState, sensor_obs) -> Dict[str, Tensor]:
        s = self.state_obs(state)
        A = self.num_agent_per_scene
        swarm = s.reshape(self.num_scene, A, -1)[:, self._others, :]  # (S, A, A-1, D)
        obs = {"state": s, "target": self.target,
               "swarm": swarm.reshape(self.num_agent, A - 1, -1)}
        if "depth" in sensor_obs:
            obs["depth"] = sensor_obs["depth"]
        return obs

    def get_success(self, state: EnvState) -> Tensor:
        return state.dyn.pos[:, 0] > 10.0

    def get_reward(self, state: EnvState) -> Tensor:
        """Approach, view-cone and collision shaping with the per-scene
        success bonus."""
        pos = state.dyn.pos
        vel = dyn_mod.velocity(state.dyn)
        direction = dyn_mod.direction(state.dyn)
        to_target = self.target - pos
        dis = safe_norm(to_target, dim=-1)
        vel_norm = safe_norm(vel, dim=-1)
        col_dis = state.collision.dis
        col_vec = state.collision.vector
        thrd_perce = math.pi / 18
        q_ref = state.dyn.q.new_tensor([1.0, 0.0, 0.0, 0.0])

        approach = torch.clamp(torch.sum(vel * to_target, dim=-1) / (1e-6 + dis), max=10.0)
        view_cos = torch.clamp(torch.sum(direction * vel, dim=-1) / (1e-6 + vel_norm), -1.0, 1.0)
        view_pen = torch.clamp(torch.arccos(view_cos), min=thrd_perce) - thrd_perce
        col_closing = torch.clamp(torch.sum(col_vec * vel, dim=-1) / (1e-6 + col_dis), min=0.0)
        return (
            approach * 0.01
            + view_pen * -0.01
            + safe_norm(state.dyn.q - q_ref, dim=-1) * -0.00001
            + vel_norm * -0.002
            + safe_norm(state.dyn.omega, dim=-1) * -0.002
            + 1.0 / (col_dis + 0.2) * -0.01
            + torch.clamp(1.0 - col_dis, min=0.0) * col_closing * -0.005
            + state.success * (self.max_episode_steps - state.step_count) * 0.1
            * (0.5 + 0.5 / (1.0 + vel_norm))
        )
