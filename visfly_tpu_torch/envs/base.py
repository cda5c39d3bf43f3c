"""Vectorised drone environment core (counterpart of
``visfly_tpu/envs/base.py``).

    state', out = env.step(state, action)

All ``num_scene × num_agent_per_scene`` agents advance together. Auto-reset
happens inside ``step`` by masked selects: the returned observations are
post-reset, while reward/done/info describe the pre-reset transition (SB3
VecEnv semantics). Randomness comes from the ``torch.Generator`` carried in
``EnvState.gen``; ``reset`` takes it (or seeds one from ``seed`` on the
env's device).

Subclasses implement ``get_observation`` / ``get_reward`` / ``get_success``
/ ``get_failure``, and keep env-specific state in ``EnvState.aux`` through
the hooks ``init_aux`` / ``reset_aux`` / ``step_aux`` /
``update_aux_from_sensors``. Not ported yet, and raising
``NotImplementedError``: dynamic objects (``obj_settings``), IMU and sensor
noise, world-model latents, ``terminal_obs_in_info``, wind functions and
velocity sub-sampled collision checks.

Gradients: with ``requires_grad=True`` a step is differentiable from the
action and the carried state to ``obs`` and ``reward`` (through the dynamics,
the reward and, on visual envs, the renderer's implicit-function rule);
without it ``obs`` and ``reward`` leave ``step`` detached. The collision query
sees a detached position unless ``grad_collision=True``, which keeps the
closest point differentiable in position. Spawned and reset states carry no
gradient, a done agent's gradient stops at its reset, ``info`` is always
detached, and :meth:`DroneGymEnv.detach` cuts the carried state loose between
updates. Autograd keeps every kernel's outputs and never replays a forward, so
there is no rematerialisation policy to choose.

The env runs on ``device``, by default the CUDA card; pass ``device="cpu"``
to run on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ..dynamics import DroneConfig, DynState, make_drone_params
from ..dynamics import dynamics as dyn_mod
from ..render.camera import camera_geometry
from . import randomization as rnd


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


def _detach(x):
    """Detach every tensor of a (nested) NamedTuple, tuple or dict."""
    if isinstance(x, Tensor):
        return x.detach()
    if isinstance(x, tuple):
        parts = [_detach(v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    return x


class CollisionInfo(NamedTuple):
    """Per-agent closest-obstacle info."""

    point: Tensor  # (N, 3) closest point on obstacle/world boundary
    vector: Tensor  # (N, 3) point - position
    dis: Tensor  # (N,)
    is_collision: Tensor  # (N,) bool — dis < uav_radius
    is_out_bounds: Tensor  # (N,) bool


class EnvState(NamedTuple):
    """Environment state for N agents."""

    dyn: DynState
    gen: torch.Generator  # all in-env randomness
    step_count: Tensor  # (N,) int32
    episode_done: Tensor  # (N,) bool — terminal (not timeout)
    success: Tensor  # (N,) bool (this step)
    failure: Tensor  # (N,) bool
    collision: CollisionInfo
    once_collided: Tensor  # (N,) bool since episode start
    returns: Tensor  # (N,) accumulated episode reward
    aux: Any = ()  # env-specific NamedTuple of tensors (pad centre, ...)


class StepOutput(NamedTuple):
    obs: Dict[str, Tensor]
    reward: Tensor  # (N,)
    done: Tensor  # (N,) bool — terminal OR truncated (SB3 convention)
    info: Dict[str, Tensor]


class DroneGymEnv:
    """Base env. Construction is host-side; ``reset`` and ``step`` work on
    tensors on ``device``."""

    # include the pre-reset observation in step info (set by PPO and SAC)
    terminal_obs_in_info: bool = False
    # set by envs whose reward depends on sensor images (LandingEnv): forces a
    # render before the reward each step, beside the one after the auto-reset
    needs_sensors_for_reward: bool = False

    def __init__(
        self,
        num_agent_per_scene: int = 1,
        num_scene: int = 1,
        seed: int = 42,
        visual: bool = False,
        max_episode_steps: int = 256,
        requires_grad: bool = False,
        random_kwargs: Optional[dict] = None,
        dynamics_kwargs: Optional[dict] = None,
        scene_kwargs: Optional[dict] = None,
        sensor_kwargs: Optional[Sequence[dict]] = None,
        device: Any = "cuda",
        tensor_output: bool = True,
        is_collision_reset: bool = True,
        is_train: bool = False,
        uav_radius: float = 0.1,
        sensitive_radius: float = 10.0,
        col_refine_steps: int = 0,
        grad_collision: bool = False,
        multi_drone: bool = False,
        latent_dim: Optional[int] = None,
        dtype=torch.float32,
    ):
        if col_refine_steps:
            raise _unported("col_refine_steps > 0",
                            "Queue A item 8, velocity sub-sampled collisions")
        if latent_dim is not None:
            raise _unported("world-model latents", "Queue A item 14, world_model.py")
        self.device = torch.device(device)
        self.num_agent_per_scene = int(num_agent_per_scene)
        self.num_scene = int(num_scene)
        self.num_agent = self.num_envs = self.num_agent_per_scene * self.num_scene
        self.seed = seed
        self.visual = visual
        self.max_episode_steps = int(max_episode_steps)
        self.requires_grad = bool(requires_grad)
        self.grad_collision = bool(grad_collision)
        self.is_collision_reset = is_collision_reset
        self.uav_radius = float(uav_radius)
        # attributes only, as in the JAX package: nothing reads them yet
        self.tensor_output = tensor_output
        self.is_train = is_train
        self.sensitive_radius = float(sensitive_radius)
        self.is_multi_drone = multi_drone
        self.dtype = dtype
        self.max_sense_radius = 10.0
        self.scene_ids = torch.arange(self.num_scene, device=self.device).repeat_interleave(
            self.num_agent_per_scene)

        dynamics_kwargs = dict(dynamics_kwargs or {})
        self.wind_const = dynamics_kwargs.pop("wind_settings", None)
        if "wind_fn" in dynamics_kwargs or (
                self.wind_const is not None and isinstance(self.wind_const[0], str)):
            raise _unported("wind functions", "Queue A item 2, wind functions")
        dynamics_kwargs.pop("seed", None)
        dynamics_kwargs.pop("device", None)
        self.dyn_config = DroneConfig(**dynamics_kwargs)
        self.params = make_drone_params(self.dyn_config, dtype=dtype, device=self.device)

        random_kwargs = random_kwargs or self.default_random_kwargs()
        if random_kwargs.get("noise_kwargs"):
            raise _unported("IMU and sensor noise", "Queue A items 8 and 12, render/noise.py")
        self.randomizers = rnd.from_reference_kwargs(random_kwargs, device=self.device)

        self.scene = None
        self.scene_kwargs = dict(scene_kwargs or {})
        if self.scene_kwargs.get("obj_settings"):
            raise _unported("dynamic objects (obj_settings)", "Queue A item 16, dynamic objects")
        self.sensor_kwargs = [dict(s) for s in (sensor_kwargs or [])]
        self.cameras = [camera_geometry(s, self.device) for s in self.sensor_kwargs]
        # non-visual envs fly in the hard-coded empty-box world
        self.bbox = torch.tensor([[-30.0, -30.0, 0.0], [30.0, 30.0, 8.0]], dtype=dtype,
                                 device=self.device)
        if visual:
            from ..scene import load_scenes_for_env

            self.scene = load_scenes_for_env(self)
            self.bbox = self.scene.bbox

        self.state_size = 13 if self.dyn_config.is_quat_output else 12
        self.action_size = 4

    # -- hooks for subclasses ------------------------------------------------

    def default_random_kwargs(self) -> dict:
        return {}

    def get_observation(self, state: EnvState, sensor_obs: Dict[str, Tensor]
                        ) -> Dict[str, Tensor]:
        return {"state": self.state_obs(state)}

    def get_success(self, state: EnvState) -> Tensor:
        return torch.zeros((self.num_agent,), dtype=torch.bool, device=self.device)

    def get_failure(self, state: EnvState) -> Tensor:
        return torch.zeros((self.num_agent,), dtype=torch.bool, device=self.device)

    def get_reward(self, state: EnvState) -> Tensor:
        return torch.zeros((self.num_agent,), dtype=self.dtype, device=self.device)

    def init_aux(self) -> Any:
        """Env-specific aux state of a fresh env."""
        return ()

    def reset_aux(self, state: EnvState, mask: Tensor) -> Any:
        """Aux state with the masked agents reset; ``state.dyn`` is already
        the respawned dynamics."""
        return state.aux

    def step_aux(self, aux: Any, dyn: DynState) -> Any:
        """Advance the aux state by one control step."""
        return aux

    def update_aux_from_sensors(self, state: EnvState, sensor_obs: Dict[str, Tensor]
                                ) -> EnvState:
        """Refresh aux state that is derived from rendered sensors."""
        return state

    # -- helpers ---------------------------------------------------------------

    def sensor_observations(self, state: EnvState) -> Dict[str, Tensor]:
        """Render per-agent sensors on the env's device."""
        if not self.visual or not self.sensor_kwargs:
            return {}
        from ..render import render_sensors

        return render_sensors(self, state)

    def state_obs(self, state: EnvState) -> Tensor:
        """IMU state, 13-dim (12 with euler output)."""
        return dyn_mod.get_state(state.dyn, self.dyn_config)

    def is_collision_fn(self, pos: Tensor) -> Tensor:
        """Spawn rejection: closer than 1 m to a surface (the analytic SDF of
        a primitive scene, the baked grid of a mesh scene) or out of bounds."""
        from ..scene import point_is_collision

        if pos.shape[0] == self.num_agent:
            sid = self.scene_ids
        else:
            sid = torch.zeros((pos.shape[0],), dtype=torch.long, device=self.device)
        return point_is_collision(self.scene, pos, sid=sid, radius=1.0)

    def _spawn(self, gen: torch.Generator) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Spawn states for ALL agents (one block per randomizer spec)."""
        n_per = self.num_agent // max(len(self.randomizers), 1)
        target = getattr(self, "target", None)
        outs = [
            rnd.safe_sample(spec, gen, n_per,
                            is_collision_fn=self.is_collision_fn if self.visual else None,
                            target_pos=None if target is None else target[0])
            for spec in self.randomizers
        ]
        return tuple(torch.cat(parts, dim=0).to(self.dtype) for parts in zip(*outs))

    def _update_collision(self, dyn: DynState, once: Tensor) -> Tuple[CollisionInfo, Tensor]:
        """Closest-point and bounds queries: the scene for visual envs (its
        SDF, or the exact triangles of a mesh scene), the nearest face of the
        bbox world otherwise."""
        pos = dyn.pos if self.grad_collision else dyn.pos.detach()
        if self.scene is not None:
            from ..scene import closest_point_query

            point, dis, out = closest_point_query(self.scene, self.scene_ids, pos)
        else:
            lo, hi = self.bbox[0], self.bbox[1]
            d = torch.cat([pos - lo, hi - pos], dim=-1)  # (N, 6)
            idx = torch.argmin(d, dim=-1)  # nearest face
            on_axis = torch.arange(3, device=pos.device) == (idx % 3)[:, None]
            point = torch.where(on_axis, self.bbox.reshape(-1)[idx][:, None], pos)
            dis = torch.linalg.vector_norm(point - pos, dim=-1)
            out = torch.any(pos < lo, dim=-1) | torch.any(pos > hi, dim=-1)
        is_col = dis < self.uav_radius
        return CollisionInfo(point, point - pos, dis, is_col, out), once | is_col

    # -- API -------------------------------------------------------------------

    def reset(self, gen: Optional[torch.Generator] = None
              ) -> Tuple[EnvState, Dict[str, Tensor]]:
        """Fresh episode for all agents. ``gen`` defaults to a generator on
        the env's device seeded with ``seed``."""
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
        pos, q, vel, omega = self._spawn(gen)
        dyn = dyn_mod.init_state(self.dyn_config, self.params, self.num_agent, self.dtype)
        dyn = dyn_mod.reset(self.dyn_config, self.params, dyn, pos=pos, ori=q, vel=vel,
                            ori_vel=omega)
        n = self.num_agent
        falses = torch.zeros((n,), dtype=torch.bool, device=self.device)
        collision, _once = self._update_collision(dyn, falses)
        st = EnvState(
            dyn=dyn, gen=gen,
            step_count=torch.zeros((n,), dtype=torch.int32, device=self.device),
            episode_done=falses, success=falses, failure=falses,
            collision=collision, once_collided=falses,
            returns=torch.zeros((n,), dtype=self.dtype, device=self.device),
            aux=self.init_aux(),
        )
        st = st._replace(aux=self.reset_aux(st, torch.ones_like(falses)))
        sensor_obs = self.sensor_observations(st)
        st = self.update_aux_from_sensors(st, sensor_obs)
        return st, self.get_observation(st, sensor_obs)

    def step(self, state: EnvState, action: Tensor, is_test: bool = False
             ) -> Tuple[EnvState, StepOutput]:
        """One control step for all agents. ``is_test=True`` suppresses the
        auto-reset."""
        if self.terminal_obs_in_info:
            raise _unported("terminal_obs_in_info", "Queue A item 8, terminal_obs_in_info")
        dyn = dyn_mod.step(self.dyn_config, self.params, state.dyn, action,
                           wind_const=self.wind_const)
        aux = self.step_aux(state.aux, dyn)
        collision, once = self._update_collision(dyn, state.once_collided)
        step_count = state.step_count + 1
        st = state._replace(dyn=dyn, step_count=step_count, collision=collision,
                            once_collided=once, aux=aux)
        if self.needs_sensors_for_reward:
            st = self.update_aux_from_sensors(st, self.sensor_observations(st))

        success = self.get_success(st)
        failure = self.get_failure(st)
        st = st._replace(success=success, failure=failure)

        reward = self.get_reward(st)
        returns = state.returns + reward

        episode_done = state.episode_done | success | failure | collision.is_out_bounds
        if self.is_collision_reset:
            episode_done = episode_done | collision.is_collision
        truncated = step_count >= self.max_episode_steps
        done = episode_done | truncated

        info = {
            "episode_done": episode_done,
            "is_success": success,
            "TimeLimit.truncated": truncated & ~episode_done,
            "episode_return": returns.detach(),
            "episode_length": step_count,
            "episode_time": step_count.to(self.dtype) * self.dyn_config.ctrl_dt,
            "collision": once,
        }
        st = st._replace(returns=returns, episode_done=episode_done)
        if not is_test:
            st = self._auto_reset(st, done)
        sensor_obs = self.sensor_observations(st)
        st = self.update_aux_from_sensors(st, sensor_obs)
        obs = self.get_observation(st, sensor_obs)
        if not self.requires_grad:
            obs = {k: v.detach() for k, v in obs.items()}
            reward = reward.detach()
        return st, StepOutput(obs=obs, reward=reward, done=done, info=info)

    def detach(self, state: EnvState) -> EnvState:
        """The same state with no gradient history: what a trainer carries
        from one update to the next."""
        return _detach(state)

    def _auto_reset(self, st: EnvState, done: Tensor) -> EnvState:
        """Masked respawn of done agents, with a random clock phase. The
        spawned states carry no gradient; the selects let a live agent's
        gradient through and stop a done agent's."""
        pos, q, vel, omega = (x.detach() for x in self._spawn(st.gen))
        dyn = dyn_mod.reset(self.dyn_config, self.params, st.dyn, mask=done, pos=pos, ori=q,
                            vel=vel, ori_vel=omega, generator=st.gen)
        collision, once = self._update_collision(dyn, st.once_collided & ~done)
        return st._replace(
            dyn=dyn,
            aux=self.reset_aux(st._replace(dyn=dyn), done),
            step_count=torch.where(done, 0, st.step_count).to(st.step_count.dtype),
            episode_done=st.episode_done & ~done,
            returns=torch.where(done, torch.zeros_like(st.returns), st.returns),
            collision=collision,
            once_collided=once,
        )

    def __repr__(self):
        return (f"{type(self).__name__}(num_scene={self.num_scene}, "
                f"num_agent_per_scene={self.num_agent_per_scene}, visual={self.visual}, "
                f"device={self.device})")
