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
``update_aux_from_sensors``; ``aggregate_success``, ``aggregate_done`` and
``render_objects`` are the hooks a multi-drone env overrides.

World-model latents: ``latent_dim=n`` (or ``initialize_latent(deter, stoch,
world)``) adds ``deter`` and ``stoch`` observations, zeros at a reset, carried
in ``EnvState.latent``. With a world model attached
(``policies/world_model.py``) each step zeroes the latents of the agents that
are done and then takes the posterior update from the step's action and
observation, its noise drawn from ``EnvState.gen``; without one they stay
zero. The terminal observation carries the latents from before the step.

Dynamic objects (``scene_kwargs["obj_settings"]``: a JSON file's path, a
dict with ``"path"``, or an inline list of settings; ``scene/objects.py``)
live in ``EnvState.objects``: they start at their tables' first row at a
reset, advance by ``ctrl_dt`` a step, override the collision point where
nearer, and appear in the cameras (``render_objects``). Wind:
``dynamics_kwargs["wind_settings"]`` is a constant (3,) velocity, or three
(or six, two fields summed) expressions in ``x`` = the clock and ``y`` = the
previous wind component; ``dynamics_kwargs["wind_fn"]`` takes a callable
``(t (N,), wind (N, 3)) → (N, 3)``. Sensor noise
(``random_kwargs["noise_kwargs"][uuid]``) is drawn from ``EnvState.gen``
after each render.

Scenes: ``env.scene`` is the one scene in effect, and a rotation or a swap
replaces it in place (the JAX package carries it in ``EnvState.scene`` so
that swapped arrays reach its compiled programs as operands; eager PyTorch
has no compiled program to feed). ``reset_scenes`` loads the next scenes of
the source (the next seeds of a preset, the loader's next files of a
dataset) and respawns every agent; ``reset_env_by_id`` replaces one scene
and respawns only its agents. ``approaching_point`` traces each agent's
velocity ray through the scene (``trace_rays``).

``terminal_obs_in_info`` (set by PPO and SAC) adds the pre-reset observation,
detached, to ``info["terminal_observation"]``; on a visual env it costs a
second render a step, before the auto-reset. IMU noise
(``random_kwargs["noise_kwargs"]["IMU"]``) is drawn from ``EnvState.gen``
at every state observation. A reward returned as a dict (``{"reward": total,
term: value, ...}``) logs each term as ``info["extra_<term>"]``, differentiable
where the reward is.

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
from ..utils import profiling
from . import randomization as rnd


def _wind_fn_from_strings(settings):
    """A wind function from expression strings in (x = the clock t (N,),
    y = the previous wind component (N,)): three for one field, six for two
    fields summed. The expressions see ``jnp``, ``np`` and ``th`` (all torch),
    ``math``, ``sin``, ``cos``, ``exp`` and ``pi``, and no builtins."""
    import math

    ns = {"jnp": torch, "np": torch, "th": torch, "math": math, "sin": torch.sin,
          "cos": torch.cos, "exp": torch.exp, "pi": math.pi, "__builtins__": {}}
    fields = [[eval("lambda x,y: " + s, dict(ns)) for s in settings[:3]]]
    if len(settings) == 6:
        fields.append([eval("lambda x,y: " + s, dict(ns)) for s in settings[3:6]])

    def wind_fn(t: Tensor, prev: Tensor) -> Tensor:
        w = 0
        for fns in fields:
            w = w + torch.stack([
                torch.as_tensor(f(t, prev[:, i]), dtype=prev.dtype,
                                device=prev.device).expand(t.shape)
                for i, f in enumerate(fns)], dim=-1)
        return w

    return wind_fn


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
    objects: Any = ()  # ObjectsState of the dynamic objects, when the env has any
    latent: Any = ()  # (deter (N, D), stoch (N, S)) world-model latents, when enabled


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
        self.col_refine_steps = int(col_refine_steps)
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
        wind_settings = dynamics_kwargs.pop("wind_settings", None)
        self.wind_fn = dynamics_kwargs.pop("wind_fn", None)
        self.wind_const = None
        if wind_settings is not None:
            if isinstance(wind_settings[0], str):
                self.wind_fn = _wind_fn_from_strings(wind_settings)
            else:
                self.wind_const = wind_settings
        dynamics_kwargs.pop("seed", None)
        dynamics_kwargs.pop("device", None)
        self.dyn_config = DroneConfig(**dynamics_kwargs)
        self.params = make_drone_params(self.dyn_config, dtype=dtype, device=self.device)

        self.noise_settings = dict((random_kwargs or {}).get("noise_kwargs") or {})
        self.randomizers = rnd.from_reference_kwargs(
            random_kwargs or self.default_random_kwargs(), device=self.device)
        self._imu_noise = self._build_imu_noise()

        self.scene = None
        self.scene_kwargs = dict(scene_kwargs or {})
        self.sensor_kwargs = [dict(s) for s in (sensor_kwargs or [])]
        self.cameras = [camera_geometry(s, self.device) for s in self.sensor_kwargs]
        # non-visual envs fly in the hard-coded empty-box world
        self.bbox = torch.tensor([[-30.0, -30.0, 0.0], [30.0, 30.0, 8.0]], dtype=dtype,
                                 device=self.device)
        if visual:
            from ..scene import load_scenes_for_env

            self.scene = load_scenes_for_env(self)
            self.bbox = self.scene.bbox

        self.objects = None
        obj_settings = self.scene_kwargs.get("obj_settings")
        if obj_settings:
            from ..scene.objects import build_objects, load_obj_settings

            if isinstance(obj_settings, dict) and "path" in obj_settings:
                obj_settings = obj_settings["path"]
            self.objects = build_objects(load_obj_settings(obj_settings), self.num_scene, seed,
                                         device=self.device)
            m = self.objects.num_objects // self.num_scene
            from ..scene.mesh import instance_palette

            self._object_colors = torch.as_tensor(
                instance_palette(m + 1)[1:], dtype=torch.float32,
                device=self.device).expand(self.num_scene, m, 3)

        self.state_size = 13 if self.dyn_config.is_quat_output else 12
        self.action_size = 4

        # rows (start, stop, n) of an env of n agents that this env holds
        # (all of its own unless ``parallel.make_rank_env`` set a block of a
        # larger one): spawns, reset clocks, drag, IMU, sensor and world-model
        # noise are drawn for all n agents and sliced
        self.global_rows: Tuple[int, int, int] = (0, self.num_agent, self.num_agent)

        self.world = None
        self.deter_dim = self.stoch_dim = 0
        if latent_dim is not None:
            self.initialize_latent(latent_dim, latent_dim)

    def initialize_latent(self, deter_dim: int, stoch_dim: int, world=None):
        """Add ``deter`` / ``stoch`` latent observations, driven by the world
        model ``world`` (``policies/world_model.py``) when one is given."""
        self.deter_dim = int(deter_dim)
        self.stoch_dim = int(stoch_dim)
        if world is not None:
            self.world = world

    def _init_latent(self):
        if not self.deter_dim:
            return ()
        n = self.num_agent
        return (torch.zeros((n, self.deter_dim), dtype=self.dtype, device=self.device),
                torch.zeros((n, self.stoch_dim), dtype=self.dtype, device=self.device))

    def _update_latent(self, latent, action: Tensor, obs: Dict[str, Tensor], done: Tensor,
                       gen: torch.Generator):
        """The latents of done agents zeroed, then the world model's posterior
        step with noise from ``gen``; zeros pass through without a model."""
        deter, stoch = (torch.where(done[:, None], torch.zeros_like(x), x) for x in latent)
        if self.world is None:
            return deter, stoch
        # the prior's noise, then the posterior's, as the model draws them:
        # the whole batch's draws, sliced where the env is a block of a larger one
        dim, dtype = self.world.sequence.stoch_dim, next(self.world.parameters()).dtype
        noise = tuple(self._rows_draw(torch.randn, gen, (dim,), dtype) for _ in range(2))
        with torch.set_grad_enabled(self.requires_grad and torch.is_grad_enabled()):
            stoch, deter = self.world.step(action, stoch, deter, obs, noise=noise)
        return deter.to(self.dtype), stoch.to(self.dtype)

    def _attach_latent_obs(self, obs: Dict[str, Tensor], latent) -> Dict[str, Tensor]:
        if self.deter_dim and latent != ():
            obs = dict(obs)
            obs["deter"], obs["stoch"] = latent
        return obs

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

    def render_objects(self, state: EnvState):
        """The dynamic geometry the cameras see beside the scene: (positions
        (S, M, 3), radii (S, M), colours (S, M, 3)[, templates (S, M, K, 9),
        None]), or None. Objects whose setting names a ``model_path`` render
        as their template, the rest as their bounding sphere."""
        if self.objects is None or type(state.objects) is tuple:
            return None
        S = self.num_scene
        m = self.objects.num_objects // S
        out = (state.objects.pos.reshape(S, m, 3), self.objects.radius.reshape(S, m),
               self._object_colors)
        if self.objects.mesh is not None:
            out = out + (self.objects.mesh.reshape(S, m, *self.objects.mesh.shape[1:]), None)
        return out

    def _build_imu_noise(self):
        """The IMU noise model → None (no noise) or (kind, mean, half or std):
        ``UniformNoiseModel`` (the default model) adds ``(U[0,1) − 0.5) ·
        half + mean``, any other model ``N(0,1) · std + mean``."""
        imu = self.noise_settings.get("IMU")
        if imu is None:
            return None
        kw = imu.get("kwargs", {})

        def t(key):
            return torch.as_tensor(kw.get(key, 0.0), dtype=self.dtype, device=self.device)

        if imu.get("model", "UniformNoiseModel") == "UniformNoiseModel":
            return ("uniform", t("mean"), t("half"))
        return ("normal", t("mean"), t("std"))

    def state_obs(self, state: EnvState) -> Tensor:
        """IMU state, 13-dim (12 with euler output), with the IMU noise drawn
        from ``state.gen`` and the quaternion re-normalised after it."""
        s = dyn_mod.get_state(state.dyn, self.dyn_config)
        if self._imu_noise is not None:
            kind, a, b = self._imu_noise
            draw = torch.rand if kind == "uniform" else torch.randn
            noise = self._rows_draw(draw, state.gen, s.shape[1:], s.dtype)
            if kind == "uniform":
                noise = noise - 0.5
            s = s + (noise * b + a)
            if self.dyn_config.is_quat_output:
                q = s[:, 3:7]
                q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
                s = torch.cat([s[:, :3], q, s[:, 7:]], dim=-1)
        return s

    def is_collision_fn(self, pos: Tensor) -> Tensor:
        """Spawn rejection: closer than 1 m to a surface (the analytic SDF of
        a primitive scene, the baked grid of a mesh scene) or out of bounds.
        ``pos (..., n, 3) -> (..., n)``: where the agent axis holds this env's
        agents, each point is tested in its agent's scene (the scene ids
        broadcast over the leading axes), else in scene 0."""
        from ..scene import point_is_collision

        sid = self.scene_ids if pos.shape[-2] == self.num_agent else None
        return point_is_collision(self.scene, pos, sid=sid, radius=1.0)

    def _rows_draw(self, draw, gen: torch.Generator, tail, dtype) -> Tensor:
        """``draw((N, *tail))`` from ``gen`` for this env's agents: where the
        env holds rows of a larger one (``global_rows``), the draw is the
        larger env's, sliced."""
        lo, hi, n = self.global_rows
        return draw((n, *tail), generator=gen, dtype=dtype, device=self.device)[lo:hi]

    def _spawn(self, gen: torch.Generator) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """Spawn states for ALL agents (one block per randomizer spec). Where
        the env holds rows of a larger one, the larger env's draws are made and
        sliced, and only this env's rows are tested for collisions."""
        lo, hi, n = self.global_rows
        if profiling.tracing():
            profiling.count("spawn.agents", n)
        n_per = n // max(len(self.randomizers), 1)
        target = getattr(self, "target", None)
        outs = [
            rnd.safe_sample(spec, gen, n_per,
                            is_collision_fn=self._spawn_collision(j, n_per) if self.visual
                            else None,
                            target_pos=None if target is None else target[0])
            for j, spec in enumerate(self.randomizers)
        ]
        return tuple(torch.cat(parts, dim=0)[lo:hi].to(self.dtype) for parts in zip(*outs))

    def _spawn_collision(self, block: int, n_per: int):
        """The spawn rejection of randomizer block ``block`` (rows
        ``block · n_per`` on) of the larger env's agents, ``pos (..., n_per,
        3) -> (..., n_per)``: ``is_collision_fn`` on the rows this env holds;
        the rest pass."""
        lo, hi, n = self.global_rows
        a, b = max(lo, block * n_per), min(hi, (block + 1) * n_per)

        def fn(pos: Tensor) -> Tensor:
            bad = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
            if a < b:
                rows = slice(a - block * n_per, b - block * n_per)
                if n_per == n:  # one block: the rows are this env's agents, in their scenes
                    bad[..., rows] = self.is_collision_fn(pos[..., rows, :])
                else:  # as is_collision_fn tests a block of several: all in scene 0
                    from ..scene import point_is_collision

                    bad[..., rows] = point_is_collision(self.scene, pos[..., rows, :], radius=1.0)
            return bad

        return fn

    def _update_collision(self, dyn: DynState, once: Tensor, objects: Any = ()
                          ) -> Tuple[CollisionInfo, Tensor]:
        """Closest-point and bounds queries: the scene for visual envs (its
        SDF, or the exact triangles of a mesh scene), the nearest face of the
        bbox world otherwise; a dynamic object's sphere (``objects``, an
        ``ObjectsState``) takes over the closest point where it is nearer."""
        pos = dyn.pos if self.grad_collision else dyn.pos.detach()
        if self.scene is not None:
            from ..scene import closest_point_query

            point, dis, out = closest_point_query(self.scene, self.scene_ids, pos)
            if self.col_refine_steps > 0:
                # point, distance and collision come from the query above; the
                # positions along the velocity over one control interval, at
                # fractions 1/k .. (k-1)/k, feed only the out-of-bounds test
                k = self.col_refine_steps
                frac = torch.linspace(0.0, 1.0, k + 1, dtype=pos.dtype, device=pos.device)[1:-1]
                samples = (pos.detach()[:, None, :] + dyn.vel.detach()[:, None, :]
                           * frac[None, :, None] * self.dyn_config.ctrl_dt)
                lo, hi = self.scene.bbox[0], self.scene.bbox[1]
                out = out | torch.any((samples < lo) | (samples > hi), dim=-1).any(dim=-1)
        else:
            lo, hi = self.bbox[0], self.bbox[1]
            d = torch.cat([pos - lo, hi - pos], dim=-1)  # (N, 6)
            idx = torch.argmin(d, dim=-1)  # nearest face
            on_axis = torch.arange(3, device=pos.device) == (idx % 3)[:, None]
            point = torch.where(on_axis, self.bbox.reshape(-1)[idx][:, None], pos)
            dis = torch.linalg.vector_norm(point - pos, dim=-1)
            out = torch.any(pos < lo, dim=-1) | torch.any(pos > hi, dim=-1)
        if self.objects is not None and type(objects) is not tuple:
            from ..scene.objects import objects_closest

            o_point, o_dis = objects_closest(self.objects, objects.pos.detach(), self.scene_ids,
                                             pos)
            closer = o_dis < dis
            point = torch.where(closer[:, None], o_point, point)
            dis = torch.where(closer, o_dis, dis)
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
        objects = ()
        if self.objects is not None:
            from ..scene.objects import init_objects_state

            objects = init_objects_state(self.objects, self.num_scene)
        collision, _once = self._update_collision(dyn, falses, objects)
        st = EnvState(
            dyn=dyn, gen=gen,
            step_count=torch.zeros((n,), dtype=torch.int32, device=self.device),
            episode_done=falses, success=falses, failure=falses,
            collision=collision, once_collided=falses,
            returns=torch.zeros((n,), dtype=self.dtype, device=self.device),
            aux=self.init_aux(), objects=objects, latent=self._init_latent(),
        )
        st = st._replace(aux=self.reset_aux(st, torch.ones_like(falses)))
        sensor_obs = self.sensor_observations(st)
        st = self.update_aux_from_sensors(st, sensor_obs)
        return st, self._attach_latent_obs(self.get_observation(st, sensor_obs), st.latent)

    def step(self, state: EnvState, action: Tensor, is_test: bool = False
             ) -> Tuple[EnvState, StepOutput]:
        """One control step for all agents. ``is_test=True`` suppresses the
        auto-reset."""
        with profiling.span("env.dynamics"):
            dyn = dyn_mod.step(self.dyn_config, self.params, state.dyn, action,
                               wind_fn=self.wind_fn, wind_const=self.wind_const)
        aux = self.step_aux(state.aux, dyn)
        objects = state.objects
        if self.objects is not None and type(objects) is not tuple:
            from ..scene.objects import step_objects

            objects = step_objects(self.objects, objects, self.dyn_config.ctrl_dt)
        with profiling.span("env.collision"):
            collision, once = self._update_collision(dyn, state.once_collided, objects)
        step_count = state.step_count + 1
        st = state._replace(dyn=dyn, step_count=step_count, collision=collision,
                            once_collided=once, aux=aux, objects=objects)
        pre_sensor_obs = None
        if self.needs_sensors_for_reward or self.terminal_obs_in_info:
            pre_sensor_obs = self.sensor_observations(st)
        if self.needs_sensors_for_reward:
            st = self.update_aux_from_sensors(st, pre_sensor_obs)

        with profiling.span("env.reward"):
            success = self.aggregate_success(self.get_success(st))
            failure = self.get_failure(st)
            st = st._replace(success=success, failure=failure)
            reward = self.get_reward(st)
        indiv = {}
        if isinstance(reward, dict):
            indiv = {k: v for k, v in reward.items() if k != "reward"}
            reward = reward["reward"]
        returns = state.returns + reward

        episode_done = state.episode_done | success | failure | collision.is_out_bounds
        if self.is_collision_reset:
            episode_done = episode_done | collision.is_collision
        truncated = step_count >= self.max_episode_steps
        done = self.aggregate_done(episode_done | truncated)

        info = {
            "episode_done": episode_done,
            "is_success": success,
            "TimeLimit.truncated": truncated & ~episode_done,
            "episode_return": returns.detach(),
            "episode_length": step_count,
            "episode_time": step_count.to(self.dtype) * self.dyn_config.ctrl_dt,
            "collision": once,
            **{f"extra_{k}": v if self.requires_grad else v.detach() for k, v in indiv.items()},
        }
        st = st._replace(returns=returns, episode_done=episode_done)
        if self.terminal_obs_in_info:
            # what the agent saw at the end of the transition, before the
            # auto-reset respawns it (SB3's ``terminal_observation``)
            term_obs = self._attach_latent_obs(self.get_observation(st, pre_sensor_obs),
                                               st.latent)
            info["terminal_observation"] = {k: v.detach() for k, v in term_obs.items()}
        if not is_test:
            with profiling.span("env.auto_reset"):
                st = self._auto_reset(st, done)
        sensor_obs = self.sensor_observations(st)
        st = self.update_aux_from_sensors(st, sensor_obs)
        obs = self.get_observation(st, sensor_obs)
        if self.deter_dim and st.latent != ():
            st = st._replace(latent=self._update_latent(st.latent, action, obs, done, st.gen))
            obs = self._attach_latent_obs(obs, st.latent)
        if not self.requires_grad:
            obs = {k: v.detach() for k, v in obs.items()}
            reward = reward.detach()
        return st, StepOutput(obs=obs, reward=reward, done=done, info=info)

    def aggregate_success(self, success: Tensor) -> Tensor:
        """Per agent by default; a multi-drone env aggregates per scene."""
        return success

    def aggregate_done(self, done: Tensor) -> Tensor:
        return done

    def detach(self, state: EnvState) -> EnvState:
        """The same state with no gradient history: what a trainer carries
        from one update to the next."""
        return _detach(state)

    def _auto_reset(self, st: EnvState, done: Tensor) -> EnvState:
        """Masked respawn of done agents, with a random clock phase. The
        spawned states carry no gradient; the selects let a live agent's
        gradient through and stop a done agent's."""
        if profiling.tracing():
            profiling.count("reset.respawned", done.sum())
        with profiling.span("env.spawn"):
            pos, q, vel, omega = (x.detach() for x in self._spawn(st.gen))
        clock = self._rows_draw(torch.rand, st.gen, (), st.dyn.pos.dtype) * 3.14 * 2
        dyn = dyn_mod.reset(self.dyn_config, self.params, st.dyn, mask=done, pos=pos, ori=q,
                            vel=vel, ori_vel=omega, t=clock, generator=st.gen,
                            rows=self.global_rows)
        return self._reset_masked(st, done, dyn)

    def _reset_masked(self, st: EnvState, mask: Tensor, dyn: DynState) -> EnvState:
        """The bookkeeping of a masked reset to the dynamics ``dyn``."""
        with profiling.span("env.collision"):
            collision, once = self._update_collision(dyn, st.once_collided & ~mask, st.objects)
        return st._replace(
            dyn=dyn,
            aux=self.reset_aux(st._replace(dyn=dyn), mask),
            step_count=torch.where(mask, 0, st.step_count).to(st.step_count.dtype),
            episode_done=st.episode_done & ~mask,
            returns=torch.where(mask, torch.zeros_like(st.returns), st.returns),
            collision=collision,
            once_collided=once,
        )

    def reset_agents(self, state: EnvState, mask: Tensor) -> EnvState:
        """Explicit masked reset: the auto-reset of the agents in ``mask``."""
        return self._auto_reset(state, mask)

    def reset_agents_from_state(self, state: EnvState, mask: Tensor, full_state: Tensor,
                                pos_reset_by_state: bool = True) -> EnvState:
        """Masked reset from stored 22-dim full dynamics states (pos, q, vel,
        ω, motor ω, thrusts, t), the reset from a replay buffer. With
        ``pos_reset_by_state=False`` the positions are drawn from the
        randomizer and the rest comes from ``full_state``."""
        fs = torch.as_tensor(full_state, device=self.device).detach().to(self.dtype)
        pos = fs[:, 0:3]
        if not pos_reset_by_state:
            pos = self._spawn(state.gen)[0].detach()
        dyn = dyn_mod.reset(self.dyn_config, self.params, state.dyn, mask=mask, pos=pos,
                            ori=fs[:, 3:7], vel=fs[:, 7:10], ori_vel=fs[:, 10:13],
                            motor_omega=fs[:, 13:17], thrusts=fs[:, 17:21], t=fs[:, 21])
        return self._reset_masked(state, mask, dyn)

    def reset_scenes(self, state: Optional[EnvState] = None) -> Optional[EnvState]:
        """Scene rotation: the next scenes of the env's source (a preset's
        next seeds, as ``scene_kwargs["seed"]`` advances by the scene count,
        the larger env's where this env holds some of its scenes; a
        dataset's next files from its loader) and, given a state, every agent
        respawned in them. A primitive scene keeps at least its rows."""
        if self.scene is None:
            return state
        from ..scene import load_scenes_for_env

        total = self.scene_kwargs.get("scenes_of", (0, self.num_scene))[1]
        self.scene_kwargs["seed"] = self.scene_kwargs.get("seed", self.seed) + total
        self.scene = load_scenes_for_env(self)
        self.bbox = self.scene.bbox
        if state is None:
            return None
        return self.reset_agents(state, torch.ones((self.num_agent,), dtype=torch.bool,
                                                   device=self.device))

    def reset_env_by_id(self, state: EnvState, scene_id: int) -> EnvState:
        """Replace scene ``scene_id`` (``scene.swap_scene_for_env``: the
        dataset's next file, or a preset's fresh seed) and respawn only its
        agents; the other scenes' rows and agents stay as they were."""
        mask = self.scene_ids == int(scene_id)
        if self.scene is not None:
            from ..scene import swap_scene_for_env

            swap_scene_for_env(self, int(scene_id))
        return self.reset_agents(state, mask)

    def approaching_point(self, state: EnvState, max_distance: float = 100.0) -> Tensor:
        """The first scene hit along each agent's velocity (``trace_rays``, 64
        steps), or the point ``max_distance`` ahead where there is none (N, 3)."""
        vel = dyn_mod.velocity(state.dyn)
        direction = vel / (torch.linalg.vector_norm(vel, dim=-1, keepdim=True) + 1e-6)
        fallback = state.dyn.pos + direction * max_distance
        if self.scene is None:
            return fallback
        from ..render.sphere_trace import trace_rays

        t, hit = trace_rays(self.scene, self.scene_ids, state.dyn.pos.detach(), direction,
                            n_steps=64, max_depth=max_distance)
        return torch.where(hit[:, None], state.dyn.pos + direction * t[:, None], fallback)

    def stack(self, state: EnvState):
        """Pose snapshot (pos, q, vel, ω), detached, which ``recover`` takes."""
        d = state.dyn
        return tuple(x.detach() for x in (d.pos, d.q, d.vel, d.omega))

    def recover(self, state: EnvState, snapshot) -> EnvState:
        """Restore a pose snapshot for all agents."""
        pos, q, vel, omega = snapshot
        dyn = dyn_mod.reset(self.dyn_config, self.params, state.dyn, pos=pos, ori=q, vel=vel,
                            ori_vel=omega)
        falses = torch.zeros((self.num_agent,), dtype=torch.bool, device=self.device)
        collision, once = self._update_collision(dyn, falses, state.objects)
        return state._replace(dyn=dyn, collision=collision, once_collided=once)

    def render(self, state: EnvState, traj_history=None, **render_settings):
        """Global evaluation view (``render/global_view.py``): an (H, W, 3)
        uint8 frame, or None for an env without a scene.
        ``scene_kwargs["render_settings"]`` gives the defaults."""
        if self.scene is None:
            return None
        from ..render.global_view import render_global

        settings = {**self.scene_kwargs.get("render_settings", {}), **render_settings}
        with torch.no_grad():
            return render_global(self, state, traj_history=traj_history, **settings)

    # -- observation space metadata ----------------------------------------------

    def obs_space(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{key: (shape without the batch dimension, dtype)} of an
        observation, from a reset with a generator of its own."""
        with torch.no_grad():
            _, obs = self.reset(torch.Generator(device=self.device).manual_seed(0))
        return {k: (tuple(v.shape[1:]), v.dtype) for k, v in obs.items()}

    @property
    def observation_space(self):
        """gymnasium ``Dict`` space of the observation shapes (gymnasium is
        imported here, when asked for)."""
        import numpy as np
        from gymnasium import spaces

        out = {}
        for k, (shape, _dtype) in self.obs_space().items():
            if k in ("color", "semantic"):
                out[k] = spaces.Box(0, 255, shape, np.uint8)
            elif k == "depth":
                out[k] = spaces.Box(0.0, np.inf, shape, np.float32)
            else:
                out[k] = spaces.Box(-np.inf, np.inf, shape, np.float32)
        return spaces.Dict(out)

    @property
    def action_space(self):
        """Box(-1, 1, (4,)) for every action type."""
        import numpy as np
        from gymnasium import spaces

        return spaces.Box(-1.0, 1.0, (self.action_size,), np.float32)

    def __repr__(self):
        return (f"{type(self).__name__}(num_scene={self.num_scene}, "
                f"num_agent_per_scene={self.num_agent_per_scene}, visual={self.visual}, "
                f"device={self.device})")
