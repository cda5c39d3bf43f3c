"""Initial-state randomizers (counterpart of
``visfly_tpu/envs/randomization.py``): Uniform / Normal / TargetUniform /
Union state generators, collision-rejection resampling and the meshgrid
spawns of evaluation.

Randomness comes from an explicit ``torch.Generator`` on the device of the
spec's tensors. Reference sampling quirks kept for parity:
* ranges are ``(2·U[0,1) − 1)·half + mean``;
* the Normal randomizer draws ``(2·N(0,1) − 1)·std + mean``;
* orientation is sampled as euler angles and converted with ``from_euler``
  (zyx);
* rejection resampling takes a fixed 16 tries, not an unbounded loop
  (``DEVIATIONS.md``), all drawn, tested and picked in one batched pass.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core import quaternion as quat
from ..utils import profiling


def calculate_yaw_pitch(vector: Tensor) -> Tuple[Tensor, Tensor]:
    """Heading angles of spawn→target vectors."""
    x, y, z = vector.unbind(-1)
    y_sign = torch.where(torch.sign(y) >= 0, 1.0, -1.0).to(vector.dtype)
    xy_norm = torch.linalg.vector_norm(vector[..., :2], dim=-1)
    yaw = torch.arccos(torch.clamp(x / torch.clamp(xy_norm, min=1e-9), -1.0, 1.0)) * y_sign
    norm = torch.linalg.vector_norm(vector, dim=-1)
    pitch = torch.arcsin(torch.clamp(z / torch.clamp(norm, min=1e-9), -1.0, 1.0))
    return yaw, pitch


@dataclasses.dataclass(frozen=True)
class RandomizerSpec:
    """One state generator. ``kind`` ∈ {uniform, normal, target_uniform};
    for ``normal`` the *_half fields hold the std."""

    pos_mean: Tensor
    pos_half: Tensor
    ori_mean: Tensor
    ori_half: Tensor
    vel_mean: Tensor
    vel_half: Tensor
    omega_mean: Tensor
    omega_half: Tensor
    min_dis: float = 0.5
    max_dis: float = 10.0
    kind: str = "uniform"
    heading: bool = False

    @staticmethod
    def uniform(position=None, orientation=None, velocity=None, angular_velocity=None,
                heading=False, kind="uniform", min_dis=0.5, max_dis=10.0, device=None,
                **_ignored):
        """Build from the reference's kwargs-dict format, e.g.
        ``{"position": {"mean": [1,0,1.5], "half": [1,1,0.5]}}``."""

        def mh(d):
            d = d or {}
            return (
                torch.tensor(d.get("mean", [0.0, 0.0, 0.0]), dtype=torch.float32, device=device),
                torch.tensor(d.get("half", d.get("std", [0.0, 0.0, 0.0])), dtype=torch.float32,
                             device=device),
            )

        pm, ph = mh(position)
        om, oh = mh(orientation)
        vm, vh = mh(velocity)
        am, ah = mh(angular_velocity)
        return RandomizerSpec(pos_mean=pm, pos_half=ph, ori_mean=om, ori_half=oh,
                              vel_mean=vm, vel_half=vh, omega_mean=am, omega_half=ah,
                              min_dis=float(min_dis), max_dis=float(max_dis), kind=kind,
                              heading=heading)


def from_reference_kwargs(random_kwargs: dict, device=None) -> List[RandomizerSpec]:
    """Parse the reference ``random_kwargs['state_generator']`` dict into
    specs, one per kwargs entry (a Union flattens into its members)."""
    sg = (random_kwargs or {}).get("state_generator", {})
    cls = sg.get("class", "Uniform")
    kwargs_list = sg.get("kwargs", [{}])
    kind = {"Uniform": "uniform", "Normal": "normal",
            "TargetUniform": "target_uniform"}.get(cls, "uniform")
    if cls == "Union":
        specs = []
        for entry in kwargs_list:
            for sub in entry.get("randomizers_kwargs", []):
                sub_kind = {"Uniform": "uniform", "Normal": "normal"}[sub["class"]]
                specs.append(RandomizerSpec.uniform(kind=sub_kind, device=device,
                                                    **sub["kwargs"]))
        return specs
    return [RandomizerSpec.uniform(kind=kind, device=device, **kw) for kw in kwargs_list]


def _unit_draws(spec: RandomizerSpec, gen: torch.Generator, n: int, tries: int
                ) -> List[Tensor]:
    """The raw draws of ``tries`` samples, made one sample after another: four
    (n, 3) draws each, for position, orientation, velocity and body rate, in
    that order (``torch.randn`` for a normal randomizer, ``torch.rand``
    otherwise), in a list in draw order."""
    draw = torch.randn if spec.kind == "normal" else torch.rand
    dev = spec.pos_mean.device
    return [draw((n, 3), generator=gen, device=dev) for _ in range(4 * tries)]


def _states(spec: RandomizerSpec, u_pos: Tensor, u_ori: Tensor, u_vel: Tensor,
            u_omega: Tensor, target_pos: Optional[Tensor] = None,
            target_vel: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The map from a sample's raw draws (..., n, 3) to (pos, quat, vel,
    omega); elementwise over the leading axes, so a stack of tries maps at
    once to what each try alone maps to."""
    shape = u_pos.shape

    def u(unit, mean, half):
        return (2.0 * unit - 1.0) * half + mean

    def yaw_only(yaw):
        zeros = torch.zeros_like(yaw)
        return torch.stack([zeros, zeros, yaw], dim=-1)

    if spec.kind == "target_uniform":
        # spawn on a ring around a (moving) target, yaw aimed at it
        tp = (torch.zeros(shape, device=u_pos.device) if target_pos is None
              else target_pos.expand(shape))
        offset = (2.0 * u_pos - 1.0) * spec.pos_half
        norm = torch.linalg.vector_norm(offset, dim=-1, keepdim=True)
        one = torch.ones_like(norm)
        scale = torch.where(norm > spec.max_dis, spec.max_dis / norm, one)
        scale = torch.where(norm < spec.min_dis, spec.min_dis / torch.clamp(norm, min=1e-9),
                            scale)
        pos = offset * scale + tp
        yaw, _pitch = calculate_yaw_pitch(tp - pos)
        euler = yaw_only(yaw) + (2.0 * u_ori - 1.0) * spec.ori_half
        if target_vel is not None:
            vel = target_vel.expand(shape) + (2.0 * u_vel - 1.0) * spec.vel_half
        else:
            vel = u(u_vel, spec.vel_mean, spec.vel_half)
    else:  # uniform, and normal: (2·N(0,1) − 1)·std + mean
        half = (2.0 * u_pos - 1.0) * spec.pos_half
        pos = spec.pos_mean + half
        if spec.heading and spec.kind == "uniform":
            # aim yaw back toward the spawn-range centre
            yaw, _pitch = calculate_yaw_pitch(-half)
            euler = yaw_only(yaw) + (2.0 * u_ori - 1.0) * spec.ori_half
        else:
            euler = u(u_ori, spec.ori_mean, spec.ori_half)
        vel = u(u_vel, spec.vel_mean, spec.vel_half)
    omega = u(u_omega, spec.omega_mean, spec.omega_half)
    q = quat.from_euler(euler[..., 0], euler[..., 1], euler[..., 2], order="zyx")
    return pos, q, vel, omega


def sample(spec: RandomizerSpec, gen: torch.Generator, n: int,
           target_pos: Optional[Tensor] = None, target_vel: Optional[Tensor] = None
           ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Draw (pos, quat, vel, omega) for n agents."""
    return _states(spec, *_unit_draws(spec, gen, n, 1), target_pos, target_vel)


def meshgrid_sample(spec: RandomizerSpec, gen: torch.Generator, n: int, index: int = 0,
                    xyz_num=(1, 1, 1), xyz_half=(0.0, 2.0, 0.0)
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Deterministic evaluation spawns: positions cycle from row ``index``
    through a meshgrid of ``xyz_num`` points an axis (linspace over the spawn
    box, its centre on an axis of one point), plus a uniform jitter of
    ``xyz_half``; orientation, velocity and ω are drawn as ``sample`` draws
    them."""
    dev = spec.pos_mean.device
    axes = [np.linspace(-1.0, 1.0, k) if k > 1 else np.zeros(1) for k in xyz_num]
    grid = np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")], axis=1)
    base = torch.as_tensor(grid, dtype=torch.float32, device=dev)
    rows = base[(index + torch.arange(n, device=dev)) % base.shape[0]]

    def u(mean, half):
        return (2.0 * torch.rand((n, 3), generator=gen, device=dev) - 1.0) * half + mean

    jitter = u(0.0, torch.as_tensor(xyz_half, dtype=torch.float32, device=dev))
    pos = rows * spec.pos_half + spec.pos_mean + jitter
    euler = u(spec.ori_mean, spec.ori_half)
    vel = u(spec.vel_mean, spec.vel_half)
    omega = u(spec.omega_mean, spec.omega_half)
    q = quat.from_euler(euler[:, 0], euler[:, 1], euler[:, 2], order="zyx")
    return pos, q, vel, omega


def safe_sample(spec: RandomizerSpec, gen: torch.Generator, n: int,
                is_collision_fn: Optional[Callable[[Tensor], Tensor]] = None,
                max_tries: int = 16, target_pos: Optional[Tensor] = None,
                target_vel: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Collision-rejection resampling with a fixed ``max_tries``: each agent
    keeps the first of its draws 0 .. max_tries − 1 that
    ``is_collision_fn(pos (..., n, 3)) -> (..., n) bool`` accepts, else its
    last draw, untested, as the JAX package's masked redraws do.

    One pass: the ``max_tries + 1`` samples are drawn from ``gen`` in the
    order the redraws would draw them, stacked on a leading try axis, mapped
    and tested at once and picked on the device (no host synchronisation).
    While tracing, ``spawn.redraws`` counts the kept tries' indices and
    ``spawn.exhausted`` the agents rejected on every tested try."""
    if is_collision_fn is None:
        return sample(spec, gen, n, target_pos, target_vel)
    units = _unit_draws(spec, gen, n, max_tries + 1)
    tries = _states(spec, *(torch.stack(units[k::4]) for k in range(4)), target_pos, target_vel)
    ok = ~is_collision_fn(tries[0][:max_tries])
    ok = torch.cat([ok, torch.ones_like(ok[:1])]).to(torch.uint8)
    pick = torch.argmax(ok, dim=0)  # the first accepted try, else the last
    if profiling.tracing():
        profiling.count("spawn.redraws", pick.sum())
        profiling.count("spawn.exhausted", (pick == max_tries).sum())
    return tuple(torch.gather(x, 0, pick[None, :, None].expand(1, n, x.shape[-1]))[0]
                 for x in tries)
