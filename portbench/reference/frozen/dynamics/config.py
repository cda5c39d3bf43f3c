# Frozen copy of visfly_tpu_torch/dynamics/config.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
"""Drone physical-parameter loading and the static/runtime config split
(counterpart of ``visfly_tpu/dynamics/config.py``).

* ``DroneConfig``: hashable Python statics (dt, substep count, action mode,
  integrator) that select the control flow of ``step``.
* ``DroneParams``: a NamedTuple of tensors (mass, inertia, gains, maps,
  normalisation scales) on the simulation device.

The drone JSON files are read by path from ``visfly_tpu/configs/drone``;
nothing of the JAX package is imported.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.types import ACTION_TYPE_ALIAS, ActionType, Bound

GRAVITY = 9.81
_CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))  # drone_state.json copied beside


@dataclasses.dataclass(frozen=True)
class DroneConfig:
    """Static dynamics configuration (the ``Dynamics.__init__`` keywords)."""

    action_type: ActionType = ActionType.BODYRATE
    dt: float = 0.005
    ctrl_dt: float = 0.03
    ctrl_delay: bool = True  # first-order motor lag
    comm_delay: float = 0.06  # action FIFO latency
    integrator: str = "euler"
    cfg: str = "drone_state"
    ori_output_type: str = "quaternion"
    action_space: Tuple[float, float] = (-1.0, 1.0)
    drag_random: float = 0.0

    def __post_init__(self):
        if isinstance(self.action_type, str):
            object.__setattr__(self, "action_type", ACTION_TYPE_ALIAS[self.action_type])
        if abs(self.ctrl_dt / self.dt - round(self.ctrl_dt / self.dt)) > 1e-9:
            raise ValueError("ctrl_dt should be a multiple of dt")

    @property
    def interval_steps(self) -> int:
        return int(round(self.ctrl_dt / self.dt))

    @property
    def comm_delay_steps(self) -> int:
        return int(self.comm_delay / self.ctrl_dt)

    @property
    def is_quat_output(self) -> bool:
        return self.ori_output_type == "quaternion"


class DroneParams(NamedTuple):
    """Runtime drone constants as tensors. Diagonal matrices (inertia, PID
    gains) are stored as their (3,) diagonals."""

    mass: Tensor  # ()
    inertia: Tensor  # (3,)
    inertia_inv: Tensor  # (3,)
    linear_drag_coeffs: Tensor  # (3,)
    quad_drag_coeffs: Tensor  # (3,) pre-scaled by ½ρ·cross-section
    b_allocation: Tensor  # (4, 4) thrust → [F, τx, τy, τz]
    b_allocation_inv: Tensor  # (4, 4)
    thrust_map: Tensor  # (3,) quadratic ω → thrust coefficients
    motor_c: Tensor  # () first-order lag constant exp(−dt/τ)
    thrust_bound: Bound  # per-rotor thrust clamp
    kp_bodyrate: Tensor  # (3,)
    kd_bodyrate: Tensor  # (3,)
    velocity_pid: Tensor  # (3,) [p, i, d]
    position_pid: Tensor  # (3,) [p, i, d]
    init_thrust: Tensor  # () hover thrust per rotor
    init_motor_omega: Tensor  # ()
    # action de-normalisation: channel 0 and channels 1:4
    scale0: Tensor
    bias0: Tensor
    scale123: Tensor
    bias123: Tensor


def _diag3(mat: Sequence[Sequence[float]]) -> np.ndarray:
    m = np.asarray(mat, dtype=np.float64)
    if m.ndim == 2:
        return np.diagonal(m).copy()
    return np.broadcast_to(m, (3,)).copy()


def load_drone_json(cfg: str) -> dict:
    """Parse a drone JSON, by name from the shipped data files or by path."""
    path = cfg if cfg.endswith(".json") else os.path.join(_CONFIG_DIR, f"{cfg}.json")
    with open(path, "r") as f:
        return json.load(f)


def make_drone_params(config: DroneConfig, dtype=torch.float32,
                      device=None) -> DroneParams:
    """Build the parameter tuple (``Dynamics.load`` + ``_init`` +
    ``_get_scale_factor`` of the reference)."""
    data = load_drone_json(config.cfg)

    mass = float(data["mass"])
    inertia = np.asarray(data["inertia"], dtype=np.float64)
    cross_sections = np.asarray(data["cross_sections"], dtype=np.float64)
    quad_drag = (
        np.asarray(data["quad_drag_coeffs"], dtype=np.float64) * 0.5 * 1.225 * cross_sections
    )
    linear_drag = np.asarray(data["linear_drag_coeffs"], dtype=np.float64)

    kappa = float(data["kappa"])
    arm_length = float(data["arm_length"])
    thrust_map = np.asarray(data["thrust_map"], dtype=np.float64)
    motor_c = math.exp(-config.dt / float(data["motor_tau"]))

    # motor geometry → allocation matrix
    motor_direction = np.array(
        [[1.0, -1.0, -1.0, 1.0], [-1.0, -1.0, 1.0, 1.0], [0.0, 0.0, 0.0, 0.0]]
    )
    motor_direction = motor_direction / np.linalg.norm(motor_direction, axis=0)
    t_bm = arm_length * motor_direction
    b_allocation = np.vstack(
        [np.ones((1, 4)), t_bm[:2], kappa * np.array([[1.0, -1.0, 1.0, -1.0]])]
    )
    b_allocation_inv = np.linalg.inv(b_allocation)

    omega_max = float(data["motor_omega_max"])
    thrust_max = thrust_map[0] * omega_max**2 + thrust_map[1] * omega_max + thrust_map[2]

    max_rate = float(data["max_rate"])
    max_spd = float(data["max_spd"])
    max_pos = float(data["max_pos"])

    # normalisation scales (max_min branch)
    lo, hi = config.action_space
    if config.action_type in (ActionType.BODYRATE, ActionType.THRUST):
        bd_acc_max = float(data["max_acc"]) * GRAVITY
        acc_scale = (bd_acc_max - 0.0) / (hi - lo)
        acc_bias = bd_acc_max - acc_scale * hi
        if config.action_type == ActionType.BODYRATE:
            rate_scale = (max_rate - (-max_rate)) / (hi - lo)
            rate_bias = max_rate - rate_scale * hi
            scale0, bias0, scale123, bias123 = acc_scale, acc_bias, rate_scale, rate_bias
        else:
            scale0, bias0, scale123, bias123 = acc_scale, acc_bias, acc_scale, acc_bias
    elif config.action_type == ActionType.VELOCITY:
        spd_scale = (max_spd - (-max_spd)) / (hi - lo)
        spd_bias = max_spd - spd_scale * hi
        yaw_scale = (math.pi - (-math.pi)) / (hi - lo)
        yaw_bias = math.pi - yaw_scale * hi
        # reference quirk kept for parity: the yaw channel de-normalises to
        # yaw_bias (== 0 for symmetric ranges)
        scale0, bias0, scale123, bias123 = yaw_bias, yaw_bias, spd_scale, spd_bias
    elif config.action_type == ActionType.POSITION:
        pos_scale = (max_pos - (-max_pos)) / (hi - lo)
        pos_bias = max_pos - pos_scale * hi
        yaw_scale = (math.pi - (-math.pi)) / (hi - lo)
        yaw_bias = math.pi - yaw_scale * hi
        scale0, bias0, scale123, bias123 = yaw_scale, yaw_bias, pos_scale, pos_bias
    else:  # pragma: no cover
        raise ValueError(f"unsupported action type {config.action_type}")

    init_thrust = mass * GRAVITY / 4.0
    a, b, c = thrust_map
    init_motor_omega = (-b + math.sqrt(b * b - 4 * a * (c - init_thrust))) / (2 * a)

    def arr(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    return DroneParams(
        mass=arr(mass),
        inertia=arr(inertia),
        inertia_inv=arr(1.0 / inertia),
        linear_drag_coeffs=arr(linear_drag),
        quad_drag_coeffs=arr(quad_drag),
        b_allocation=arr(b_allocation),
        b_allocation_inv=arr(b_allocation_inv),
        thrust_map=arr(thrust_map),
        motor_c=arr(motor_c),
        thrust_bound=Bound(min=arr(0.0), max=arr(thrust_max)),
        kp_bodyrate=arr(_diag3(data["BODYRAYE_PID"]["p"])),
        kd_bodyrate=arr(_diag3(data["BODYRAYE_PID"]["d"])),
        velocity_pid=arr([data["VELOCITY_PID"][k] for k in ("p", "i", "d")]),
        position_pid=arr([data["POSITION_PID"][k] for k in ("p", "i", "d")]),
        init_thrust=arr(init_thrust),
        init_motor_omega=arr(init_motor_omega),
        scale0=arr(scale0),
        bias0=arr(bias0),
        scale123=arr(scale123),
        bias123=arr(bias123),
    )
