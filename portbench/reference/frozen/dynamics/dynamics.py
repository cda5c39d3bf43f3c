# Frozen copy of visfly_tpu_torch/dynamics/dynamics.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
"""Batched quadrotor dynamics (counterpart of
``visfly_tpu/dynamics/dynamics.py``).

``step(config, params, state, action) -> state'`` is a function on a
``DynState`` NamedTuple of tensors; nothing is updated in place. Layout is
row-major ``(N, dim)``. Semantics follow the JAX module one to one:

* action FIFO communication delay
* de-normalisation scale/bias per action mode
* 4 control modes incl. the SO(3) attitude controller for VELOCITY/POSITION
* first-order motor lag + quadratic thrust map
* body-frame linear+quadratic drag
* euler/rk4 integration with post-substep quaternion normalisation
* state clamps (``_ugly_fix``)
* wind (a constant, or a function of the clock and the previous wind) and
  the wind-included ``velocity`` output
* per-agent drag coefficients drawn at a partial reset (``drag_random``)

Reference quirks replicated on purpose (``DEVIATIONS.md``): the velocity
mode's yaw channel de-normalises to 0, partial resets draw the clock from
``U[0, 2·3.14)``, and the ``_ugly_fix`` clamps.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ..core import integrator as integ
from ..core import quaternion as quat
from ..core.math_utils import full_fp32_matmul
from ..core.types import ActionType
from .config import GRAVITY, DroneConfig, DroneParams


def _g_vec(like: Tensor) -> Tensor:
    """Gravity in the dtype and device of the computation."""
    return like.new_tensor([0.0, 0.0, -GRAVITY])


class DynState(NamedTuple):
    """Per-step dynamics state for N drones."""

    pos: Tensor  # (N, 3)
    q: Tensor  # (N, 4) [w, x, y, z]
    vel: Tensor  # (N, 3)  (wind NOT included; see `velocity()`)
    omega: Tensor  # (N, 3) body rates
    motor_omega: Tensor  # (N, 4)
    thrusts: Tensor  # (N, 4)
    acc: Tensor  # (N, 3)
    angular_acc: Tensor  # (N, 3)
    t: Tensor  # (N,)
    pre_action: Tensor  # (K, N, 4) comm-delay FIFO (K may be 0)
    wind: Tensor  # (N, 3) current wind velocity
    # per-agent drag coefficients (N, 3) when config.drag_random > 0, else ()
    linear_drag: Any = ()
    quad_drag: Any = ()


WindFn = Callable[[Tensor, Tensor], Tensor]  # (t (N,), prev (N, 3)) -> (N, 3)


def init_state(config: DroneConfig, params: DroneParams, num: int,
               dtype=torch.float32) -> DynState:
    """Fresh state at the origin with hover thrusts."""
    dev = params.mass.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return DynState(
        pos=zeros(num, 3),
        q=quat.identity((num,), dtype, dev),
        vel=zeros(num, 3),
        omega=zeros(num, 3),
        motor_omega=params.init_motor_omega.to(dtype).expand(num, 4).clone(),
        thrusts=params.init_thrust.to(dtype).expand(num, 4).clone(),
        acc=zeros(num, 3),
        angular_acc=zeros(num, 3),
        t=zeros(num),
        pre_action=zeros(config.comm_delay_steps, num, 4),
        wind=zeros(num, 3),
        linear_drag=(params.linear_drag_coeffs.to(dtype).expand(num, 3).clone()
                     if config.drag_random else ()),
        quad_drag=(params.quad_drag_coeffs.to(dtype).expand(num, 3).clone()
                   if config.drag_random else ()),
    )


def reset(
    config: DroneConfig,
    params: DroneParams,
    state: DynState,
    mask: Optional[Tensor] = None,
    pos: Optional[Tensor] = None,
    ori: Optional[Tensor] = None,
    vel: Optional[Tensor] = None,
    ori_vel: Optional[Tensor] = None,
    motor_omega: Optional[Tensor] = None,
    thrusts: Optional[Tensor] = None,
    t: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    rows: Optional[Tuple[int, int, int]] = None,
) -> DynState:
    """Masked reset. ``mask`` (N,) bool selects the agents to reset; None
    resets all. A partial reset with a ``generator`` and no ``t`` draws the
    clock from ``U[0, 2·3.14)``; a full reset uses t = 0. With
    ``config.drag_random > 0`` a reset with a ``generator`` draws each reset
    agent's drag coefficients, ``mean · (clip((U − 0.5)·2·drag_random, −0.5,
    0.5) + 1)``, linear then quadratic, after the clock. Where the state is
    the block ``rows`` = (start, stop, n) of n agents, each draw is the n
    agents', sliced."""
    num = state.pos.shape[0]
    dtype, dev = state.pos.dtype, state.pos.device
    lo, hi, n_draw = (0, num, num) if rows is None else rows

    def draw(*tail):
        return torch.rand((n_draw, *tail), generator=generator, dtype=dtype,
                          device=dev)[lo:hi]
    full = mask is None
    if full:
        mask = torch.ones((num,), dtype=torch.bool, device=dev)
    m1 = mask[:, None]

    def pick(new, old):
        return torch.where(m1, new.to(dtype), old)

    new_pos = torch.zeros_like(state.pos) if pos is None else pos
    new_q = quat.identity((num,), dtype, dev) if ori is None else ori
    new_vel = torch.zeros_like(state.vel) if vel is None else vel
    new_omega = torch.zeros_like(state.omega) if ori_vel is None else ori_vel
    new_momega = (params.init_motor_omega.expand_as(state.motor_omega)
                  if motor_omega is None else motor_omega)
    new_thrusts = (params.init_thrust.expand_as(state.thrusts)
                   if thrusts is None else thrusts)
    if t is None:
        if full or generator is None:
            new_t = torch.zeros_like(state.t)
        else:
            new_t = draw() * 3.14 * 2
    else:
        new_t = t

    linear_drag, quad_drag = state.linear_drag, state.quad_drag
    if config.drag_random and isinstance(linear_drag, Tensor) and generator is not None:
        def rand_coeffs(mean):
            u = (draw(3) - 0.5) * 2 * config.drag_random
            return mean * (torch.clamp(u, -0.5, 0.5) + 1.0)

        linear_drag = pick(rand_coeffs(params.linear_drag_coeffs), linear_drag)
        quad_drag = pick(rand_coeffs(params.quad_drag_coeffs), quad_drag)

    zeros3 = torch.zeros_like(state.acc)
    return DynState(
        pos=pick(new_pos, state.pos),
        q=pick(new_q, state.q),
        vel=pick(new_vel, state.vel),
        omega=pick(new_omega, state.omega),
        motor_omega=pick(new_momega, state.motor_omega),
        thrusts=pick(new_thrusts, state.thrusts),
        acc=pick(zeros3, state.acc),
        angular_acc=pick(zeros3, state.angular_acc),
        t=torch.where(mask, new_t.to(dtype), state.t),
        pre_action=torch.where(mask[None, :, None], torch.zeros_like(state.pre_action),
                               state.pre_action),
        wind=state.wind,
        linear_drag=linear_drag,
        quad_drag=quad_drag,
    )


# ---------------------------------------------------------------------------
# step internals
# ---------------------------------------------------------------------------


def _de_normalize(config: DroneConfig, params: DroneParams, action: Tensor) -> Tensor:
    """[-1,1] action → physical command."""
    if config.action_type == ActionType.THRUST:
        return params.mass * (action * params.scale0 + params.bias0)
    c0 = action[:, :1] * params.scale0 + params.bias0
    c123 = action[:, 1:] * params.scale123 + params.bias123
    if config.action_type == ActionType.BODYRATE:
        c0 = c0 * params.mass  # collective thrust = m · z-acc
    return torch.cat([c0, c123], dim=-1)


def normalize_command(config: DroneConfig, params: DroneParams, command: Tensor) -> Tensor:
    """Physical command → [-1, 1] action, the inverse of ``_de_normalize``.
    BODYRATE commands are [z-acceleration, body rates]: the acceleration,
    not the collective thrust, as in the reference."""
    if config.action_type == ActionType.THRUST:
        return (command / params.mass - params.bias0) / params.scale0
    c0 = (command[:, :1] - params.bias0) / torch.where(params.scale0 == 0, 1.0, params.scale0)
    c123 = (command[:, 1:] - params.bias123) / torch.where(params.scale123 == 0, 1.0,
                                                           params.scale123)
    return torch.cat([c0, c123], dim=-1)


def _so3_attitude(params: DroneParams, state: DynState, f_des: Tensor,
                  yaw_des: Tensor, yaw_gain: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """SO(3) attitude machinery shared by VELOCITY/POSITION.

    Returns (gross_thrust, pose_err, ang_vel_err)."""
    yaw_err = yaw_des - quat.yaw(state.q)
    yaw_err = torch.atan2(torch.sin(yaw_err), torch.cos(yaw_err))
    yaw_spd_des = yaw_err * yaw_gain * 2.0

    gross_thrust = quat.inv_rotate(state.q, f_des)[:, 2]

    b3 = f_des / torch.linalg.vector_norm(f_des, dim=-1, keepdim=True)
    c1 = torch.stack([torch.cos(yaw_des), torch.sin(yaw_des), torch.zeros_like(yaw_des)],
                     dim=-1)
    b2 = torch.linalg.cross(b3, c1)
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    b1 = torch.linalg.cross(b2, b3)
    r_des = torch.stack([b1, b2, b3], dim=-1)  # columns are the basis vectors
    r = quat.to_rotation_matrix(state.q)

    # A = R_desᵀ R ; m = ½(A − Aᵀ)
    a = torch.einsum("nki,nkj->nij", r_des, r)
    m = 0.5 * (a - a.transpose(-1, -2))
    pose_err = torch.stack([m[:, 1, 2], -m[:, 0, 2], m[:, 0, 1]], dim=-1)
    ang_vel_err = a[:, :, 2] * yaw_spd_des[:, None] - state.omega
    return gross_thrust, pose_err, ang_vel_err


def _thrust_from_cmd(config: DroneConfig, params: DroneParams, state: DynState,
                     command: Tensor) -> Tensor:
    """Mode-dependent per-rotor desired thrust."""
    at = config.action_type
    if at == ActionType.THRUST:
        thrusts_des = command
    elif at == ActionType.BODYRATE:
        omega_err = command[:, 1:] - state.omega
        j_omega = params.inertia * state.omega
        torque_des = (
            params.inertia * (params.kp_bodyrate * omega_err)
            + torch.linalg.cross(state.omega, j_omega)
            - params.kd_bodyrate * state.angular_acc
        )
        thrusts_torque = torch.cat([command[:, :1], torque_des], dim=-1)
        thrusts_des = thrusts_torque @ params.b_allocation_inv.T
    elif at == ActionType.VELOCITY:
        a_des = params.velocity_pid[0] * (command[:, 1:] - state.vel)
        f_des = params.mass * (a_des - _g_vec(a_des))
        # auto-yaw toward the velocity direction
        vel_h = state.vel[:, :2]
        vel_h_norm = torch.linalg.vector_norm(vel_h, dim=-1)
        yaw_des = torch.where(vel_h_norm > 0.1, torch.atan2(vel_h[:, 1], vel_h[:, 0]),
                              quat.yaw(state.q))
        gross, pose_err, ang_vel_err = _so3_attitude(
            params, state, f_des, yaw_des, params.velocity_pid[2])
        # the ω×ω term of the reference is identically zero; omitted
        torque_des = params.inertia * (
            params.kp_bodyrate * pose_err + params.kp_bodyrate * ang_vel_err)
        thrusts_des = torch.cat([gross[:, None], torque_des], dim=-1) @ params.b_allocation_inv.T
    elif at == ActionType.POSITION:
        v_des = params.position_pid[2] * (command[:, 1:] - state.pos)
        a_des = params.velocity_pid[2] * (v_des - state.vel)
        f_des = params.mass * (a_des - _g_vec(a_des))
        yaw_des = command[:, 0]  # direct yaw command
        gross, pose_err, ang_vel_err = _so3_attitude(
            params, state, f_des, yaw_des, params.position_pid[2])
        j_omega = params.inertia * state.omega
        torque_des = params.inertia * (
            params.kp_bodyrate * pose_err
            + 1.2 * (params.kp_bodyrate * ang_vel_err)
            - params.kd_bodyrate * state.angular_acc
            - torch.linalg.cross(state.omega, j_omega)
        )
        thrusts_des = torch.cat([gross[:, None], torque_des], dim=-1) @ params.b_allocation_inv.T
    else:  # pragma: no cover
        raise ValueError(f"unsupported action type {at}")

    return torch.minimum(torch.maximum(thrusts_des, params.thrust_bound.min),
                         params.thrust_bound.max)


def _rotor_omega_from_thrust(params: DroneParams, thrusts: Tensor) -> Tensor:
    """Quadratic-formula inverse of the thrust map."""
    a, b, c = params.thrust_map.unbind(0)
    return (-b + torch.sqrt(b * b - 4.0 * a * (c - thrusts))) / (2.0 * a)


def _thrust_from_rotor_omega(params: DroneParams, motor_omega: Tensor) -> Tensor:
    a, b, c = params.thrust_map.unbind(0)
    return a * motor_omega**2 + b * motor_omega + c


def _substep(config: DroneConfig, params: DroneParams, state: DynState,
             thrust_des: Tensor) -> DynState:
    """One physics substep of dt."""
    if config.ctrl_delay:
        motor_omega_des = _rotor_omega_from_thrust(params, thrust_des)
        motor_omega = (params.motor_c * state.motor_omega
                       + (1.0 - params.motor_c) * motor_omega_des)
        thrusts = _thrust_from_rotor_omega(params, motor_omega)
    else:
        motor_omega = state.motor_omega
        thrusts = thrust_des

    force_torque = thrusts @ params.b_allocation.T  # (N, 4) [F, τ]

    vel_body = quat.inv_rotate(state.q, state.vel)
    ld = params.linear_drag_coeffs if isinstance(state.linear_drag, tuple) else state.linear_drag
    qd = params.quad_drag_coeffs if isinstance(state.quad_drag, tuple) else state.quad_drag
    drag = ld * vel_body + qd * vel_body * torch.abs(vel_body)
    thrust_vec = torch.cat([torch.zeros_like(force_torque[:, :2]), force_torque[:, :1]],
                           dim=-1)
    acc = quat.rotate(state.q, thrust_vec - drag) / params.mass + _g_vec(state.pos)

    pos, q, vel, omega, angular_acc = integ.integrate(
        state.pos, state.q, state.vel, state.omega, acc, force_torque[:, 1:],
        params.inertia, params.inertia_inv, config.dt, state.wind,
        method=config.integrator,
    )
    return state._replace(
        pos=pos, q=quat.normalize(q), vel=vel, omega=omega,
        motor_omega=motor_omega, thrusts=thrusts, acc=acc, angular_acc=angular_acc,
    )


def _ugly_fix(state: DynState) -> DynState:
    """State clamps preventing numeric explosion (reference quirk)."""
    pos = torch.cat([torch.clamp(state.pos[:, :2], -100.0, 100.0),
                     torch.clamp(state.pos[:, 2:], 0.0, 20.0)], dim=-1)
    return state._replace(
        pos=pos,
        vel=torch.clamp(state.vel, -20.0, 20.0),
        omega=torch.clamp(state.omega, -10.0, 10.0),
    )


def update_wind(state: DynState, wind_fn: Optional[WindFn] = None,
                wind_const=None) -> DynState:
    """Set the wind field: ``wind_fn(t, previous wind)``, a constant (3,)
    velocity, or zero."""
    if wind_fn is not None:
        wind = wind_fn(state.t, state.wind)
    elif wind_const is not None:
        wind = torch.as_tensor(wind_const, dtype=state.wind.dtype,
                               device=state.wind.device).expand_as(state.wind)
    else:
        wind = torch.zeros_like(state.wind)
    return state._replace(wind=wind)


def step(config: DroneConfig, params: DroneParams, state: DynState, action: Tensor,
         wind_fn: Optional[WindFn] = None, wind_const=None) -> DynState:
    """Advance N drones by one control step of ctrl_dt. ``action`` is (N, 4)
    in [-1, 1]; the wind comes from ``wind_fn`` or ``wind_const`` (see
    :func:`update_wind`)."""
    full_fp32_matmul()
    state = update_wind(state, wind_fn, wind_const)

    # communication-delay FIFO
    if config.comm_delay_steps > 0:
        delayed = state.pre_action[0]
        pre_action = torch.cat([state.pre_action[1:], action[None].to(state.pre_action.dtype)],
                               dim=0)
        state = state._replace(pre_action=pre_action)
        action = delayed

    command = _de_normalize(config, params, action)
    thrust_des = _thrust_from_cmd(config, params, state, command)

    for _ in range(config.interval_steps):
        state = _substep(config, params, state, thrust_des)

    state = state._replace(t=state.t + config.ctrl_dt)
    return _ugly_fix(state)


# ---------------------------------------------------------------------------
# observable views
# ---------------------------------------------------------------------------


def velocity(state: DynState) -> Tensor:
    """Ground velocity incl. wind."""
    return state.vel + state.wind


def orientation(state: DynState, config: Optional[DroneConfig] = None) -> Tensor:
    """Quaternion (N,4) or euler (N,3) per ``ori_output_type``."""
    if config is not None and not config.is_quat_output:
        return quat.to_euler(state.q)
    return state.q


def direction(state: DynState) -> Tensor:
    """Body x-axis in the world frame."""
    return quat.x_axis(state.q)


def get_state(state: DynState, config: Optional[DroneConfig] = None) -> Tensor:
    """Observable state [pos, orientation, vel+wind, ω]."""
    return torch.cat([state.pos, orientation(state, config), velocity(state), state.omega],
                     dim=-1)


def full_state(state: DynState) -> Tensor:
    """22-dim state (+motor ω, thrusts, t)."""
    return torch.cat([state.pos, state.q, velocity(state), state.omega,
                      state.motor_omega, state.thrusts, state.t[:, None]], dim=-1)


def extend_state(state: DynState) -> Tensor:
    """28-dim state (+ linear and angular acceleration)."""
    return torch.cat([state.pos, state.q, velocity(state), state.omega, state.acc,
                      state.angular_acc, state.motor_omega, state.thrusts, state.t[:, None]],
                     dim=-1)
