# Frozen copy of visfly_tpu_torch/core/integrator.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
"""Rigid-body state integrators (euler / rk4), counterpart of
``visfly_tpu/core/integrator.py``.

Row-major batched tensors: pos/vel/omega ``(N, 3)``, quat ``(N, 4)``.

    d_pos = vel + wind
    d_q   = 0.5 · q ⊗ (0, ω)
    d_vel = acc
    d_ω   = J⁻¹ (τ − ω × (J ω))        (J diagonal)

rk4 applies wind to d_pos at every stage, as the JAX module does.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

from . import quaternion as quat


def _derivatives(vel, q, acc, omega, tau, inertia, inertia_inv, wind):
    d_pos = vel + wind
    d_q = quat.omega_derivative(q, omega)
    d_vel = acc
    j_omega = inertia * omega  # diagonal inertia
    d_omega = inertia_inv * (tau - torch.linalg.cross(omega, j_omega))
    return d_pos, d_q, d_vel, d_omega


def integrate(
    pos: Tensor,
    q: Tensor,
    vel: Tensor,
    omega: Tensor,
    acc: Tensor,
    tau: Tensor,
    inertia: Tensor,
    inertia_inv: Tensor,
    dt: float,
    wind: Tensor,
    method: str = "euler",
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """One integration step; returns (pos, q, vel, omega, d_omega).

    ``d_omega`` is the angular acceleration of the last evaluated slope (the
    bodyrate controller's D-term next step). The quaternion is not
    normalised here; the caller does it after each substep."""
    if method == "euler":
        d_pos, d_q, d_vel, d_omega = _derivatives(
            vel, q, acc, omega, tau, inertia, inertia_inv, wind
        )
        return (
            pos + d_pos * dt,
            q + d_q * dt,
            vel + d_vel * dt,
            omega + d_omega * dt,
            d_omega,
        )

    if method == "rk4":
        # stage offsets [0.5, 0.5, 1]·dt applied to (q, vel, ω); position
        # never feeds back into the derivatives
        ks = (1.0 / 6.0, 2.0 / 6.0, 2.0 / 6.0, 1.0 / 6.0)
        slice_ts = (0.5, 0.5, 1.0)

        q_c, vel_c, omega_c = q, vel, omega
        slopes = []
        for i in range(4):
            if i != 0:
                _, d_q_p, d_vel_p, d_omega_p = slopes[i - 1]
                s = slice_ts[i - 1] * dt
                q_c = q + d_q_p * s
                vel_c = vel + d_vel_p * s
                omega_c = omega + d_omega_p * s
            slopes.append(
                _derivatives(vel_c, q_c, acc, omega_c, tau, inertia, inertia_inv, wind)
            )

        def blend(idx):
            return sum(k * s[idx] for k, s in zip(ks, slopes))

        return (
            pos + blend(0) * dt,
            q + blend(1) * dt,
            vel + blend(2) * dt,
            omega + blend(3) * dt,
            slopes[-1][3],
        )

    raise ValueError("method should be one of ['euler', 'rk4']")
