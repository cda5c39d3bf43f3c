"""Sim-to-real dynamics alignment: replay real flight logs through the
simulator and compare trajectories (counterpart of
``visfly_tpu/utils/sim2real.py``).

Logs are plain CSV or NPZ with timestamped actions and ground-truth states:

    t, a0..a3                      normalized actions in [-1, 1]
    px, py, pz [, qw..qz, vx..vz]  ground-truth state (optional except pos)

The replay steps the port's ``dynamics`` once per logged action, on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..dynamics import DroneConfig, full_state, init_state, make_drone_params, reset, step


def load_flight_log(path: str) -> Dict[str, np.ndarray]:
    if path.endswith(".npz"):
        return dict(np.load(path))
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: np.asarray([float(r[k]) for r in rows], np.float32) for k in rows[0]}


@torch.no_grad()
def replay_actions(
    actions: np.ndarray,  # (T, 4) normalized
    config: DroneConfig,
    init_pos: Optional[np.ndarray] = None,
    init_q: Optional[np.ndarray] = None,
    init_vel: Optional[np.ndarray] = None,
    init_omega: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """Replay a recorded action sequence through the dynamics → the (T, 22)
    full-state trajectory, one row after each action."""
    params = make_drone_params(config, device=device)
    dev = params.mass.device

    def t(x, n):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float32).reshape(1, n), device=dev)

    st = reset(config, params, init_state(config, params, 1), pos=t(init_pos, 3),
               ori=t(init_q, 4), vel=t(init_vel, 3), ori_vel=t(init_omega, 3))
    acts = torch.as_tensor(np.asarray(actions, np.float32), device=dev)
    traj = []
    for a in acts:
        st = step(config, params, st, a[None])
        traj.append(full_state(st)[0])
    return torch.stack(traj).cpu().numpy()


def align(
    log: Dict[str, np.ndarray],
    config: DroneConfig,
    save_fig: Optional[str] = None,
    device="cuda",
) -> Dict[str, float]:
    """Replay a flight log and report per-axis position RMSE; optionally
    save the sim-vs-real overlay figure (the PID-tuning view) where
    matplotlib imports."""
    actions = np.stack([log[f"a{i}"] for i in range(4)], axis=-1)
    real_pos = np.stack([log["px"], log["py"], log["pz"]], axis=-1)
    init_q = (np.stack([log["qw"], log["qx"], log["qy"], log["qz"]], -1)[0]
              if "qw" in log else None)
    init_vel = np.stack([log["vx"], log["vy"], log["vz"]], -1)[0] if "vx" in log else None
    traj = replay_actions(actions, config, init_pos=real_pos[0], init_q=init_q,
                          init_vel=init_vel, device=device)
    sim_pos = traj[:, :3]
    n = min(len(sim_pos), len(real_pos))
    err = sim_pos[:n] - real_pos[:n]
    rmse = np.sqrt((err**2).mean(axis=0))
    if save_fig:
        _overlay_figure(save_fig, real_pos[:n], sim_pos[:n], rmse)
    return {"rmse_x": float(rmse[0]), "rmse_y": float(rmse[1]),
            "rmse_z": float(rmse[2]), "rmse": float(np.linalg.norm(rmse))}


def _overlay_figure(path: str, real_pos: np.ndarray, sim_pos: np.ndarray,
                    rmse: np.ndarray) -> None:
    try:
        import matplotlib
    except ImportError:  # no figure without matplotlib
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .figfashion import FigFon

    FigFon.set_fashion("IEEE")
    fig, axes = plt.subplots(3, 1, figsize=(9, 7), sharex=True)
    for i, ax in enumerate(axes):
        ax.plot(real_pos[:, i], label="real", lw=1.2)
        ax.plot(sim_pos[:, i], label="sim", lw=1.2, ls="--")
        ax.set_ylabel("xyz"[i])
        ax.grid(alpha=0.3)
    axes[0].legend()
    axes[0].set_title("sim-vs-real replay  RMSE=[" + ", ".join(f"{r:.3f}" for r in rmse)
                      + "] m")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
