"""The port's sim-to-real replay (``visfly_tpu_torch/utils/sim2real.py``)
against ``visfly_tpu/utils/sim2real.py``: the same actions from the same
initial state give the same (T, 22) trajectory within 1e-4, or 1e-6 relative
where float32 resolves no better (motor speeds of ~1,500 rad/s, whose ulp is
1.2e-4), and the same alignment statistics within 1e-4."""
import os

import numpy as np
import torch

from visfly_tpu.dynamics import DroneConfig as JDroneConfig
from visfly_tpu.utils import sim2real as jsr
from visfly_tpu_torch.dynamics import DroneConfig
from visfly_tpu_torch.utils import sim2real as tsr

torch.set_num_threads(1)

TOL, RTOL = 1e-4, 1e-6


def actions(T=50, seed=0):
    a = np.zeros((T, 4), np.float32)
    a[:, 0] = -0.333  # near-hover collective
    a[:, 1:] = np.random.default_rng(seed).uniform(-0.05, 0.05, size=(T, 3))
    return a


def test_sim2real_replay(tmp_path):
    """``tests/test_aux_subsystems.py::test_sim2real_replay``, and the
    trajectory and statistics of the JAX replay."""
    cfg = DroneConfig(dt=0.03, ctrl_dt=0.03)
    acts = actions()
    traj = tsr.replay_actions(acts, cfg, init_pos=np.asarray([0, 0, 2.0]), device="cpu")
    assert traj.shape == (50, 22) and np.isfinite(traj).all()
    ref = jsr.replay_actions(acts, JDroneConfig(dt=0.03, ctrl_dt=0.03),
                             init_pos=np.asarray([0, 0, 2.0]))
    np.testing.assert_allclose(traj, ref, atol=TOL, rtol=RTOL)
    log = {f"a{i}": acts[:, i] for i in range(4)}
    log.update({"px": traj[:, 0], "py": traj[:, 1], "pz": traj[:, 2]})
    stats = tsr.align(log, cfg, save_fig=str(tmp_path / "align.png"), device="cpu")
    assert stats["rmse"] < 0.3
    assert os.path.exists(tmp_path / "align.png")
    j_stats = jsr.align(log, JDroneConfig(dt=0.03, ctrl_dt=0.03))
    for k, v in j_stats.items():
        assert abs(stats[k] - v) < TOL, k


def test_replay_from_a_full_initial_state():
    """Attitude, velocity and body rates of the first row, as the JAX
    replay takes them, with the bodyrate controller's substeps."""
    kw = dict(dt=0.0025, ctrl_dt=0.02, action_type="bodyrate")
    init = dict(init_pos=[1.0, -1.0, 1.5], init_q=[0.9950042, 0.0, 0.0, 0.0998334],
                init_vel=[0.5, 0.0, -0.1], init_omega=[0.0, 0.1, 0.0])
    traj = tsr.replay_actions(actions(30, 1), DroneConfig(**kw), device="cpu", **init)
    ref = jsr.replay_actions(actions(30, 1), JDroneConfig(**kw), **init)
    np.testing.assert_allclose(traj, ref, atol=TOL, rtol=RTOL)


def test_flight_logs_load_as_in_jax(tmp_path):
    rng = np.random.default_rng(2)
    cols = {k: rng.normal(size=6).astype(np.float32)
            for k in ("t", "a0", "a1", "a2", "a3", "px", "py", "pz", "qw", "qx", "qy", "qz")}
    csv = tmp_path / "log.csv"
    with open(csv, "w") as f:
        f.write(",".join(cols) + "\n")
        for i in range(6):
            f.write(",".join(repr(float(v[i])) for v in cols.values()) + "\n")
    npz = tmp_path / "log.npz"
    np.savez(npz, **cols)
    for path in (str(csv), str(npz)):
        ours, ref = tsr.load_flight_log(path), jsr.load_flight_log(path)
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
