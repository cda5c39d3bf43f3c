"""Parity of the port's core math and dynamics with ``visfly_tpu``.

Inputs come from a numpy seed and go to both packages; parameters and
states cross over through ``visfly_tpu_torch.interop``. Both sides run in
float64, so the bound measures semantic agreement, not rounding.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.core import integrator as jinteg
from visfly_tpu.core import quaternion as jquat
from visfly_tpu import dynamics as jdyn
from visfly_tpu_torch.core import integrator as tinteg
from visfly_tpu_torch.core import quaternion as tquat
from visfly_tpu_torch import dynamics as tdyn
from visfly_tpu_torch.core.math_utils import safe_norm
from visfly_tpu_torch.interop import drone_params_from_numpy, dyn_state_from_numpy

torch.set_num_threads(1)

TOL = 1e-5  # 256-step float64 rollouts, the bound the JAX package holds vs the reference
N = 7
STEPS = 256


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _quats(rng, n=N):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


QUAT_FNS = {
    "mul": lambda m, q, p, v: m.mul(q, p),
    "conjugate": lambda m, q, p, v: m.conjugate(q),
    "normalize": lambda m, q, p, v: m.normalize(p * 3.0),
    "rotate": lambda m, q, p, v: m.rotate(q, v),
    "rotate_fused": lambda m, q, p, v: m.rotate_fused(q, v),
    "inv_rotate": lambda m, q, p, v: m.inv_rotate(q, v),
    "to_rotation_matrix": lambda m, q, p, v: m.to_rotation_matrix(q),
    "x_axis": lambda m, q, p, v: m.x_axis(q),
    "yaw": lambda m, q, p, v: m.yaw(q),
    "to_euler_zyx": lambda m, q, p, v: m.to_euler(q, "zyx"),
    "to_euler_xyz": lambda m, q, p, v: m.to_euler(q, "xyz"),
    "from_euler_zyx": lambda m, q, p, v: m.from_euler(v[:, 0], v[:, 1], v[:, 2], "zyx"),
    "from_euler_xyz": lambda m, q, p, v: m.from_euler(v[:, 0], v[:, 1], v[:, 2], "xyz"),
    "omega_derivative": lambda m, q, p, v: m.omega_derivative(q, v),
}


@pytest.mark.parametrize("name", sorted(QUAT_FNS))
def test_quaternion_matches_jax(name):
    rng = np.random.default_rng(0)
    q, p, v = _quats(rng), _quats(rng), rng.normal(size=(N, 3))
    fn = QUAT_FNS[name]
    ref = np.asarray(fn(jquat, *(jnp.asarray(x) for x in (q, p, v))))
    out = fn(tquat, *(torch.from_numpy(x) for x in (q, p, v))).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-12, rtol=0)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_integrator_matches_jax(method):
    rng = np.random.default_rng(1)
    args = [rng.normal(size=(N, 3)), _quats(rng), rng.normal(size=(N, 3)),
            rng.normal(size=(N, 3)), rng.normal(size=(N, 3)), rng.normal(size=(N, 3)),
            np.asarray([0.002, 0.0021, 0.004]), 1.0 / np.asarray([0.002, 0.0021, 0.004])]
    wind = rng.normal(size=(N, 3))
    ref = jinteg.integrate(*(jnp.asarray(a) for a in args), 0.01, jnp.asarray(wind),
                           method=method)
    out = tinteg.integrate(*(torch.from_numpy(a) for a in args), 0.01,
                           torch.from_numpy(wind), method=method)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-12, rtol=0)


def test_safe_norm_zero_gradient():
    x = torch.zeros((2, 3), dtype=torch.float64, requires_grad=True)
    safe_norm(x).sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))


def _initial(rng):
    pos = rng.uniform(-3, 3, size=(N, 3))
    pos[:, 2] = rng.uniform(1.0, 4.0, size=N)
    q = rng.normal(size=(N, 4)) * 0.1 + np.array([1.0, 0, 0, 0])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return pos, q, rng.uniform(-1, 1, size=(N, 3)), rng.uniform(-0.3, 0.3, size=(N, 3))


ROLLOUTS = [
    ("thrust", "euler", 0.005, 0.02, None),
    ("bodyrate", "euler", 0.005, 0.02, None),
    ("velocity", "euler", 0.005, 0.02, None),
    ("position", "euler", 0.005, 0.02, None),
    ("bodyrate", "rk4", 0.0075, 0.03, None),
    ("bodyrate", "euler", 0.03, 0.03, (0.5, -0.3, 0.1)),  # constant wind
]


@pytest.mark.parametrize("mode,integrator,dt,ctrl_dt,wind", ROLLOUTS)
def test_dynamics_rollout_matches_jax(mode, integrator, dt, ctrl_dt, wind):
    """256-step rollouts from identical params and state, float64, 1e-5."""
    rng = np.random.default_rng(2)
    kw = dict(action_type=mode, dt=dt, ctrl_dt=ctrl_dt, integrator=integrator)
    jcfg = jdyn.DroneConfig(**kw)
    jparams = jdyn.make_drone_params(jcfg, dtype=jnp.float64)
    pos, q, vel, omega = (jnp.asarray(x) for x in _initial(rng))
    jstate = jdyn.reset(jcfg, jparams, jdyn.init_state(jcfg, jparams, N, jnp.float64),
                        pos=pos, ori=q, vel=vel, ori_vel=omega)
    actions = rng.uniform(-1, 1, size=(STEPS, N, 4))

    @jax.jit
    def jroll(s, acts):
        def body(s, a):
            s = jdyn.step(jcfg, jparams, s, a, wind_const=wind)
            return s, jdyn.full_state(s)
        return jax.lax.scan(body, s, acts)[1]

    ref = np.asarray(jroll(jstate, jnp.asarray(actions)))

    tcfg = tdyn.DroneConfig(**kw)
    tparams = drone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    tstate = dyn_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate))
    out = []
    for a in torch.from_numpy(actions):
        tstate = tdyn.step(tcfg, tparams, tstate, a, wind_const=wind)
        out.append(tdyn.full_state(tstate))
    out = torch.stack(out).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


def test_make_drone_params_matches_jax():
    for mode in ("thrust", "bodyrate", "velocity", "position"):
        jp = jdyn.make_drone_params(jdyn.DroneConfig(action_type=mode), dtype=jnp.float64)
        tp = tdyn.make_drone_params(tdyn.DroneConfig(action_type=mode), dtype=torch.float64)
        for name in tdyn.DroneParams._fields:
            if name == "thrust_bound":
                pairs = zip(jp.thrust_bound, tp.thrust_bound)
            else:
                pairs = [(getattr(jp, name), getattr(tp, name))]
            for a, b in pairs:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def test_masked_reset_matches_jax():
    rng = np.random.default_rng(3)
    jcfg = jdyn.DroneConfig(dt=0.03, ctrl_dt=0.03)
    jparams = jdyn.make_drone_params(jcfg, dtype=jnp.float64)
    pos, q, vel, omega = (jnp.asarray(x) for x in _initial(rng))
    js = jdyn.reset(jcfg, jparams, jdyn.init_state(jcfg, jparams, N, jnp.float64),
                    pos=pos, ori=q, vel=vel, ori_vel=omega)
    js = jdyn.step(jcfg, jparams, js, jnp.asarray(rng.uniform(-1, 1, (N, 4))))
    mask = rng.uniform(size=N) < 0.5
    new = [rng.normal(size=(N, 3)), _quats(rng), rng.normal(size=(N, 3)),
           rng.normal(size=(N, 3)), rng.uniform(0, 6, size=N)]
    ref = jdyn.reset(jcfg, jparams, js, mask=jnp.asarray(mask),
                     pos=new[0], ori=new[1], vel=new[2], ori_vel=new[3], t=new[4])
    tparams = drone_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    ts = dyn_state_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    out = tdyn.reset(tdyn.DroneConfig(dt=0.03, ctrl_dt=0.03), tparams, ts,
                     mask=torch.from_numpy(mask), pos=torch.from_numpy(new[0]),
                     ori=torch.from_numpy(new[1]), vel=torch.from_numpy(new[2]),
                     ori_vel=torch.from_numpy(new[3]), t=torch.from_numpy(new[4]))
    for name in tdyn.DynState._fields:
        if isinstance(getattr(out, name), tuple):  # per-agent drag, unset in both
            assert getattr(ref, name) == (), name
            continue
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


def test_partial_reset_draws_clock_from_generator():
    cfg = tdyn.DroneConfig(dt=0.03, ctrl_dt=0.03)
    params = tdyn.make_drone_params(cfg)
    s = tdyn.init_state(cfg, params, 64)
    mask = torch.arange(64) % 2 == 0
    out = tdyn.reset(cfg, params, s, mask=mask, generator=torch.Generator().manual_seed(0))
    assert (out.t[~mask] == 0).all()
    assert (out.t[mask] >= 0).all() and (out.t[mask] < 2 * 3.14).all()
    assert out.t[mask].std() > 0.5
