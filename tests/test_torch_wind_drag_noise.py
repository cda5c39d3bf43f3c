"""The port's wind functions, per-agent drag and sensor noise
(``visfly_tpu_torch/envs/base.py``, ``dynamics/dynamics.py``,
``render/noise.py``) against ``visfly_tpu``'s.

Threefry keys and ``torch.Generator``s never give the same stream, so:
dynamics with wind, and with drag coefficients injected from the JAX state,
are compared step by step (state within 1e-5); the drag draw and every
noise model are compared by their statistics, each against the bound stated
beside it (a model's parameters, and the JAX package's own statistics on
the same image).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (module constants before a jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.render import noise as jnz
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.interop import env_state_from_numpy
from visfly_tpu_torch.render import noise as tnz

torch.set_num_threads(1)

TOL = 1e-5


def _np(x):
    return np.asarray(x)


def hover(n=4, **dyn):
    kw = dict(num_agent_per_scene=n, visual=False,
              dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, **dyn})
    return jenvs.HoverEnv(**kw), tenvs.HoverEnv(device="cpu", **kw)


# ---------------------------------------------------------------------------
# wind
# ---------------------------------------------------------------------------

def test_const_wind_advects_position():
    """Mirror of the JAX package's test: 20 steps in a 2 m/s wind drift each
    drone over 0.8 m, and the observed velocity includes the wind."""
    _, env = hover(wind_settings=[2.0, 0.0, 0.0])
    state, _ = env.reset(torch.Generator().manual_seed(0))
    x0 = state.dyn.pos[:, 0].clone()
    a = torch.tensor([-0.333, 0.0, 0.0, 0.0]).repeat(4, 1)
    for _ in range(20):
        state, out = env.step(state, a)
    assert ((state.dyn.pos[:, 0] - x0) > 0.8).all()
    assert (out.obs["state"][:, 7] > 1.5).all()


def test_string_wind_functions():
    """Mirror of the JAX package's test: a constant string wind."""
    _, env = hover(wind_settings=["1.5 + 0*y", "0*x", "0*x"])
    state, _ = env.reset(torch.Generator().manual_seed(0))
    state, _ = env.step(state, torch.zeros(4, 4))
    torch.testing.assert_close(state.dyn.wind, torch.tensor([1.5, 0.0, 0.0]).repeat(4, 1),
                               atol=1e-6, rtol=0)


WINDS = {
    "const": [0.5, -1.0, 0.2],
    "three": ["sin(x) + 0*y", "0.5*cos(2*x)", "0.1*y + 0.2"],
    # six entries: two fields summed; the namespaces' aliases of the array module
    "six": ["jnp.sin(x)", "np.cos(x) * 0.3", "th.exp(-x) * 0.2",
            "0.5 + 0*x", "math.pi * 0.1 + 0*x", "0.9*y + 0.05*exp(-x)"],
}


@pytest.mark.parametrize("wind", list(WINDS))
def test_wind_steps_match_jax(wind):
    """12 steps from the JAX reset's state with the same actions: the wind
    field, position and velocity within 1e-5 (the clock runs from t = 0)."""
    jenv, tenv = hover(wind_settings=WINDS[wind])
    assert (tenv.wind_fn is None) == (wind == "const")
    jst, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    jstep = jax.jit(lambda s, a: jenv.step(s, a, is_test=True))
    rng = np.random.default_rng(0)
    for i in range(12):
        a = rng.uniform(-0.3, 0.3, size=(4, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        for f in ("wind", "pos", "vel"):
            np.testing.assert_allclose(getattr(tst.dyn, f).numpy(), _np(getattr(jst.dyn, f)),
                                       atol=TOL, rtol=0, err_msg=f"step {i} {f}")
        np.testing.assert_allclose(tout.obs["state"].numpy(), _np(jout.obs["state"]), atol=TOL)
    assert float(tst.dyn.wind.abs().max()) > 0.1


def test_wind_fn_callable_and_namespace():
    """A callable ``wind_fn`` of (t, previous wind); the string namespace
    has no builtins."""
    env = tenvs.HoverEnv(num_agent_per_scene=3, visual=False, device="cpu", dynamics_kwargs={
        "dt": 0.03, "ctrl_dt": 0.03, "wind_fn": lambda t, w: torch.stack(
            [t, 2 * t, w[:, 2] + 1.0], dim=-1)})
    st, _ = env.reset(torch.Generator().manual_seed(0))
    st, _ = env.step(st, torch.zeros(3, 4))
    st, _ = env.step(st, torch.zeros(3, 4))
    # the wind is set from the clock before the step: t = 0.03 at the second
    torch.testing.assert_close(st.dyn.wind, torch.tensor([[0.03, 0.06, 2.0]]).repeat(3, 1))
    bad = tenvs.HoverEnv(num_agent_per_scene=2, visual=False, device="cpu", dynamics_kwargs={
        "dt": 0.03, "ctrl_dt": 0.03, "wind_settings": ["abs(x)", "0*x", "0*x"]})
    st, _ = bad.reset(torch.Generator().manual_seed(0))
    with pytest.raises(NameError, match="abs"):
        bad.step(st, torch.zeros(2, 4))


# ---------------------------------------------------------------------------
# per-agent drag
# ---------------------------------------------------------------------------

DRAG_MEAN = np.asarray([0.005, 0.005, 0.00575])


def test_drag_random_per_agent():
    """Mirror of the JAX package's test: a masked reset draws per-agent
    coefficients within ±50% of the mean that differ across agents; a full
    reset keeps the mean."""
    _, env = hover(n=8, drag_random=0.3)
    state, _ = env.reset(torch.Generator().manual_seed(0))
    torch.testing.assert_close(state.dyn.linear_drag,
                               env.params.linear_drag_coeffs.expand(8, 3))
    state = env.reset_agents(state, torch.ones(8, dtype=torch.bool))
    ld = state.dyn.linear_drag.numpy()
    assert ld.shape == (8, 3) and state.dyn.quad_drag.shape == (8, 3)
    np.testing.assert_allclose(env.params.linear_drag_coeffs.numpy(), DRAG_MEAN, rtol=1e-6)
    assert np.abs(ld / DRAG_MEAN - 1).max() <= 0.5 + 1e-6
    assert np.std(ld[:, 0]) > 1e-5
    # only the masked agents draw
    mask = torch.tensor([True, False] * 4)
    again = env.reset_agents(state, mask)
    assert torch.equal(again.dyn.linear_drag[~mask], state.dyn.linear_drag[~mask])
    assert not torch.equal(again.dyn.linear_drag[mask], state.dyn.linear_drag[mask])


def test_drag_draw_statistics_match_jax():
    """Over 4,096 agents the relative coefficient c/mean − 1 is uniform on
    ±drag_random (0.3: mean 0, std 0.3/√3 = 0.1732) in both packages:
    means within 0.01, standard deviations within 0.005 of each other and
    of the uniform's, every draw within ±0.3."""
    jenv, tenv = hover(n=4096, drag_random=0.3)
    jst, _ = jenv.reset(jax.random.PRNGKey(0))
    jst = jenv.reset_agents(jst, jnp.ones(4096, bool))
    tst, _ = tenv.reset(torch.Generator().manual_seed(0))
    tst = tenv.reset_agents(tst, torch.ones(4096, dtype=torch.bool))
    for field, mean in (("linear_drag", tenv.params.linear_drag_coeffs),
                        ("quad_drag", tenv.params.quad_drag_coeffs)):
        rel_t = (getattr(tst.dyn, field) / mean - 1).numpy()
        rel_j = _np(getattr(jst.dyn, field)) / mean.numpy() - 1
        for rel in (rel_t, rel_j):
            assert np.abs(rel).max() <= 0.3 + 1e-5
            assert abs(rel.mean()) < 0.01
            assert abs(rel.std() - 0.3 / np.sqrt(3)) < 0.005
        assert abs(rel_t.std() - rel_j.std()) < 0.005


def test_drag_steps_match_jax():
    """With the JAX package's drawn coefficients carried across, 10 steps of
    both packages agree within 1e-5: the substeps read the per-agent
    coefficients."""
    jenv, tenv = hover(n=8, drag_random=0.5, wind_settings=[3.0, -2.0, 0.0])
    jst, _ = jenv.reset(jax.random.PRNGKey(1))
    jst = jax.jit(jenv.reset_agents)(jst, jnp.ones(8, bool))
    tst = env_state_from_numpy(jax.tree_util.tree_map(np.asarray, jst))
    np.testing.assert_array_equal(tst.dyn.quad_drag.numpy(), _np(jst.dyn.quad_drag))
    jstep = jax.jit(lambda s, a: jenv.step(s, a, is_test=True))
    rng = np.random.default_rng(2)
    for i in range(10):
        a = rng.uniform(-0.3, 0.3, size=(8, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        np.testing.assert_allclose(tout.obs["state"].numpy(), _np(jout.obs["state"]), atol=TOL,
                                   rtol=0, err_msg=f"step {i}")
    # the coefficients matter: the mean drag gives another velocity
    plain = tst._replace(dyn=tst.dyn._replace(linear_drag=(), quad_drag=()))
    _, out_mean = tenv.step(plain, torch.zeros(8, 4), is_test=True)
    _, out_rand = tenv.step(tst, torch.zeros(8, 4), is_test=True)
    assert float((out_mean.obs["state"][:, 7:10] - out_rand.obs["state"][:, 7:10]).abs().max()
                 ) > 1e-6


# ---------------------------------------------------------------------------
# sensor noise
# ---------------------------------------------------------------------------

RGB = np.full((4, 3, 32, 32), 128, np.uint8)
DEPTH = np.full((4, 1, 32, 32), 3.0, np.float32)


def _both(model, img, **kw):
    """A model's output on ``img`` from the port (a seeded CPU generator)
    and from the JAX package (PRNGKey(0)), as float64 arrays."""
    got = getattr(tnz, model)(torch.Generator().manual_seed(0), torch.from_numpy(img), **kw)
    want = getattr(jnz, model)(jax.random.PRNGKey(0), jnp.asarray(img), **kw)
    assert got.dtype == {np.uint8: torch.uint8, np.float32: torch.float32}[img.dtype.type]
    assert _np(want).dtype == img.dtype
    return got.numpy().astype(np.float64), _np(want).astype(np.float64)


@pytest.mark.parametrize("model,kw,check", [
    # σ = 0.1 · 255 = 25.5 before clipping at 0 and 255
    ("gaussian", {"intensity_constant": 0.1},
     lambda x: 5.0 < x.std() < 40.0 and abs(x.mean() - 128.0) < 2.0),
    # std √128 = 11.3
    ("poisson", {}, lambda x: 5.0 < x.std() < 20.0 and abs(x.mean() - 128.0) < 2.0),
    # std 0.05 · 128 = 6.4
    ("speckle", {"sigma": 0.05}, lambda x: 3.0 < x.std() < 15.0),
    # 5% salt, 5% pepper
    ("salt_and_pepper", {"amount": 0.1},
     lambda x: 0.03 < (x == 255).mean() < 0.07 and 0.03 < (x == 0).mean() < 0.07),
])
def test_colour_noise_statistics(model, kw, check):
    """Mirror of the JAX package's statistics, in both packages; the two
    means agree within 0.5 counts and the standard deviations within 5%."""
    got, want = _both(model, RGB, **kw)
    assert check(got) and check(want)
    assert abs(got.mean() - want.mean()) < 0.5
    assert abs(got.std() - want.std()) < 0.05 * want.std()


def test_redwood_depth_statistics():
    """Unbiased where not dropped (mean within 0.1 m of 3 m), noisy, and a
    step edge triggers dropout, in both packages; the standard deviations of
    the valid pixels agree within 20%."""
    got, want = _both("redwood_depth", DEPTH, lateral_prob=0.5, dropout_scale=0.25)
    for x in (got, want):
        valid = x[x > 0]
        assert abs(valid.mean() - 3.0) < 0.1 and valid.std() > 0
    assert abs(got[got > 0].std() - want[want > 0].std()) < 0.2 * want[want > 0].std()
    edge = DEPTH.copy()
    edge[..., 16:] = 10.0
    got, want = _both("redwood_depth", edge, lateral_prob=0.0, dropout_scale=0.25)
    assert (got == 0.0).any() and (want == 0.0).any()
    # the same generator state gives the same image
    a = tnz.redwood_depth(torch.Generator().manual_seed(5), torch.from_numpy(DEPTH))
    b = tnz.redwood_depth(torch.Generator().manual_seed(5), torch.from_numpy(DEPTH))
    assert torch.equal(a, b)


def test_gaussian_depth_statistics():
    """``GaussianNoiseModel`` on a float image: additive N(mean, sigma)
    metres; mean within 1e-3 m and standard deviation within 5% of sigma
    over 4,096 pixels, in both packages, through ``apply_noise``."""
    settings = {"depth": {"model": "GaussianNoiseModel", "kwargs": {"sigma": 0.05,
                                                                    "mean": 0.01}}}
    got = tnz.apply_noise(torch.Generator().manual_seed(0), "depth", torch.from_numpy(DEPTH),
                          settings).numpy() - DEPTH
    want = _np(jnz.apply_noise(jax.random.PRNGKey(0), "depth", jnp.asarray(DEPTH),
                               settings)) - DEPTH
    for x in (got, want):
        assert abs(x.mean() - 0.01) < 1e-3 * 3 and abs(x.std() - 0.05) < 0.05 * 0.05


def test_apply_noise_dispatch():
    """No entry and the model "None" pass the image through; the colour and
    depth tables are the JAX package's; an unknown model raises
    ``ValueError``."""
    img = torch.from_numpy(RGB)
    gen = torch.Generator().manual_seed(0)
    assert tnz.apply_noise(gen, "color", img, {}) is img
    assert tnz.apply_noise(gen, "color", img, {"color": {"model": "None"}}) is img
    assert set(tnz._RGB_MODELS) == set(jnz._RGB_MODELS)
    assert set(tnz._DEPTH_MODELS) == set(jnz._DEPTH_MODELS)
    for uuid, x in (("color", img), ("depth", torch.from_numpy(DEPTH))):
        with pytest.raises(ValueError, match="unknown noise model"):
            tnz.apply_noise(gen, uuid, x, {uuid: {"model": "PerlinNoiseModel"}})
    with pytest.raises(ValueError, match="unknown noise model"):
        tnz.apply_noise(gen, "depth", torch.from_numpy(DEPTH),
                        {"depth": {"model": "SaltAndPepperNoiseModel"}})


def _noisy_env(noise, sensors=None):
    rk = {"state_generator": {"class": "Uniform", "kwargs": [
        {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.1, 0.1, 0.1]}}]}}
    if noise:
        rk["noise_kwargs"] = noise
    return tenvs.NavigationEnv(
        num_agent_per_scene=2, visual=True, device="cpu",
        scene_kwargs={"path": "garage_simple_l_medium"},
        sensor_kwargs=sensors or [{"sensor_type": "depth", "uuid": "depth",
                                   "resolution": [16, 16]}],
        random_kwargs=rk, dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=32)


REDWOOD = {"depth": {"model": "RedwoodDepthNoiseModel",
                     "kwargs": {"noise_multiplier": 1.0, "lateral_prob": 0.5}}}


def test_env_applies_sensor_noise():
    """Mirror of the JAX package's test: the noisy env's depth differs from
    the clean env's, and from step to step; the draws come from the state's
    generator (the same generator state gives the same image)."""
    clean, noisy = _noisy_env(None), _noisy_env(REDWOOD)
    st_c, obs_c = clean.reset(torch.Generator().manual_seed(0))
    st_n, obs_n = noisy.reset(torch.Generator().manual_seed(0))
    assert obs_c["depth"].shape == obs_n["depth"].shape == (2, 1, 16, 16)
    assert torch.equal(st_c.dyn.pos, st_n.dyn.pos)  # the spawn draws come first
    assert not torch.allclose(obs_c["depth"], obs_n["depth"])
    a = torch.zeros(2, 4)
    st1, out1 = noisy.step(st_n, a)
    st2, out2 = noisy.step(st1, a)
    assert not torch.allclose(out1.obs["depth"], out2.obs["depth"])
    replay = st_n.gen.get_state()
    img = noisy.sensor_observations(st_n)["depth"]
    st_n.gen.set_state(replay)
    assert torch.equal(noisy.sensor_observations(st_n)["depth"], img)


def test_env_noise_one_sensor_after_another():
    """Two noisy sensors and a clean one: each noisy image departs from the
    clean render by its model's statistics, drawn in ``sensor_kwargs``
    order from one generator; the clean sensor is untouched."""
    sensors = [{"sensor_type": "color", "uuid": "color", "resolution": [32, 32]},
               {"sensor_type": "depth", "uuid": "depth", "resolution": [32, 32]},
               {"sensor_type": "depth", "uuid": "depth_clean", "resolution": [32, 32]}]
    noise = {"color": {"model": "SaltAndPepperNoiseModel", "kwargs": {"amount": 0.2}},
             "depth": {"model": "GaussianNoiseModel", "kwargs": {"sigma": 0.02}}}
    env = _noisy_env(noise, sensors)
    st, _ = env.reset(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(9)
    st = st._replace(gen=gen)
    start = gen.get_state()
    out = env.sensor_observations(st)
    torch.testing.assert_close(out["depth_clean"], env.sensor_observations(
        st._replace(gen=torch.Generator().manual_seed(1)))["depth_clean"])
    d = (out["depth"] - out["depth_clean"]).numpy()
    assert abs(d.mean()) < 3e-3 and abs(d.std() - 0.02) < 0.1 * 0.02
    c = out["color"].numpy()
    assert 0.07 < (c == 255).mean() < 0.15
    # the colour sensor drew first, the depth second, from the same stream
    gen.set_state(start)
    salt = tnz.salt_and_pepper(gen, torch.zeros(2, 3, 32, 32, dtype=torch.uint8),
                               amount=0.2).numpy() == 255
    assert salt.any() and (c[salt] == 255).all()
