"""The rest of the port's env base (``visfly_tpu_torch/envs/base.py``,
``randomization.py``, ``navigation.py``) against ``visfly_tpu``'s:
``terminal_obs_in_info``, IMU noise, ``col_refine_steps``, ``indiv_reward``,
``stack`` / ``recover``, ``reset_agents``, ``reset_agents_from_state``,
``reset_scenes``, ``meshgrid_sample``, the aggregation hooks, the spaces and
``NavigationEnv2.get_analytical_reward`` with its gradient.

As in ``test_torch_env.py``, the JAX env resets, its state crosses over
through ``interop`` and both packages step with the same actions: states,
rewards and observations within 1e-4, depth within 1e-3 m on all but 2
pixels a camera. Where the packages draw (noise, spawns, jitter), they are
held to the same distribution, not the same numbers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from test_torch_env import SPAWN_HALF, SPAWN_MEAN, TOL, _assert_depth_close, bench_kwargs
from visfly_tpu import envs as jenvs
from visfly_tpu.envs import randomization as jrnd
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.envs import randomization as trnd
from visfly_tpu_torch.interop import env_state_from_numpy

torch.set_num_threads(1)

N = 4


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(cls="NavigationEnv", **over):
    kw = bench_kwargs(**over)
    jkw = dict(kw)
    if kw.get("visual", True):  # the JAX env's plain XLA tracer, as the BPTT tests use
        jkw["sensor_kwargs"] = [dict(s, render_backend="xla") for s in kw["sensor_kwargs"]]
    return getattr(jenvs, cls)(**jkw), getattr(tenvs, cls)(**kw)


def start(jenv, seed=0):
    jst, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(seed))
    return jst, jobs, env_state_from_numpy(to_numpy(jst))


# ---------------------------------------------------------------------------
# terminal observations
# ---------------------------------------------------------------------------


def test_terminal_observation_is_pre_reset_and_matches_jax():
    """With ``terminal_obs_in_info`` the step renders before the auto-reset
    as well as after it, and ``info["terminal_observation"]`` is the pre-reset
    observation: equal to the JAX package's (depth included) while the
    post-reset observations of the respawned agents differ between packages;
    on the done step it differs from the returned observation, on a live step
    it is the returned observation."""
    jenv, tenv = pair(max_episode_steps=3)
    jenv.terminal_obs_in_info = tenv.terminal_obs_in_info = True
    jst, _, tst = start(jenv)
    renders = []
    render = tenv.sensor_observations
    tenv.sensor_observations = lambda s: renders.append(1) or render(s)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    for i in range(3):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        jst, jout = jstep(jst, jnp.asarray(a))
        tst, tout = tenv.step(tst, torch.from_numpy(a))
        term_t, term_j = tout.info["terminal_observation"], jout.info["terminal_observation"]
        assert set(term_t) == set(term_j) == {"state", "target", "depth"}
        assert not any(v.requires_grad for v in term_t.values())
        _assert_depth_close(term_t["depth"].numpy(), np.asarray(term_j["depth"]), f"step {i}")
        for k in ("state", "target"):
            np.testing.assert_allclose(term_t[k].numpy(), np.asarray(term_j[k]), atol=TOL,
                                       rtol=0, err_msg=f"step {i} {k}")
        np.testing.assert_array_equal(tout.done.numpy(), np.asarray(jout.done))
    assert len(renders) == 2 * 3
    assert bool(tout.done.all()) and bool(tout.info["TimeLimit.truncated"].all())
    assert not np.allclose(term_t["state"][:, :3].numpy(), tout.obs["state"][:, :3].numpy())
    tst, tout = tenv.step(tst, torch.zeros(N, 4))
    assert not bool(tout.done.any())
    for k, v in tout.obs.items():
        assert torch.equal(tout.info["terminal_observation"][k], v), k


# ---------------------------------------------------------------------------
# IMU noise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model,kw", [
    ("UniformNoiseModel", {"mean": np.full(13, 0.02), "half": np.full(13, 0.1)}),
    ("GaussianNoiseModel", {"mean": np.full(13, -0.01), "std": np.full(13, 0.05)}),
], ids=["uniform", "normal"])
def test_imu_noise_statistics_match_jax(model, kw):
    """The noise on position, velocity and ω (observed minus true state) over
    256 agents and 4 resets: its mean and spread as the JAX package's (the
    draws differ), the quaternion re-normalised, and a redraw at each
    observation."""
    random_kwargs = {
        "state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 0.0, 0.0]}}]},
        "noise_kwargs": {"IMU": {"model": model, "kwargs": kw}}}
    over = dict(visual=False, num_agent_per_scene=256, random_kwargs=random_kwargs)
    jenv, tenv = pair(**over)
    noise_t, noise_j = [], []
    for seed in range(4):
        jst, jobs, _ = start(jenv, seed)
        s_j = np.asarray(jobs["state"])
        noise_j.append(np.concatenate([s_j[:, :3] - np.asarray(jst.dyn.pos), s_j[:, 7:]], 1))
        tst, tobs = tenv.reset(torch.Generator().manual_seed(seed))
        s_t = tobs["state"].numpy()
        np.testing.assert_allclose(np.linalg.norm(s_t[:, 3:7], axis=-1), 1.0, atol=1e-5)
        noise_t.append(np.concatenate([s_t[:, :3] - tst.dyn.pos.numpy(),
                                       s_t[:, 7:] - np.concatenate(
                                           [tst.dyn.vel.numpy(), tst.dyn.omega.numpy()], 1)], 1))
    noise_t, noise_j = np.concatenate(noise_t), np.concatenate(noise_j)
    assert noise_t.shape == noise_j.shape == (1024, 9)
    scale = kw.get("half", kw.get("std"))[0]
    assert abs(noise_t.mean() - noise_j.mean()) < 0.05 * scale
    assert abs(noise_t.std() / noise_j.std() - 1.0) < 0.03
    if model == "UniformNoiseModel":
        for n in (noise_t, noise_j):
            lo, hi = kw["mean"][0] - scale / 2, kw["mean"][0] + scale / 2
            assert lo - 1e-6 <= n.min() < lo + 0.01 and hi - 0.01 < n.max() <= hi + 1e-6
    # each observation draws afresh
    tst, tobs = tenv.reset(torch.Generator().manual_seed(0))
    assert not torch.equal(tenv.state_obs(tst), tenv.state_obs(tst))


def test_sensor_noise_still_raises():
    """Sensor noise is ported (``render/noise.py``); a model name the JAX
    package does not know still raises, at the first render, naming it."""
    env = tenvs.NavigationEnv(**bench_kwargs(random_kwargs={
        "noise_kwargs": {"depth": {"model": "GaussianDepthNoiseModel"}}}))
    with pytest.raises(ValueError, match="unknown noise model 'GaussianDepthNoiseModel'"):
        env.reset(torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# collisions, rewards
# ---------------------------------------------------------------------------


def test_col_refine_steps_match_jax():
    """The JAX oracle's semantics: point, distance and collision from the
    undisplaced query, the velocity sub-samples feeding only the
    out-of-bounds test; with the same states the port equals the JAX
    package."""
    def mk(pkg, refine):
        kw = bench_kwargs(col_refine_steps=refine, dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.12},
                          random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                              {"position": {"mean": [1.0, 0.0, 1.5],
                                            "half": [0.1, 0.1, 0.1]}}]}})
        return (jenvs if pkg == "jax" else tenvs).NavigationEnv(**kw)

    j0, j4, t0, t4 = mk("jax", 0), mk("jax", 4), mk("torch", 0), mk("torch", 4)
    assert t4.col_refine_steps == 4
    jst, _, tst = start(j0)
    to_wall = np.asarray(jst.collision.vector)
    vhat = to_wall / (np.linalg.norm(to_wall, axis=-1, keepdims=True) + 1e-9)
    edge = np.asarray(j0.bbox)[1] - 0.3
    for name, pos, vel in (("at the wall", np.asarray(jst.dyn.pos), vhat * 20.0),
                           ("leaving the scene", np.tile(edge, (N, 1)),
                            np.tile([60.0, 0.0, 0.0], (N, 1)))):
        jdyn = jst.dyn._replace(pos=jnp.asarray(pos, jnp.float32),
                                vel=jnp.asarray(vel, jnp.float32))
        tdyn = tst.dyn._replace(pos=torch.tensor(pos, dtype=torch.float32),
                                vel=torch.tensor(vel, dtype=torch.float32))
        for jenv, tenv in ((j0, t0), (j4, t4)):
            cj, _ = jenv._update_collision(jdyn, jst.once_collided, jst.objects, scene=jenv.scene)
            ct, _ = tenv._update_collision(tdyn, tst.once_collided)
            np.testing.assert_allclose(ct.dis.numpy(), np.asarray(cj.dis), atol=TOL, err_msg=name)
            np.testing.assert_allclose(ct.point.numpy(), np.asarray(cj.point), atol=TOL)
            np.testing.assert_array_equal(ct.is_out_bounds.numpy(), np.asarray(cj.is_out_bounds))
        o0, _ = t0._update_collision(tdyn, tst.once_collided)
        o4, _ = t4._update_collision(tdyn, tst.once_collided)
        np.testing.assert_array_equal(o0.dis.numpy(), o4.dis.numpy())
    assert not bool(o0.is_out_bounds.any()) and bool(o4.is_out_bounds.all())


def test_indiv_reward_matches_jax():
    """``indiv_reward=True``: each term in ``info["extra_<term>"]`` as the
    JAX package's, summing to the reward, which equals the scalar reward."""
    jenv, tenv = pair(visual=False, indiv_reward=True, max_episode_steps=8,
                      random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                          {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 1.0, 0.5]}}]}})
    plain = tenvs.NavigationEnv(**bench_kwargs(visual=False, max_episode_steps=8))
    jst, _, tst = start(jenv)
    rng = np.random.default_rng(1)
    for i in range(3):
        a = rng.uniform(-0.3, 0.3, size=(N, 4)).astype(np.float32)
        _, out_p = plain.step(tst, torch.from_numpy(a), is_test=True)
        jst, jout = jenv.step(jst, jnp.asarray(a), is_test=True)
        tst, tout = tenv.step(tst, torch.from_numpy(a), is_test=True)
        extras = {k: v for k, v in tout.info.items() if k.startswith("extra_")}
        assert set(extras) == {k for k in jout.info if k.startswith("extra_")} == {
            f"extra_{k}" for k in ("approach", "view", "upright", "vel", "omega", "col_dis",
                                   "col_closing", "success")}
        for k, v in extras.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jout.info[k]), atol=TOL, rtol=0,
                                       err_msg=k)
        np.testing.assert_allclose(tout.reward.numpy(), sum(v.numpy() for v in extras.values()),
                                   rtol=1e-5, atol=1e-7)
        assert torch.equal(tout.reward, out_p.reward)
        assert "extra_approach" not in out_p.info


def test_analytical_reward_and_gradient_match_jax():
    """``NavigationEnv2.get_analytical_reward`` and ∂ Σ reward / ∂ (pos,
    vel) against ``jax.grad`` from the same state."""
    kw = bench_kwargs(visual=False, random_kwargs=None, num_agent_per_scene=8)
    jenv, tenv = jenvs.NavigationEnv2(**kw), tenvs.NavigationEnv2(**kw)
    jst, _, tst = start(jenv, 3)
    a = np.random.default_rng(2).uniform(-0.5, 0.5, size=(8, 4)).astype(np.float32)
    jst, _ = jenv.step(jst, jnp.asarray(a), is_test=True)
    tst, _ = tenv.step(tst, torch.from_numpy(a), is_test=True)

    def f(pos, vel):
        return jnp.sum(jenv.get_analytical_reward(jst._replace(dyn=jst.dyn._replace(pos=pos,
                                                                                   vel=vel))))

    r_j = np.asarray(jenv.get_analytical_reward(jst))
    g_j = jax.grad(f, argnums=(0, 1))(jst.dyn.pos, jst.dyn.vel)
    pos = tst.dyn.pos.clone().requires_grad_(True)
    vel = tst.dyn.vel.clone().requires_grad_(True)
    r_t = tenv.get_analytical_reward(tst._replace(dyn=tst.dyn._replace(pos=pos, vel=vel)))
    np.testing.assert_allclose(r_t.detach().numpy(), r_j, atol=TOL, rtol=0)
    g_t = torch.autograd.grad(r_t.sum(), (pos, vel))
    for gt, gj in zip(g_t, g_j):
        gj = np.asarray(gj)
        assert np.abs(gj).max() > 0
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-4 * np.abs(gj).max(), rtol=0)


# ---------------------------------------------------------------------------
# resets, snapshots, scenes
# ---------------------------------------------------------------------------


def test_stack_recover_matches_jax():
    jenv, tenv = pair("HoverEnv", visual=False, dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03},
                      random_kwargs=None)
    jst, _, tst = start(jenv)
    snap_j, snap_t = jenv.stack(jst), tenv.stack(tst)
    for a, b in zip(snap_t, snap_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for _ in range(5):
        jst, _ = jenv.step(jst, jnp.full((N, 4), 0.3), is_test=True)
        tst, _ = tenv.step(tst, torch.full((N, 4), 0.3), is_test=True)
    assert float((tst.dyn.pos - snap_t[0]).abs().max()) > 0.01
    jst, tst = jenv.recover(jst, snap_j), tenv.recover(tst, snap_t)
    np.testing.assert_allclose(tst.dyn.pos.numpy(), snap_t[0].numpy(), atol=1e-6)
    for f in ("pos", "q", "vel", "omega", "t", "motor_omega", "thrusts"):
        np.testing.assert_allclose(getattr(tst.dyn, f).numpy(), np.asarray(getattr(jst.dyn, f)),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_allclose(tst.collision.dis.numpy(), np.asarray(jst.collision.dis), atol=TOL)


def test_reset_agents_resets_only_the_mask():
    """The masked agents respawn inside the spawn box with a fresh episode;
    the others keep every field."""
    tenv = tenvs.NavigationEnv(**bench_kwargs(num_agent_per_scene=8))
    tst, _ = tenv.reset(torch.Generator().manual_seed(0))
    for _ in range(3):
        tst, _ = tenv.step(tst, torch.full((8, 4), 0.2))
    mask = torch.tensor([True, False, True, False, False, True, False, False])
    new = tenv.reset_agents(tst, mask)
    keep = ~mask
    for f in ("pos", "q", "vel", "omega"):
        assert torch.equal(getattr(new.dyn, f)[keep], getattr(tst.dyn, f)[keep]), f
        assert not torch.equal(getattr(new.dyn, f)[mask], getattr(tst.dyn, f)[mask]), f
    assert new.step_count[mask].eq(0).all() and torch.equal(new.step_count[keep],
                                                            tst.step_count[keep])
    assert new.returns[mask].eq(0).all() and torch.equal(new.returns[keep], tst.returns[keep])
    pos = new.dyn.pos[mask].numpy()
    assert (np.abs(pos - SPAWN_MEAN) <= SPAWN_HALF + 1e-6).all()


@pytest.mark.parametrize("by_state", [True, False], ids=["pos_from_state", "pos_drawn"])
def test_reset_agents_from_state_matches_jax(by_state):
    """Masked reset from stored 22-dim states: every dynamics field as the
    JAX package's (with drawn positions: the masked ones inside the spawn
    box, the rest from the stored states)."""
    jenv, tenv = pair(visual=False, num_agent_per_scene=6)
    jst, _, tst = start(jenv)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(6, 4))
    full = np.concatenate([rng.uniform(-3, 3, (6, 3)), q / np.linalg.norm(q, axis=1, keepdims=True),
                           rng.normal(size=(6, 6)), rng.uniform(100, 200, (6, 4)),
                           rng.uniform(0.1, 0.3, (6, 4)), rng.uniform(0, 6, (6, 1))], 1)
    full = full.astype(np.float32)
    mask = np.asarray([True, False, True, True, False, False])
    jnew = jenv.reset_agents_from_state(jst, jnp.asarray(mask), jnp.asarray(full), by_state)
    tnew = tenv.reset_agents_from_state(tst, torch.from_numpy(mask), torch.from_numpy(full),
                                        by_state)
    fields = ("q", "vel", "omega", "motor_omega", "thrusts", "t") + (("pos",) if by_state else ())
    for f in fields:
        np.testing.assert_allclose(getattr(tnew.dyn, f).numpy(), np.asarray(getattr(jnew.dyn, f)),
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tnew.step_count.numpy(), np.asarray(jnew.step_count))
    np.testing.assert_array_equal(tnew.dyn.pos[~mask].numpy(), tst.dyn.pos[~mask].numpy())
    if not by_state:
        spawn = tnew.dyn.pos[mask].numpy()
        assert (np.abs(spawn - SPAWN_MEAN) <= SPAWN_HALF + 1e-6).all()
        assert not np.allclose(spawn, full[mask, :3], atol=1e-3)


def test_reset_scenes_matches_jax():
    """Scene rotation regenerates the procedural scene with the next seed,
    the same scene as the JAX package's, and respawns every agent."""
    jenv, tenv = pair(num_agent_per_scene=8)
    jst, _, tst = start(jenv)
    before = tenv.scene.boxes.clone()
    jst = jenv.reset_scenes(jst)
    new = tenv.reset_scenes(tst)
    assert tenv.scene_kwargs["seed"] == jenv.scene_kwargs["seed"] == 42 + 1
    assert not torch.equal(tenv.scene.boxes, before)
    for f in ("boxes", "capsules", "bbox"):
        np.testing.assert_allclose(getattr(tenv.scene, f).numpy(),
                                   np.asarray(getattr(jenv.scene, f)), atol=1e-6, err_msg=f)
    assert new.step_count.eq(0).all() and not torch.equal(new.dyn.pos, tst.dyn.pos)
    assert not bool(tenv.is_collision_fn(new.dyn.pos).any())
    hover = tenvs.HoverEnv(num_agent_per_scene=2, device="cpu")
    hst, _ = hover.reset()
    assert hover.reset_scenes(hst) is hst and hover.reset_scenes() is None


@pytest.mark.parametrize("xyz_num,index", [((3, 2, 1), 0), ((2, 2, 2), 5), ((1, 4, 1), 2)])
def test_meshgrid_sample_matches_jax(xyz_num, index):
    """With no jitter and zero orientation, velocity and ω ranges the spawns
    equal the JAX package's row for row; the jitter stays inside its box."""
    spec_kw = {"position": {"mean": [9.0, 0.0, 1.5], "half": [8.0, 6.0, 1.0]}}
    jspec = jrnd.RandomizerSpec.uniform(**spec_kw)
    tspec = trnd.RandomizerSpec.uniform(**spec_kw)
    n = 11
    jp, jq, jv, jw = jrnd.meshgrid_sample(jspec, jax.random.PRNGKey(0), n, index, xyz_num,
                                          (0.0, 0.0, 0.0))
    tp, tq, tv, tw = trnd.meshgrid_sample(tspec, torch.Generator().manual_seed(0), n, index,
                                          xyz_num, (0.0, 0.0, 0.0))
    for a, b in ((tp, jp), (tq, jq), (tv, jv), (tw, jw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    tp2, *_ = trnd.meshgrid_sample(tspec, torch.Generator().manual_seed(1), n, index, xyz_num,
                                   (0.0, 2.0, 0.5))
    off = (tp2 - tp).abs()
    assert float(off[:, 0].max()) == 0.0 and float(off[:, 1].max()) <= 2.0
    assert float(off[:, 2].max()) <= 0.5 and float(off[:, 1].max()) > 0.1


# ---------------------------------------------------------------------------
# hooks and spaces
# ---------------------------------------------------------------------------


class _SceneDoneEnv(tenvs.HoverEnv):
    """A scene is done when any of its agents is (as a multi-drone env
    aggregates); success likewise."""

    def aggregate_done(self, done):
        per_scene = done.reshape(self.num_scene, -1).any(dim=1)
        return per_scene.repeat_interleave(self.num_agent_per_scene)

    def aggregate_success(self, success):
        return self.aggregate_done(success)


def test_aggregate_hooks_reach_done_and_success():
    env = _SceneDoneEnv(num_agent_per_scene=3, num_scene=2, device="cpu", max_episode_steps=50)
    st, _ = env.reset(torch.Generator().manual_seed(0))
    st = st._replace(step_count=torch.tensor([0, 49, 0, 0, 0, 0], dtype=torch.int32))
    st, out = env.step(st, torch.zeros(6, 4), is_test=True)
    assert out.done.tolist() == [True, True, True, False, False, False]
    assert out.info["TimeLimit.truncated"].tolist() == [False, True] + [False] * 4


def test_spaces_match_jax():
    jenv, tenv = pair(num_agent_per_scene=2)
    want = jenv.obs_space()
    got = tenv.obs_space()
    assert {k: v[0] for k, v in got.items()} == {k: v[0] for k, v in want.items()}
    assert all(v[1] == torch.float32 for v in got.values())
    assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
