"""The port's gradient leg (``visfly_tpu_torch/algos/bptt.py`` over a
differentiable ``envs/base.py``) against ``visfly_tpu/algos/bptt.py``.

Both packages start from the same parameters, env state and action noise:
the JAX trainer's initial state crosses over with ``bptt_state_from_jax`` and
the noise is drawn by replaying the JAX trainer's key splits. States and the
episode limit are chosen so that no agent is done within the horizon (the two
packages' respawn draws differ).

Tolerances: the H-step loss within 1e-5; every parameter gradient within 1e-4
of its largest entry (float32 sums taken in different orders over 8 steps);
parameters after one clipped Adam step within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from test_torch_env import _write_room_obj
from visfly_tpu import envs as jenvs
from visfly_tpu.algos import BPTT as JBPTT
from visfly_tpu.algos import lr_scheduler as jlr
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import BPTT, BPTTState
from visfly_tpu_torch.algos import lr_scheduler as tlr
from visfly_tpu_torch.interop import actor_params_from_flax, bptt_state_from_jax

torch.set_num_threads(1)

HOVER = dict(num_agent_per_scene=8, visual=False, requires_grad=True,
             dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=256)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_noise(key, horizon, n, action_dim=4):
    """The action noise ``_rollout_loss`` draws: one key split a step."""
    out = []
    for _ in range(horizon):
        key, k_act = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k_act, (n, action_dim))))
    return np.stack(out)


def both_trainers(policy_kwargs, horizon=8, seed=0, env_kwargs=HOVER, env_cls="HoverEnv"):
    jtr = JBPTT(getattr(jenvs, env_cls)(**env_kwargs), horizon=horizon,
                policy_kwargs=policy_kwargs)
    jst = jtr.init(jax.random.PRNGKey(seed))
    ttr = BPTT(getattr(tenvs, env_cls)(device="cpu", **env_kwargs), horizon=horizon,
               policy_kwargs=policy_kwargs)
    tst = bptt_state_from_jax(to_numpy(jst), ttr)
    noise = torch.from_numpy(jax_noise(jst.key, horizon, jtr.env.num_envs))
    return jtr, jst, ttr, tst, noise


@pytest.mark.parametrize("policy_kwargs", [
    {"latent_dim": (32, 32)},
    {"recurrent": True, "hidden_dim": 16, "latent_dim": (16,)},
], ids=["actor", "recurrent"])
def test_rollout_loss_and_gradient_match_jax(policy_kwargs):
    """The gate of the gradient leg: ``jax.value_and_grad`` of
    ``BPTT._rollout_loss`` against the port's loss and ``.grad`` at 8 agents,
    H = 8."""
    jtr, jst, ttr, tst, noise = both_trainers(policy_kwargs)
    (loss_j, aux), grads_j = jax.value_and_grad(jtr._rollout_loss, has_aux=True)(
        jst.params, jst.env_state, jst.obs, jst.key, jst.hidden)
    assert not bool(np.asarray(aux[4][1]).any()), "an agent was done within the horizon"

    loss_t, (env_state, obs, hidden, metrics) = ttr._rollout_loss(
        tst.env_state, tst.obs, None, tst.hidden, noise)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) < 1e-5
    np.testing.assert_allclose(metrics[0].numpy(), np.asarray(aux[4][0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(env_state.dyn.pos.detach().numpy(), np.asarray(aux[0].dyn.pos),
                               atol=1e-5, rtol=0)

    # JAX gradients through the same carrier as the parameters
    twin = BPTT(ttr.env, horizon=ttr.H, policy_kwargs=policy_kwargs)
    twin.build(tst.obs)
    actor_params_from_flax(to_numpy(grads_j), twin.actor)
    want = dict(twin.actor.named_parameters())
    for name, p in ttr.actor.named_parameters():
        ref = want[name].detach()
        assert p.grad is not None, name
        scale = float(ref.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), ref.numpy(), atol=1e-4 * scale, rtol=0,
                                   err_msg=name)


def test_one_update_matches_jax():
    """Parameters after the global-norm clip and one Adam step."""
    jtr, jst, ttr, tst, noise = both_trainers({"latent_dim": (32, 32)})
    jst2, m_j = jtr.update(jst)
    tst2, m_t = ttr.update(tst, noise)
    assert abs(float(m_t["actor_loss"]) - float(m_j["actor_loss"])) < 1e-5
    assert float(m_t["grad_norm"]) == pytest.approx(float(m_j["grad_norm"]), rel=1e-4)
    twin = BPTT(ttr.env, horizon=ttr.H, policy_kwargs={"latent_dim": (32, 32)})
    twin.build(tst.obs)
    actor_params_from_flax(to_numpy(jst2.params), twin.actor)
    moved = 0.0
    for (name, p), q in zip(ttr.actor.named_parameters(), twin.actor.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
        moved = max(moved, float((p.detach() - tst.params[name]).abs().max()))
    assert tst2.global_step == int(jst2.global_step) == 8 * 8
    # the state refers to the actor's own tensors: they moved in place by ~lr
    assert all(tst2.params[n] is p for n, p in ttr.actor.named_parameters())


def make_trainer(**kw):
    env = tenvs.HoverEnv(num_agent_per_scene=32, visual=False, requires_grad=True,
                         dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03,
                                          "action_type": "bodyrate"},
                         max_episode_steps=64, device="cpu")
    kw.setdefault("horizon", 16)
    kw.setdefault("learning_rate", 1e-3)
    return BPTT(env, policy_kwargs={"latent_dim": (64, 64)}, **kw)


def test_update_runs_and_is_finite():
    tr = make_trainer()
    st = tr.init(torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in tr.actor.named_parameters()}
    st, m = tr.update(st)
    assert np.isfinite(float(m["actor_loss"]))
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0
    assert st.global_step == 16 * 32
    assert any(not torch.equal(before[n], p) for n, p in tr.actor.named_parameters())


def test_state_detached_between_updates():
    tr = make_trainer()
    st = tr.init(torch.Generator().manual_seed(2))
    st, _ = tr.update(st)

    def leaves(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from leaves(v)
        elif isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)

    carried = list(leaves(st.env_state)) + list(leaves(st.obs))
    assert len(carried) > 20
    assert all(not t.requires_grad and t.grad_fn is None for t in carried)
    st, m = tr.update(st)  # and the next update starts from it
    assert np.isfinite(float(m["actor_loss"]))


def test_predict_deterministic():
    tr = make_trainer()
    st = tr.init(torch.Generator().manual_seed(3))
    _, obs = tr.env.reset(torch.Generator().manual_seed(4))
    a1, a2 = tr.predict(st, obs), tr.predict(st, obs)
    assert torch.equal(a1, a2) and not a1.requires_grad
    assert float(a1.abs().max()) <= 1.0


def test_recurrent_bptt_predict_hooks():
    """One update of the recurrent path, predict with the carried hidden
    state, and the evaluation hooks that thread and reset it."""
    env = tenvs.HoverEnv(num_agent_per_scene=8, visual=False, requires_grad=True,
                         dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=16,
                         device="cpu")
    tr = BPTT(env, horizon=4, policy_kwargs={"recurrent": True, "hidden_dim": 16,
                                             "latent_dim": (16,)})
    st = tr.init(torch.Generator().manual_seed(0))
    assert st.hidden.shape == (8, 16)
    st, m = tr.update(st)
    assert np.isfinite(float(m["actor_loss"])) and not st.hidden.requires_grad
    obs = st.obs
    assert tr.predict(st, obs).shape == (8, 4)
    carry = tr.init_predict_carry(obs)
    _, carry1 = tr.predict_step(st, obs, carry)
    assert float(carry1.abs().max()) > 0  # the hidden state moved
    _, carry2 = tr.predict_step(st, obs, carry1)
    assert not torch.allclose(carry1, carry2)
    done = torch.ones((8,), dtype=torch.bool)
    assert float(tr.mask_predict_carry(carry2, done).abs().max()) == 0.0
    stats = tr.evaluate(st, max_steps=4)
    assert np.isfinite(stats["eval/ep_rew_mean"])


def test_trainer_forces_requires_grad():
    """An analytic-gradient trainer flips ``env.requires_grad``; without it
    observations and rewards leave ``step`` detached."""
    env = tenvs.NavigationEnv(num_agent_per_scene=2, visual=True, device="cpu",
                              scene_kwargs={"path": "garage_simple_l_medium"},
                              dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03,
                                               "comm_delay": 0.0},  # else an action acts late
                              random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                                  {"position": {"mean": [1.0, 0.0, 1.5],
                                                "half": [0.3, 0.3, 0.3]}}]}},
                              sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth",
                                              "resolution": [16, 16]}])
    assert not env.requires_grad
    state, _ = env.reset(torch.Generator().manual_seed(0))
    action = torch.zeros((2, 4), requires_grad=True)
    _, out = env.step(state, action)
    assert not out.reward.requires_grad and not out.obs["state"].requires_grad
    BPTT(env, horizon=4, policy_kwargs={"latent_dim": (16,)})
    assert env.requires_grad
    mid, out = env.step(state, action)
    assert out.reward.requires_grad and out.obs["state"].requires_grad
    # an action moves the velocity first: the pose, and with it the image, a step later
    _, out = env.step(mid, action)
    assert out.obs["depth"].requires_grad
    assert not any(v.requires_grad for v in out.info.values())
    BPTT(tenvs.HoverEnv(device="cpu"), train=False)


def test_unported_trainer_parts_raise(tmp_path):
    """Checkpoints and metric logs, once unported here, are ported: save,
    load, the interrupt checkpoint and the logger work (exact resume:
    ``tests/test_torch_checkpoint.py``)."""
    tr = make_trainer()
    st = tr.init()
    path = tr.save(st, str(tmp_path / "x"))
    assert path == str(tmp_path / "x.pt")
    st2 = tr.load(st, str(tmp_path / "x"))
    assert isinstance(st2, BPTTState) and st2.opt_state is tr.optimizer
    assert tr.save_interrupt_cache(st, str(tmp_path)) == str(tmp_path / "bptt_interrupt_cache")
    logger = tr.make_logger(str(tmp_path / "logs"), formats=("csv",))
    logger.close()
    assert (tmp_path / "logs").is_dir()
    assert tr.make_logger(None) is None
    assert isinstance(st, BPTTState)


# ---------------------------------------------------------------------------
# gradients through the env
# ---------------------------------------------------------------------------


def test_bptt_gradient_through_env():
    """Σ reward over 10 steps is differentiable in the actions, and equals
    ``jax.grad`` through the JAX env from the same state (1e-4 relative)."""
    kw = dict(num_agent_per_scene=8, visual=False, requires_grad=True,
              dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=64)
    jenv = jenvs.HoverEnv(**kw)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))
    acts = np.random.default_rng(0).normal(size=(10, 8, 4)).astype(np.float32) * 0.3

    def loss_j(actions):
        def body(s, a):
            s, out = jenv.step(s, jnp.tanh(a))
            return s, out.reward

        _, rewards = jax.lax.scan(body, jstate, actions)
        return -jnp.mean(jnp.sum(rewards, 0))

    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(acts)))

    from visfly_tpu_torch.interop import env_state_from_numpy

    tenv = tenvs.HoverEnv(device="cpu", **kw)
    state = env_state_from_numpy(to_numpy(jstate))
    actions = torch.from_numpy(acts).requires_grad_(True)
    total = 0.0
    for a in actions:
        state, out = tenv.step(state, torch.tanh(a))
        total = total + out.reward
    (-total.mean()).backward()
    g_t = actions.grad.numpy()
    assert np.isfinite(g_t).all() and np.abs(g_t).max() > 0
    np.testing.assert_allclose(g_t, g_j, atol=1e-4 * np.abs(g_j).max(), rtol=0)
    # the carried state holds the graph until the trainer cuts it
    assert state.dyn.pos.requires_grad and not tenv.detach(state).dyn.pos.requires_grad


@pytest.mark.parametrize("world", ["scene", "bbox"])
def test_grad_collision_flag_enables_position_gradient(world):
    """``grad_collision=True`` keeps the closest-point query differentiable in
    position, in a primitive scene (through the SDF's normal) and in the
    empty-box world; by default the query sees a detached position."""

    def col_dis_grad(flag):
        if world == "scene":
            env = tenvs.NavigationEnv(
                num_agent_per_scene=4, visual=True, grad_collision=flag, device="cpu",
                scene_kwargs={"path": "garage_simple_l_medium"},
                sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth",
                                "resolution": [16, 16]}],
                random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                    {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.3, 0.3, 0.3]}}]}})
        else:
            env = tenvs.HoverEnv(num_agent_per_scene=4, grad_collision=flag, device="cpu")
        state, _ = env.reset(torch.Generator().manual_seed(0))
        pos = state.dyn.pos.clone().requires_grad_(True)
        info, _ = env._update_collision(state.dyn._replace(pos=pos),
                                        state.collision.is_out_bounds)
        total = info.dis.sum() + (info.point * info.point).sum()
        if not total.requires_grad:
            return 0.0
        (g,) = torch.autograd.grad(total, pos)
        return float(g.abs().sum())

    assert col_dis_grad(False) == 0.0
    assert col_dis_grad(True) > 1e-3


def test_grad_collision_distance_gradient_matches_jax():
    """∂ Σ dis / ∂ pos with ``grad_collision=True`` against ``jax.grad`` on
    the same positions in the same scene."""
    kw = dict(num_agent_per_scene=4, visual=True, grad_collision=True,
              scene_kwargs={"path": "garage_simple_l_medium"},
              sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [16, 16]}])
    jenv = jenvs.NavigationEnv(**kw)
    tenv = tenvs.NavigationEnv(device="cpu", **kw)
    pos = np.asarray([[1.0, 0.2, 1.5], [1.3, -0.3, 1.2], [0.8, 0.1, 1.8], [3.0, 1.0, 1.0]],
                     np.float32)
    jstate, _ = jenv.reset(jax.random.PRNGKey(0))

    def f(p):
        info, _ = jenv._update_collision(jstate.dyn._replace(pos=p),
                                         jstate.collision.is_out_bounds)
        return info.dis.sum()

    g_j = np.asarray(jax.grad(f)(jnp.asarray(pos)))
    state, _ = tenv.reset(torch.Generator().manual_seed(0))
    p = torch.from_numpy(pos).requires_grad_(True)
    info, _ = tenv._update_collision(state.dyn._replace(pos=p), state.collision.is_out_bounds)
    (g_t,) = torch.autograd.grad(info.dis.sum(), p)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-4, rtol=0)
    assert np.abs(g_j).max() > 0.5  # a unit normal


# ---------------------------------------------------------------------------
# through the renderers
# ---------------------------------------------------------------------------

VISUAL_POLICY = {"net_arch": {"depth": {"cnn": 32}, "state": {"mlp": [32]},
                              "collision_vector": {"mlp": [16]}},
                 "latent_dim": (32,)}


def visual_kwargs(scene_kwargs, **over):
    """4 agents with one 16×16 depth camera: 1,024 rays, one whole tile."""
    kw = dict(num_agent_per_scene=4, visual=True, requires_grad=True, scene_kwargs=scene_kwargs,
              sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [16, 16]}],
              random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                  {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 1.0, 0.4]}}]}},
              dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=32)
    kw.update(over)
    return kw


@pytest.mark.parametrize("world", ["primitives", "mesh", "mesh_merged"])
def test_visual_bptt_through_renderer(world, tmp_path):
    """The policy sees depth, and the gradient flows action → dynamics → pose
    → render (the implicit-function rule of the primitive tracer, the planar
    rule of the triangle tracer) → next depth → policy: one update at H = 4 is
    finite and moves the CNN."""
    if world == "primitives":
        scene = {"path": "garage_simple_l_medium", "trace_steps": 16}
    else:
        scene = {"path": _write_room_obj(tmp_path / "room.obj"), "backend": "grid",
                 "sdf_spacing": 0.25}
    kw = visual_kwargs(scene)
    if world == "mesh_merged":  # the key rides along; 108 triangles stay on the tile tier
        kw["sensor_kwargs"][0]["tri_variant"] = "merged"
    env = tenvs.NavigationEnv2(device="cpu", **kw)
    tr = BPTT(env, horizon=4, policy_kwargs=VISUAL_POLICY)
    st = tr.init(torch.Generator().manual_seed(0))
    conv = tr.actor.extractor.extractors["depth_extractor"].conv[0].weight
    before = conv.detach().clone()
    # the rollout's gradient reaches the camera pose through the image alone
    loss, _ = tr._rollout_loss(st.env_state, st.obs, st.gen, st.hidden)
    loss.backward()
    assert conv.grad is not None and float(conv.grad.abs().max()) > 0
    st, m = tr.update(st)
    gn = float(m["grad_norm"])
    assert np.isfinite(float(m["actor_loss"])) and np.isfinite(gn) and gn > 0
    assert not torch.equal(conv.detach(), before)
    assert not st.obs["depth"].requires_grad and st.obs["depth"].shape == (4, 1, 16, 16)


def test_visual_rollout_loss_matches_jax():
    """The H-step loss and its gradient through the primitive renderer against
    ``jax.value_and_grad`` (the JAX env renders with its plain XLA tracer, the
    port with the kernel's plain version; both differentiate by the
    implicit-function rule)."""
    kw = visual_kwargs({"path": "garage_simple_l_medium", "trace_steps": 16})
    jkw = dict(kw, sensor_kwargs=[dict(kw["sensor_kwargs"][0], render_backend="xla")])
    jtr = JBPTT(jenvs.NavigationEnv2(**jkw), horizon=4, policy_kwargs=VISUAL_POLICY)
    jst = jtr.init(jax.random.PRNGKey(0))
    ttr = BPTT(tenvs.NavigationEnv2(device="cpu", **kw), horizon=4, policy_kwargs=VISUAL_POLICY)
    tst = bptt_state_from_jax(to_numpy(jst), ttr)
    noise = torch.from_numpy(jax_noise(jst.key, 4, 4))
    (loss_j, aux), grads_j = jax.value_and_grad(jtr._rollout_loss, has_aux=True)(
        jst.params, jst.env_state, jst.obs, jst.key, jst.hidden)
    assert not bool(np.asarray(aux[4][1]).any()), "an agent was done within the horizon"
    loss_t, (_, obs, _, _) = ttr._rollout_loss(tst.env_state, tst.obs, None, tst.hidden, noise)
    loss_t.backward()
    assert abs(float(loss_t.detach()) - float(loss_j)) < 1e-4
    np.testing.assert_allclose(obs["depth"].detach().numpy(), np.asarray(aux[1]["depth"]),
                               atol=2e-3, rtol=0)
    twin = BPTT(ttr.env, horizon=4, policy_kwargs=VISUAL_POLICY)
    twin.build(tst.obs)
    actor_params_from_flax(to_numpy(grads_j), twin.actor)
    want = dict(twin.actor.named_parameters())
    for name, p in ttr.actor.named_parameters():
        ref = want[name].detach()
        np.testing.assert_allclose(p.grad.numpy(), ref.numpy(),
                                   atol=1e-3 * float(ref.abs().max()) + 1e-7, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    3e-4,
    {"class": "linear", "kwargs": {"initial": 1e-3, "final": 1e-4, "total_steps": 50}},
    {"class": "exponential", "kwargs": {"initial": 1e-3, "decay_rate": 0.9,
                                        "transition_steps": 10}},
    {"class": "cosine", "kwargs": {"initial": 1e-3, "total_steps": 40, "final_scale": 0.1}},
], ids=["constant", "linear", "exponential", "cosine"])
def test_lr_schedules_match_jax(cfg):
    js, ts = jlr.transfer_schedule(cfg), tlr.transfer_schedule(cfg)
    for step in (0, 1, 7, 25, 40, 60):
        want = float(js(step)) if callable(js) else float(js)
        got = ts(step) if callable(ts) else ts
        assert got == pytest.approx(want, rel=1e-5)
    assert tlr.transfer_schedule(ts) is ts
    with pytest.raises(ValueError, match="unknown schedule"):
        tlr.transfer_schedule({"class": "step"})


def test_schedule_drives_the_optimiser():
    tr = make_trainer(learning_rate={"class": "linear", "kwargs": {
        "initial": 1e-3, "final": 0.0, "total_steps": 2}}, horizon=2)
    st = tr.init(torch.Generator().manual_seed(0))
    rates = []
    for _ in range(3):
        st, _ = tr.update(st)
        rates.append(tr.optimizer.adam.param_groups[0]["lr"])
    assert rates == pytest.approx([1e-3, 5e-4, 0.0])


def test_learn_runs_updates_and_calls_back():
    tr = make_trainer(horizon=2)
    seen = []
    st = tr.learn(total_timesteps=3 * 2 * 32, log_interval=0,
                  callback=lambda i, st, m: seen.append((i, float(m["actor_loss"]))))
    assert [i for i, _ in seen] == [0, 1, 2] and st.global_step == 3 * 2 * 32
    assert all(np.isfinite(v) for _, v in seen)
    stats = tr.evaluate(st, max_steps=3)
    assert set(stats) == {"eval/ep_rew_mean", "eval/ep_len_mean", "eval/success_rate"}


def test_trainer_rejects_unknown_arguments():
    """A misspelt ``horizon`` or ``gamma`` is an error, not a default."""
    env = tenvs.HoverEnv(num_agent_per_scene=2, visual=False, requires_grad=True, device="cpu")
    with pytest.raises(TypeError, match="horizont"):
        BPTT(env, horizont=8)
