"""The port's DAgger distillation (``visfly_tpu_torch/examples/distill_vision.py``)
against the JAX recipe of ``examples/distill_vision.py``.

The JAX script is not imported: it imports JAX at the top and points JAX's
compilation cache into the repo, and its ``collect`` and ``train_epoch`` are
closures inside ``main()`` (``examples/distill_vision.py:111-137``). So the
JAX side is rebuilt here from the package calls those lines make:
``BPTT.actor.apply``, ``Actor.apply``, ``env.step``, ``optax.adam``.

Both packages start from the same env state (the JAX env's reset, carried
across by ``interop``), the same teacher and student parameters and the same
Bernoulli uniforms. Tolerances: teacher actions and state observations within
1e-5; depth within 1e-3 m on all but 2 of the 1,024 pixels a camera
(``tests/test_torch_env.py``'s render limits); a full-batch Adam step's loss
within 1e-5 relative and the parameters after it within 1e-4 in the l2 norm
(the repo's Adam convention: Adam moves a near-zero-gradient entry by up to
lr whatever rounding decides); the evaluators' episode stats equal, returns
within 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.algos import BPTT as JBPTT
from visfly_tpu.algos.common import TrainerMixin as JTrainerMixin
from visfly_tpu.policies import Actor as JActor
from visfly_tpu_torch.algos.common import AdamChain
from visfly_tpu_torch.examples import distill_vision as dv
from visfly_tpu_torch.interop import actor_params_from_flax, bptt_state_from_jax, \
    env_state_from_numpy

torch.set_num_threads(1)

N, RES, STEPS, BETA = 8, (32, 32), 3, 0.5
TOL, TOL_DEPTH = 1e-5, 1e-3
SCENE = {"path": "garage_simple_l_medium"}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_env(sensors=True, **kw):
    """``examples/distill_vision.py:72-90``'s envs at N agents."""
    return jenvs.NavigationEnv2(
        num_agent_per_scene=N, visual=True, scene_kwargs=SCENE,
        sensor_kwargs=([{"sensor_type": "depth", "uuid": "depth", "resolution": list(RES)}]
                       if sensors else None),
        dynamics_kwargs=dict(dv.DYNAMICS), max_episode_steps=256, **kw)


@pytest.fixture(scope="module")
def pair():
    """Both packages' env, teacher and student from the same numbers."""
    jenv = jax_env()
    jteacher = JBPTT(jax_env(sensors=False, requires_grad=True), horizon=32,
                     policy_kwargs={"latent_dim": (128, 128)})
    jt_st = jteacher.init(jax.random.PRNGKey(0))
    j0, jobs0 = jenv.reset(jax.random.PRNGKey(5))
    jstudent = JActor(action_dim=jenv.action_size, latent_dim=(128, 128),
                      net_arch=dv.STUDENT_ARCH)
    s_params = jstudent.init(jax.random.PRNGKey(2), dv.student_obs(jobs0), deterministic=True)

    tenv = dv.make_env(N, "cpu", RES)
    tteacher = dv.make_teacher(N, "cpu")
    bptt_state_from_jax(to_numpy(jt_st), tteacher)
    t0 = env_state_from_numpy(to_numpy(j0))
    tobs0 = {k: torch.from_numpy(np.array(v)) for k, v in to_numpy(jobs0).items()}
    tstudent = dv.make_student(tenv, tobs0)
    actor_params_from_flax(to_numpy(s_params), tstudent)
    return dict(jenv=jenv, jteacher=jteacher, t_params=jt_st.params, j0=j0, jobs0=jobs0,
                jstudent=jstudent, s_params=s_params, tenv=tenv, tteacher=tteacher, t0=t0,
                tobs0=tobs0, tstudent=tstudent)


def jax_collect(p, uniforms):
    """``examples/distill_vision.py:111-127`` step by step, the draws handed in."""
    step = jax.jit(p["jenv"].step)
    env_state, obs = p["j0"], p["jobs0"]
    s_rec, t_rec, dones = [], [], []
    for i in range(STEPS):
        ta, _ = p["jteacher"].actor.apply(p["t_params"], dv.teacher_obs(obs), deterministic=True)
        sa, _ = p["jstudent"].apply(p["s_params"], dv.student_obs(obs), deterministic=True)
        act = jnp.where(jnp.asarray(uniforms[i]) < BETA, ta, sa)
        s_rec.append(to_numpy(dv.student_obs(obs)))
        t_rec.append(np.asarray(ta))
        env_state, out = step(env_state, jnp.clip(act, -1, 1))
        obs = out.obs
        dones.append(np.asarray(out.done))
    s_obs = {k: np.stack([o[k] for o in s_rec]) for k in s_rec[0]}
    return s_obs, np.stack(t_rec), np.stack(dones), to_numpy(env_state)


def test_collect_matches_jax(pair):
    uniforms = np.random.default_rng(0).uniform(size=(STEPS, N, 1)).astype(np.float32)
    assert (uniforms < BETA).any() and (uniforms >= BETA).any()  # both policies act
    j_obs, j_act, j_done, j_state = jax_collect(pair, uniforms)
    assert not j_done.any(), "an agent was done within the steps (respawn draws differ)"
    env_state, obs, s_obs, t_act = dv.collect(
        pair["tenv"], pair["t0"], pair["tobs0"], pair["tteacher"].actor, pair["tstudent"],
        BETA, STEPS, uniforms=torch.from_numpy(uniforms))
    assert t_act.shape == (STEPS, N, 4) and set(s_obs) == {"state", "depth"}
    np.testing.assert_allclose(t_act.numpy(), j_act, atol=TOL, rtol=0)
    np.testing.assert_allclose(s_obs["state"].numpy(), j_obs["state"], atol=TOL, rtol=0)
    # depth observations are depth / 10 clipped to 1: compare in metres
    out, ref = s_obs["depth"].numpy() * 10.0, j_obs["depth"] * 10.0
    assert out.shape == ref.shape == (STEPS, N, 1, *RES)
    off = np.abs(out - ref) > TOL_DEPTH
    assert off.sum(axis=(2, 3, 4)).max() <= 2
    np.testing.assert_allclose(env_state.dyn.pos.numpy(), j_state.dyn.pos, atol=1e-4, rtol=0)
    # the flattened set is step-major, as the JAX script's reshape
    f_obs, f_act = dv.flatten(s_obs, t_act)
    assert f_obs["depth"].shape == (STEPS * N, 1, *RES)
    np.testing.assert_array_equal(f_act[N:2 * N].numpy(), t_act[1].numpy())
    agg = dv.aggregate(dv.aggregate(None, (f_obs, f_act)), (f_obs, f_act))
    assert agg[1].shape == (2 * STEPS * N, 4) and agg[0]["state"].shape == (2 * STEPS * N, 13)


def test_train_epoch_matches_optax(pair):
    """Two full-batch steps against ``optax.adam(3e-4)`` on the same batch."""
    rng = np.random.default_rng(1)
    b = 48
    batch = {"state": rng.normal(size=(b, 13)).astype(np.float32),
             "depth": rng.uniform(size=(b, 1, *RES)).astype(np.float32)}
    target = rng.uniform(-1, 1, size=(b, 4)).astype(np.float32)
    jstudent, params = pair["jstudent"], pair["s_params"]
    tx = optax.adam(3e-4)
    opt = tx.init(params)

    @jax.jit
    def jax_epoch(params, opt):
        def loss_fn(p):
            pred, _ = jstudent.apply(p, batch, deterministic=True)
            return jnp.mean((pred - target) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(g, opt, params)
        return optax.apply_updates(params, upd), opt, loss

    student = dv.make_student(pair["tenv"], pair["tobs0"])
    actor_params_from_flax(to_numpy(params), student)
    t_opt = AdamChain(student.parameters(), 3e-4)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = dv.make_student(pair["tenv"], pair["tobs0"])
    for _ in range(2):
        params, opt, loss_j = jax_epoch(params, opt)
        loss_t = dv.train_epoch(student, t_opt, t_batch, torch.from_numpy(target))
        assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
        actor_params_from_flax(to_numpy(params), ref)
        ours = torch.cat([p.detach().flatten() for p in student.parameters()])
        theirs = torch.cat([p.detach().flatten() for p in ref.parameters()])
        assert float(torch.linalg.vector_norm(ours - theirs)
                     / torch.linalg.vector_norm(theirs)) <= 1e-4
    assert t_opt.count == 2


def test_evaluators_match_jax(pair):
    """``examples/distill_vision.py:150-164``'s ``make_eval`` over the teacher
    against ``evaluate_policy``, both from the same reset state, 8 steps."""
    p = pair
    jenv, tenv = p["jenv"], p["tenv"]
    j_reset, t_reset = jenv.reset, tenv.reset
    jenv.reset = lambda key=None, state=None: (p["j0"], p["jobs0"])
    tenv.reset = lambda gen=None: (p["t0"], p["tobs0"])
    try:
        mixin = JTrainerMixin()
        mixin.env = jenv
        mixin.predict = lambda st, obs: jnp.clip(p["jteacher"].actor.apply(
            p["t_params"], dv.teacher_obs(obs), deterministic=True)[0], -1.0, 1.0)
        j_stats = mixin.evaluate(None, max_steps=8)
        t_stats = dv.evaluate_policy(
            tenv, lambda obs: p["tteacher"].actor(dv.teacher_obs(obs), deterministic=True)[0],
            max_steps=8)
    finally:
        jenv.reset, tenv.reset = j_reset, t_reset
    assert t_stats["steps"] == 8
    assert t_stats["eval/success_rate"] == j_stats["eval/success_rate"]
    assert t_stats["eval/ep_len_mean"] == j_stats["eval/ep_len_mean"]
    assert abs(t_stats["eval/ep_rew_mean"] - j_stats["eval/ep_rew_mean"]) <= 1e-4


def test_distill_rounds_on_the_cpu(pair):
    """Two rounds of 4 steps and 3 epochs at 8 agents: the dataset grows by a
    round's steps × agents, beta falls from 1 to 0, the losses are finite, and
    both evaluations run."""
    out = dv.distill(pair["tenv"], pair["tteacher"].actor, rounds=2, steps=4, epochs=3,
                     eval_steps=4)
    assert [r["dataset"] for r in out["rounds"]] == [4 * N, 8 * N]
    assert [r["beta"] for r in out["rounds"]] == [1.0, 0.0]
    assert all(np.isfinite(r["loss"]) and r["loss"] < r["first_loss"] for r in out["rounds"])
    for who in ("teacher", "student"):
        assert 0.0 <= out[who]["eval/success_rate"] <= 1.0 and out[who]["steps"] == 4
