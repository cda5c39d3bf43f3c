"""The port's PPO (``visfly_tpu_torch/algos/ppo.py``) against
``visfly_tpu/algos/ppo.py``.

Both packages start from the same parameters and env state (the JAX
trainer's initial state crosses over with ``ppo_state_from_jax``) and use the
same draws: the rollout's action noise and each epoch's permutation are
replayed from the JAX trainer's key splits and handed to the port. The
episode limit equals the rollout's length, so every agent is truncated at the
last step: the γ·V(terminal observation) bootstrap and the episode window are
exercised, and no respawn (whose draws differ between the packages) feeds the
batch. Tolerances: every loss metric within 1e-5; parameters after the
update within 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu import envs as jenvs
from visfly_tpu.algos import PPO as JPPO
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.algos import ALGO_ALIASES, PPO, PPOState
from visfly_tpu_torch.interop import policy_params_from_flax, ppo_state_from_jax

torch.set_num_threads(1)

N, STEPS = 8, 8
ENV = dict(num_agent_per_scene=N, visual=False, dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03},
           max_episode_steps=STEPS)
FLAT = {"pi_layers": (16,), "vf_layers": (16,)}
RECURRENT = {"recurrent": True, "hidden_dim": 16, "pi_layers": (16,), "vf_layers": (16,)}
CASES = {
    # the stop triggers after the first minibatch: update_fraction 1/12
    "flat_vf_clip_kl_stop": (FLAT, dict(n_epochs=3, batch_size=16, clip_range_vf=0.2,
                                        target_kl=1e-8)),
    # the tuned recipe's options: AdamW, entropy bonus, a schedule
    "flat_adamw_schedule": (FLAT, dict(n_epochs=2, batch_size=32, ent_coef=0.003,
                                       weight_decay=1e-5, learning_rate={
                                           "class": "linear", "kwargs": {
                                               "initial": 1e-3, "final": 1e-4,
                                               "total_steps": 4}})),
    "recurrent_vf_clip_kl_stop": (RECURRENT, dict(n_epochs=2, batch_size=16, clip_range_vf=0.2,
                                                  target_kl=1e-8)),
}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_draws(key, n_epochs, n_perm):
    """The action noise ``_collect`` draws (one split a step) and the
    permutation each epoch draws after it."""
    noise, perms = [], []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k, (N, 4))))
    for _ in range(n_epochs):
        key, k = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k, n_perm)))
    return torch.from_numpy(np.stack(noise)), torch.from_numpy(np.stack(perms))


def pair(case):
    policy_kwargs, kw = CASES[case]
    jtr = JPPO(jenvs.HoverEnv(**ENV), n_steps=STEPS, policy_kwargs=policy_kwargs, **kw)
    jst = jtr.init(jax.random.PRNGKey(0))
    ttr = PPO(tenvs.HoverEnv(device="cpu", **ENV), n_steps=STEPS, policy_kwargs=policy_kwargs,
              **kw)
    tst = ppo_state_from_jax(to_numpy(jst), ttr)
    n_perm = N if ttr.recurrent else N * STEPS
    noise, perms = jax_draws(jst.key, ttr.n_epochs, n_perm)
    return jtr, jst, ttr, tst, noise, perms


@pytest.fixture(scope="module", params=list(CASES))
def updated(request):
    """One update of each package from the same state and draws."""
    jtr, jst, ttr, tst, noise, perms = pair(request.param)
    before = {n: p.detach().clone() for n, p in ttr.policy.named_parameters()}
    jst2, m_j = jtr.update(jst)
    tst2, m_t = ttr.update(tst, noise, perms)
    return request.param, jtr, jst2, to_numpy(m_j), ttr, tst2, m_t, before


def test_update_matches_jax(updated):
    case, jtr, jst2, m_j, ttr, tst2, m_t, before = updated
    assert set(m_j) <= set(m_t)
    for k, v in m_j.items():
        assert abs(float(m_t[k]) - float(v)) < 1e-5, (k, float(m_t[k]), float(v))
    if "kl_stop" in case:
        n_mb = ttr.n_epochs * ttr.n_minibatches
        assert float(m_t["update_fraction"]) == pytest.approx(1.0 / n_mb)
    else:
        assert float(m_t["update_fraction"]) == 1.0
    twin = PPO(ttr.env, n_steps=STEPS, policy_kwargs=CASES[case][0])
    twin.build(tst2.obs)
    policy_params_from_flax(to_numpy(jst2.params), twin.policy)
    for (name, p), q in zip(ttr.policy.named_parameters(), twin.policy.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)
    assert any(not torch.equal(before[n], p) for n, p in ttr.policy.named_parameters())


def test_rollout_state_matches_jax(updated):
    """The episode window and counters after the rollout: every agent's
    truncated episode, its return as the JAX package's."""
    case, jtr, jst2, m_j, ttr, tst2, m_t, _ = updated
    np.testing.assert_allclose(tst2.ep_stats.returns.numpy(), np.asarray(jst2.ep_stats.returns),
                               atol=1e-5)
    assert int(tst2.ep_stats.count) == int(jst2.ep_stats.count) == N
    assert tst2.global_step == int(jst2.global_step) == N * STEPS
    assert float(m_t["ep_len_mean"]) == STEPS
    assert float(m_t["grad_norm"]) > 0 and np.isfinite(float(m_t["grad_norm"]))
    carried = [tst2.obs[k] for k in tst2.obs] + [
        t for t in tst2.env_state.dyn if isinstance(t, torch.Tensor)]
    assert not any(t.requires_grad for t in carried)
    if ttr.recurrent:
        np.testing.assert_array_equal(tst2.hidden.numpy(), 0.0)  # zeroed by the done step
        assert not tst2.hidden.requires_grad


def test_truncation_bootstrap_moves_the_values():
    """With the bootstrap off, the same rollout and draws give other value
    targets: the γ·V(terminal observation) term is live."""
    losses = []
    for bootstrap in (True, False):
        tr = PPO(tenvs.HoverEnv(device="cpu", **ENV), n_steps=STEPS, n_epochs=1,
                 policy_kwargs=FLAT, bootstrap_truncated=bootstrap)
        st = tr.init(torch.Generator().manual_seed(0))
        noise = torch.randn((STEPS, N, 4), generator=torch.Generator().manual_seed(1))
        _, m = tr.update(st, noise, torch.arange(N * STEPS)[None])
        losses.append(float(m["value_loss"]))
    assert abs(losses[0] - losses[1]) > 1e-6


# ---------------------------------------------------------------------------
# the port on its own
# ---------------------------------------------------------------------------


def small_ppo(env=None, **kw):
    env = env or tenvs.HoverEnv(device="cpu", **ENV)
    kw.setdefault("n_steps", 4)
    kw.setdefault("n_epochs", 2)
    kw.setdefault("policy_kwargs", FLAT)
    return PPO(env, **kw)


def test_visual_update_renders_twice_a_step():
    """On a visual env PPO switches the env to ``terminal_obs_in_info``: a
    render before the auto-reset and one after it, each step."""
    env = tenvs.NavigationEnv(
        num_agent_per_scene=4, visual=True, device="cpu", max_episode_steps=256,
        scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": 16},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 16]}],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 2.0, 1.0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate",
                         "ctrl_delay": True})
    tr = small_ppo(env, n_steps=3, batch_size=6, policy_kwargs={
        "net_arch": {"depth": {"cnn": 16}, "state": {"mlp": [16]}, "target": {"mlp": [8]}},
        "pi_layers": (16,), "vf_layers": (16,)})
    assert env.terminal_obs_in_info
    st = tr.init(torch.Generator().manual_seed(0))
    renders = []
    render = env.sensor_observations
    env.sensor_observations = lambda s: renders.append(1) or render(s)
    conv = tr.policy.extractor.extractors["depth_extractor"].conv[0].weight
    before = conv.detach().clone()
    st, m = tr.update(st)
    assert len(renders) == 2 * 3
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    assert tr.n_minibatches == 2 and not torch.equal(conv.detach(), before)
    assert st.obs["depth"].shape == (4, 1, 16, 16)


def test_predict_hooks_and_evaluate():
    for pk in (FLAT, RECURRENT):
        tr = small_ppo(policy_kwargs=pk)
        st = tr.init(torch.Generator().manual_seed(1))
        st, _ = tr.update(st)
        a = tr.predict(st, st.obs)
        assert a.shape == (N, 4) and float(a.abs().max()) <= 1.0 and not a.requires_grad
        carry = tr.init_predict_carry(st.obs)
        a2, carry2 = tr.predict_step(st, st.obs, carry)
        if tr.recurrent:
            assert carry.shape == (N, 16) and float(carry2.abs().max()) > 0
            assert float(tr.mask_predict_carry(carry2, torch.ones(N, dtype=torch.bool))
                         .abs().max()) == 0
        else:
            assert carry == () and torch.equal(a2, a)
        stats = tr.evaluate(st, max_steps=4)
        assert np.isfinite(stats["eval/ep_rew_mean"])


def test_learn_rotates_scenes():
    """``scene_freq`` regenerates the procedural scene between updates and
    respawns the agents in it."""
    env = tenvs.NavigationEnv(
        num_agent_per_scene=4, visual=True, device="cpu",
        scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": 8},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 16]}],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 2.0, 1.0]}}]}})
    tr = small_ppo(env, n_steps=2, n_epochs=1, scene_freq=1, policy_kwargs={
        "net_arch": {"depth": {"cnn": 8}, "state": {"mlp": [8]}, "target": {"mlp": [8]}},
        "pi_layers": (8,), "vf_layers": (8,)})
    boxes = env.scene.boxes.clone()
    st = tr.learn(total_timesteps=3 * 2 * 4, log_interval=0)
    assert st.global_step == 3 * 2 * 4
    assert env.scene_kwargs["seed"] == 42 + 2  # rotated before updates 2 and 3
    assert not torch.equal(env.scene.boxes, boxes)


def test_minibatch_layout():
    """The JAX trainer's minibatch arithmetic: a batch larger than the
    rollout is one minibatch of the whole rollout; recurrent minibatches are
    whole agents' sequences, a divisor of the agent count."""
    assert small_ppo(n_steps=256, batch_size=25600).n_minibatches == 1
    tr = small_ppo(n_steps=4, batch_size=12)
    assert (tr.n_minibatches, tr.batch_size) == (2, 12)
    tr = small_ppo(n_steps=4, batch_size=12, policy_kwargs=RECURRENT)
    assert (tr.n_minibatches, tr.batch_size) == (N // 2, 8)
    tr = small_ppo(n_steps=4, batch_size=0, policy_kwargs=RECURRENT)
    assert (tr.n_minibatches, tr.batch_size) == (1, 4 * N)


def test_trainer_surface(tmp_path):
    """The JAX package's names; the policy follows the env's device; the
    checkpoint and the logger, once unported, work; ``train`` (the runner's
    eval flow) is taken and misspelt keywords are not."""
    assert ALGO_ALIASES["ppo"] is PPO and set(ALGO_ALIASES) == {"bptt", "shac", "ppo", "sac",
                                                                 "apg"}
    tr = small_ppo()
    st = tr.init()
    assert isinstance(st, PPOState) and st.opt_state is tr.optimizer
    assert all(p.device.type == "cpu" for p in tr.policy.parameters())
    assert all(st.params[n] is p for n, p in tr.policy.named_parameters())
    path = tr.save(st, str(tmp_path / "x"))
    st2 = tr.load(st, path)
    assert all(st2.params[n] is p for n, p in tr.policy.named_parameters())
    assert st2.opt_state is tr.optimizer and st2.global_step == st.global_step
    tr.make_logger(str(tmp_path / "logs"), formats=("csv",)).close()
    assert PPO(tr.env, train=False).n_steps == 256
    with pytest.raises(TypeError, match="n_step"):
        PPO(tr.env, n_step=8)


def test_chip_smoke_runs_the_published_configs():
    """The settings ``chip_smoke.py`` writes out for its training paths equal
    the YAML files it names: path G's env and PPO recipe, paths H-J's
    algorithm sections and SAC's env overrides."""
    import os

    import yaml

    import chip_smoke

    exps = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "visfly_tpu", "exps")

    def load(*parts):
        with open(os.path.join(exps, *parts)) as f:
            return yaml.safe_load(f)

    assert chip_smoke.CLUTTERED_FLIGHT == load("env_cfgs", "cluttered_flight.yaml")["env"]
    assert chip_smoke.PPO_TUNED == load("alg_cfgs", "cluttered_flight",
                                        "PPO_tuned.yaml")["algorithm"]
    assert chip_smoke.SHAC_NAV2 == load("alg_cfgs", "navigation2", "SHAC.yaml")["algorithm"]
    assert chip_smoke.APG_NAV2 == load("alg_cfgs", "navigation2", "APG.yaml")["algorithm"]
    sac = load("alg_cfgs", "navigation2", "SAC.yaml")
    assert chip_smoke.SAC_NAV2 == sac["algorithm"] and chip_smoke.SAC_NAV2_ENV == sac["env"]
    # and the trainers take them as they stand
    tr = PPO(tenvs.HoverEnv(device="cpu", **ENV), **chip_smoke.PPO_TUNED)
    assert (tr.n_steps, tr.n_epochs, tr.n_minibatches) == (256, 10, 1)
