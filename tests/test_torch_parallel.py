"""Data parallelism over the agent axis (``visfly_tpu_torch/parallel``) on the
CPU: two gloo ranks, each a process with the agents of its block, against
one process with all of them, as ``tests/test_multichip.py`` holds the JAX
package's sharded programs to its unsharded ones.

Every rank draws what the one process draws (spawns, clocks, action noise,
permutations) and slices it, so the sharded updates compute the same
numbers up to float reassociation: losses within 1e-5 relative, parameters
within 1e-4 in the l2 norm, positions within 1e-5. Each group of processes
has its own time limit.
"""
import numpy as np
import pytest
import torch

from visfly_tpu_torch.algos import BPTT, PPO, SHAC
from visfly_tpu_torch.envs import HoverEnv, MultiNavigationEnv, NavigationEnv
from visfly_tpu_torch.parallel import (
    Mesh,
    dryrun_multichip,
    make_mesh,
    make_rank_env,
    run_ranks,
    shard_batch_pytree,
    shard_train_state,
)

torch.set_num_threads(1)

RANKS = 2
N = 16  # agents of the whole batch
LIMIT = 300.0  # seconds a group of processes may take
DYN = {"dt": 0.02, "ctrl_dt": 0.02, "action_type": "bodyrate"}


def hover(**kw):
    return dict(visual=False, dynamics_kwargs=DYN, max_episode_steps=16, device="cpu", **kw)


def visual_nav(**kw):
    return dict(visual=True, device="cpu",
                scene_kwargs={"path": "garage_simple_l_medium",
                              "scene_gen_kwargs": {"n_obstacles": 4}},
                sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 16]}],
                random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                    {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 1.0, 0.5]}}]}},
                dynamics_kwargs=dict(DYN, dt=0.03, ctrl_dt=0.03), max_episode_steps=16, **kw)


def flat_params(module):
    return torch.cat([p.detach().flatten() for p in module.parameters()])


def l2_rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# what one update sequence gives, on one process or on a rank
def bptt_result(env, n_updates, seed, horizon, mesh=None):
    tr = BPTT(env, horizon=horizon, seed=seed, policy_kwargs={"latent_dim": (16, 16)})
    st = tr.init()
    if mesh is not None:
        st = shard_train_state(st, mesh, tr)
    for _ in range(n_updates):
        st, m = tr.update(st)
    return {"loss": float(m["actor_loss"]), "params": flat_params(tr.actor),
            "pos": st.env_state.dyn.pos.detach().clone()}


def _bptt_rank(mesh, n_updates, seed, horizon, visual):
    if visual:
        env = make_rank_env(NavigationEnv, mesh, N // 2, num_scene=2, requires_grad=True,
                            **visual_nav())
    else:
        env = make_rank_env(HoverEnv, mesh, N, requires_grad=True, **hover())
    return bptt_result(env, n_updates, seed, horizon, mesh)


def _check(single, ranks, tol_loss=1e-5):
    assert abs(ranks[0]["loss"] - single["loss"]) <= tol_loss * abs(single["loss"]), (
        ranks[0]["loss"], single["loss"])
    for r in ranks:
        assert r["loss"] == ranks[0]["loss"]
        assert torch.equal(r["params"], ranks[0]["params"])
    assert l2_rel(ranks[0]["params"], single["params"]) <= 1e-4


def test_bptt_sharded_matches_unsharded():
    single = bptt_result(HoverEnv(num_agent_per_scene=N, requires_grad=True, **hover()), 3, 7, 4)
    ranks = run_ranks(_bptt_rank, RANKS, 3, 7, 4, False, timeout=LIMIT)
    _check(single, ranks)
    pos = torch.cat([r["pos"] for r in ranks])
    torch.testing.assert_close(pos, single["pos"], atol=1e-5, rtol=0)


def test_bptt_sharded_multiscene_visual_env():
    """Two scenes, each rank owns one: the scene's preset seed follows it,
    the spawn rejection tests each rank's own agents in its own scene."""
    env = NavigationEnv(num_agent_per_scene=N // 2, num_scene=2, requires_grad=True,
                        **visual_nav())
    single = bptt_result(env, 1, 11, 3)
    ranks = run_ranks(_bptt_rank, RANKS, 1, 11, 3, True, timeout=LIMIT)
    _check(single, ranks)
    pos = torch.cat([r["pos"] for r in ranks])
    torch.testing.assert_close(pos, single["pos"], atol=1e-5, rtol=0)


PPO_CASES = {"one minibatch": dict(batch_size=0), "four, target_kl": dict(batch_size=32,
                                                                         target_kl=0.02)}


def ppo_result(env, kw, mesh=None):
    tr = PPO(env, n_steps=8, n_epochs=2, seed=3,
             policy_kwargs={"pi_layers": (32, 32), "vf_layers": (32, 32)}, **kw)
    st = tr.init()
    if mesh is not None:
        st = shard_train_state(st, mesh, tr)
    for _ in range(2):  # the second ends every episode: a truncation bootstrap
        st, m = tr.update(st)
    out = {k: float(v) for k, v in m.items()}
    out.update(params=flat_params(tr.policy), pos=st.env_state.dyn.pos.clone())
    return out


def _ppo_rank(mesh, case):
    return ppo_result(make_rank_env(HoverEnv, mesh, N, **hover()), PPO_CASES[case], mesh)


@pytest.mark.parametrize("case", list(PPO_CASES))
def test_ppo_sharded_update_matches_unsharded(case):
    single = ppo_result(HoverEnv(num_agent_per_scene=N, **hover()), PPO_CASES[case])
    ranks = run_ranks(_ppo_rank, RANKS, case, timeout=LIMIT)
    for k in ("loss", "ep_rew_mean", "reward_mean", "approx_kl", "update_fraction",
              "grad_norm", "ep_len_mean"):
        assert np.isclose(ranks[0][k], single[k], rtol=1e-5, atol=1e-6), (k, ranks[0][k],
                                                                           single[k])
        assert ranks[1][k] == ranks[0][k], k
    assert single["ep_len_mean"] == 16.0
    _check(single, ranks)


def test_dryrun_multichip():
    outs = dryrun_multichip(RANKS, device="cpu", timeout=LIMIT)
    assert len(outs) == RANKS and all(o["visual"]["grad_norm"] > 0 for o in outs)
    assert all(o["shac"]["grad_norm"] > 0 for o in outs)


def test_ownership_rules_and_refusals(tmp_path):
    mesh = Mesh(1, RANKS, "gloo", torch.device("cpu"))  # rules only: no group joined
    env = make_rank_env(HoverEnv, mesh, N, **hover())
    assert env.num_agent == N // 2 and env.global_rows == (N // 2, N, N)
    env = make_rank_env(NavigationEnv, mesh, 4, num_scene=4, **visual_nav())
    assert env.num_scene == 2 and env.global_rows == (8, 16, 16)
    assert env.scene_kwargs["seed"] == 42 + 2  # scenes 2 and 3 of the presets
    assert env.scene_kwargs["scenes_of"] == (2, 4)  # a rotation moves on by 4 scenes
    with pytest.raises(ValueError, match="evenly"):
        make_rank_env(NavigationEnv, mesh, 4, num_scene=3, **visual_nav())
    with pytest.raises(ValueError, match="whole scenes"):
        make_rank_env(NavigationEnv, mesh._replace(size=4), 4, num_scene=2, **visual_nav())
    with pytest.raises(ValueError, match="couples"):
        make_rank_env(MultiNavigationEnv, mesh, 4, device="cpu")
    with pytest.raises(ValueError, match="evenly"):
        make_rank_env(HoverEnv, mesh, 5, **hover())
    # every trainer is accepted (SHAC and the recurrent PPO once were refused):
    # on a group of one rank, its parameters broadcast and its mesh set
    one = make_mesh(1, 0, f"file://{tmp_path / 'store'}", "gloo")
    try:
        shac = SHAC(HoverEnv(num_agent_per_scene=4, requires_grad=True, **hover()), horizon=2)
        rppo = PPO(HoverEnv(num_agent_per_scene=4, **hover()), n_steps=4,
                   policy_kwargs={"recurrent": True})
        for tr in (shac, rppo):
            st = tr.init()
            assert shard_train_state(st, one, tr) is st and tr.mesh is one
    finally:
        torch.distributed.destroy_process_group()

    class Other:  # a trainer shard_train_state does not know
        env = make_rank_env(HoverEnv, mesh, N, **hover())

    with pytest.raises(TypeError, match="Other"):
        shard_train_state(None, mesh, Other())
    with pytest.raises(ValueError, match="make_rank_env"):
        shard_train_state(None, mesh, BPTT(HoverEnv(num_agent_per_scene=4, **hover())))
    with pytest.raises(ValueError, match="make_rank_env"):
        shard_train_state(None, mesh, SHAC(HoverEnv(num_agent_per_scene=4, **hover())))
    # the first axis of the batch's length is cut to the rank's block
    tree = {"a": torch.arange(N * 3).reshape(N, 3), "b": torch.zeros(5, N), "c": (1, "x")}
    part = shard_batch_pytree(tree, mesh, N)
    assert torch.equal(part["a"], tree["a"][N // 2:]) and part["b"].shape == (5, N // 2)
    assert part["c"] == (1, "x")
