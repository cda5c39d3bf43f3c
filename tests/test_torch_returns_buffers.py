"""The port's return recursions, replay buffer and PPO episode window
(``visfly_tpu_torch/algos/returns.py``, ``buffers.py``, ``ppo.py``'s
``EpisodeStats``) against ``visfly_tpu/algos``.

The same numpy-seeded inputs go through both packages. The recursions agree
within 1e-6, absolute below 1 and relative above it (64 float32 steps reach
returns near 10, where one float32 ulp is 9.5e-7 and XLA's fused
multiply-adds round differently from PyTorch's separate ones); the buffer's contents and the rows sampled with the same indices
(drawn by the JAX buffer's own ``randint``) are bit-equal; the episode window
is equal to the JAX ring, overflow included.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.algos import buffers as jbuf
from visfly_tpu.algos import ppo as jppo
from visfly_tpu.algos import returns as jret
from visfly_tpu_torch.algos import buffers as tbuf
from visfly_tpu_torch.algos import ppo as tppo
from visfly_tpu_torch.algos import returns as tret
from visfly_tpu_torch.interop import buffer_from_numpy, episode_stats_from_numpy

torch.set_num_threads(1)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rollout_arrays(h, n, seed, p_done=0.15):
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(h, n)).astype(np.float32)
    done = rng.uniform(size=(h, n)) < p_done
    ep_done = done & (rng.uniform(size=(h, n)) < 0.5)
    nv = rng.normal(size=(h, n)).astype(np.float32)
    return r, done, ep_done, nv


@pytest.mark.parametrize("h,n,seed,gamma,lam", [
    (16, 5, 0, 0.99, 0.95), (32, 7, 1, 0.97, 0.9), (1, 3, 2, 0.99, 0.95), (24, 4, 3, 0.9, 0.5),
])
def test_td_returns_match_jax(h, n, seed, gamma, lam):
    r, done, ep_done, nv = rollout_arrays(h, n, seed)
    want = jret.compute_td_returns(jnp.asarray(r), jnp.asarray(done), jnp.asarray(nv),
                                   jnp.asarray(ep_done), gamma=gamma, lam=lam)
    got = tret.compute_td_returns(torch.from_numpy(r), torch.from_numpy(done),
                                  torch.from_numpy(nv), torch.from_numpy(ep_done), gamma=gamma,
                                  lam=lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("h,n,seed,p_done", [(8, 3, 1, 0.2), (64, 6, 4, 0.05), (5, 9, 5, 0.6)])
def test_gae_matches_jax(h, n, seed, p_done):
    r, done, _, v = rollout_arrays(h, n, seed, p_done)
    last_v = np.random.default_rng(seed + 100).normal(size=(n,)).astype(np.float32)
    a_j, ret_j = jret.compute_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(done),
                                  jnp.asarray(last_v), jnp.asarray(done[-1]), gamma=0.99,
                                  gae_lambda=0.95)
    a_t, ret_t = tret.compute_gae(torch.from_numpy(r), torch.from_numpy(v),
                                  torch.from_numpy(done), torch.from_numpy(last_v),
                                  torch.from_numpy(done[-1]), gamma=0.99, gae_lambda=0.95)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(ret_t.numpy(), np.asarray(ret_j), atol=1e-6, rtol=1e-6)


def transitions(n, seed):
    rng = np.random.default_rng(seed)
    obs = {"state": rng.normal(size=(n, 13)).astype(np.float32),
           "depth": rng.uniform(size=(n, 1, 4, 4)).astype(np.float32)}
    nxt = {k: (v + 1.0).astype(np.float32) for k, v in obs.items()}
    return (obs, nxt, rng.normal(size=(n, 4)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32), rng.uniform(size=n) < 0.3,
            rng.normal(size=(n, 22)).astype(np.float32))


def assert_buffers_equal(tb, jb):
    jb = to_numpy(jb)
    for k in jb.obs:
        np.testing.assert_array_equal(tb.obs[k].numpy(), jb.obs[k])
        np.testing.assert_array_equal(tb.next_obs[k].numpy(), jb.next_obs[k])
    for f in ("actions", "rewards", "dones", "full_states"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), getattr(jb, f))
    assert tb.pos == int(jb.pos) and tb.full == bool(jb.full)


@pytest.mark.parametrize("capacity,n,inserts", [(20, 6, 2), (20, 6, 5), (16, 8, 2)],
                         ids=["partial", "wrapped", "exactly_full"])
def test_buffer_insert_and_sample_match_jax(capacity, n, inserts):
    """Insert ``inserts`` batches of ``n`` into both rings, then sample with
    the JAX buffer's indices: every stored and sampled row bit-equal."""
    example = transitions(n, 0)[0]
    jb = jbuf.create(capacity, {k: jnp.asarray(v) for k, v in example.items()}, 4,
                     store_full_state=True)
    tb = tbuf.create(capacity, {k: torch.from_numpy(v) for k, v in example.items()}, 4,
                     store_full_state=True)
    for i in range(inserts):
        obs, nxt, act, rew, done, full = transitions(n, i + 1)
        jb = jbuf.insert(jb, {k: jnp.asarray(v) for k, v in obs.items()},
                         {k: jnp.asarray(v) for k, v in nxt.items()}, jnp.asarray(act),
                         jnp.asarray(rew), jnp.asarray(done), jnp.asarray(full))
        tb = tbuf.insert(tb, {k: torch.from_numpy(v) for k, v in obs.items()},
                         {k: torch.from_numpy(v) for k, v in nxt.items()},
                         torch.from_numpy(act), torch.from_numpy(rew), torch.from_numpy(done),
                         torch.from_numpy(full))
        assert_buffers_equal(tb, jb)
        assert tbuf.size(tb) == int(jbuf.size(jb))
    key = jax.random.PRNGKey(3)
    upper = jnp.where(jb.full, capacity, jb.pos)
    idx = np.asarray(jax.random.randint(key, (32,), 0, jnp.maximum(upper, 1)))
    want = to_numpy(jbuf.sample(jb, key, 32))
    got = tbuf.sample(tb, None, 32, idx=torch.from_numpy(idx).long())
    for g, w in zip(got[:2], want[:2]):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), w)
    # the carrier gives the same ring, and draws stay inside the filled rows
    assert_buffers_equal(buffer_from_numpy(to_numpy(jb)), jb)
    gen = torch.Generator().manual_seed(0)
    rows = tbuf.sample_indices(tb, gen, 4096)
    assert int(rows.min()) >= 0 and int(rows.max()) < tbuf.size(tb)
    assert len(torch.unique(rows)) == tbuf.size(tb)
    states = tbuf.sample_full_states(tb, gen, 7)
    assert tuple(states.shape) == (7, 22)
    assert all(bool((tb.full_states == s).all(-1).any()) for s in states)


def test_empty_buffer_samples_row_zero():
    tb = tbuf.create(8, {"state": torch.zeros(2, 3)}, 4)
    assert tbuf.size(tb) == 0 and tb.full_states == ()
    idx = tbuf.sample_indices(tb, torch.Generator().manual_seed(1), 5)
    assert idx.tolist() == [0] * 5


def push_both(jst, tst, done, ret, length, succ):
    jst = jppo.push_episode_stats(jst, jnp.asarray(done), jnp.asarray(ret), jnp.asarray(length),
                                  jnp.asarray(succ))
    tst = tppo.push_episode_stats(tst, torch.from_numpy(done), torch.from_numpy(ret),
                                  torch.from_numpy(length), torch.from_numpy(succ))
    return jst, tst


def assert_stats_equal(tst, jst):
    for f in tppo.EpisodeStats._fields:
        np.testing.assert_array_equal(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                      err_msg=f)
    for a, b in zip(tppo.episode_stats_means(tst), jppo.episode_stats_means(jst)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_episode_stats_window_matches_jax():
    """The JAX oracle's deque semantics: running means over the last ≤ 100
    completed episodes, the ring wrapping as it fills."""
    jst, tst = jppo.init_episode_stats(), tppo.init_episode_stats()
    jst, tst = push_both(jst, tst, np.asarray([True, False, True]),
                         np.asarray([2.0, 9.0, 4.0], np.float32), np.asarray([10, 99, 30]),
                         np.asarray([True, False, False]))
    r, l, s = tppo.episode_stats_means(tst)
    assert int(tst.count) == 2 and float(r) == 3.0 and float(l) == 20.0 and float(s) == 0.5
    assert_stats_equal(tst, jst)
    rng = np.random.default_rng(0)
    for v in range(60):
        done = rng.uniform(size=7) < 0.4
        jst, tst = push_both(jst, tst, done, np.full(7, float(v), np.float32),
                             rng.integers(1, 50, size=7), rng.uniform(size=7) < 0.5)
        assert_stats_equal(tst, jst)
    assert int(tst.count) == tppo.EP_WINDOW
    assert_stats_equal(episode_stats_from_numpy(to_numpy(jst)), jst)


def test_episode_stats_overflow_matches_jax():
    """More than ``EP_WINDOW`` simultaneous finishes keep exactly the last
    ``EP_WINDOW`` episodes."""
    n = 2 * tppo.EP_WINDOW + 56
    ret = np.arange(n, dtype=np.float32)
    jst, tst = push_both(jppo.init_episode_stats(), tppo.init_episode_stats(),
                         np.ones(n, bool), ret, ret, ret)
    assert_stats_equal(tst, jst)
    np.testing.assert_array_equal(np.sort(tst.returns.numpy()),
                                  np.arange(n - tppo.EP_WINDOW, n, dtype=np.float32))
    # and a second overflow from a ring that does not start at slot 0
    jst, tst = push_both(jst, tst, np.ones(n, bool), ret + 1000, ret, ret)
    jst, tst = push_both(jst, tst, np.asarray([True] * 3 + [False] * 4), ret[:7], ret[:7],
                         ret[:7])
    assert_stats_equal(tst, jst)
