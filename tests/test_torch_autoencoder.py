"""The port's depth autoencoder (``visfly_tpu_torch/policies/autoencoder.py``)
against ``visfly_tpu/policies/autoencoder.py``.

The flax parameters cross over with ``interop.autoencoder_params_from_flax``:
forwards within 1e-5. Training: the JAX trainer's initial parameters and
batch indices (replayed from its seed) go to the port's trainer, ``batch_idx``;
after three Adam steps the losses agree within 1e-5 and the parameters within
1e-4 in the l2 norm.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from visfly_tpu.policies import autoencoder as jae
from visfly_tpu_torch.envs import HoverEnv, NavigationEnv
from visfly_tpu_torch.interop import autoencoder_params_from_flax
from visfly_tpu_torch.policies import autoencoder as tae

torch.set_num_threads(1)

LATENT, HW, BATCH = 8, (16, 16), 16


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def frames(m=64, seed=0):
    return np.random.default_rng(seed).uniform(size=(m, 1, *HW)).astype(np.float32)


def ported(params):
    return autoencoder_params_from_flax(to_numpy(params), tae.DepthAutoencoder(LATENT, HW))


def test_forward_matches_jax():
    x = frames(4)
    model = jae.DepthAutoencoder(LATENT, HW)
    params = model.init(jax.random.PRNGKey(3), jnp.asarray(x))
    net = ported(params)
    xt = torch.from_numpy(x)
    recon, z = net(xt), net.encode(xt)
    assert tuple(recon.shape) == (4, 1, *HW) and tuple(z.shape) == (4, LATENT)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(model.apply(params, x)),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(z.detach().numpy(),
                               np.asarray(model.apply(params, x, method=model.encode)),
                               atol=1e-5, rtol=0)


def _l2_rel(a: torch.nn.Module, b: torch.nn.Module) -> float:
    va = torch.cat([p.detach().flatten() for p in a.parameters()])
    vb = torch.cat([p.detach().flatten() for p in b.parameters()])
    return float(torch.linalg.vector_norm(va - vb) / torch.linalg.vector_norm(vb))


def test_three_training_steps_match_jax():
    x = frames()
    n_steps, seed = 3, 0
    # JAX's own trainer
    _, jparams = jae.train_autoencoder(jnp.asarray(x), latent_dim=LATENT, batch_size=BATCH,
                                       n_steps=n_steps, seed=seed, log_interval=0)
    # its initial parameters, indices and per-step losses, replayed from the seed
    model = jae.DepthAutoencoder(LATENT, HW)
    key = jax.random.PRNGKey(seed)
    p = model.init(key, jnp.asarray(x[:2]))
    tx = optax.adam(1e-3)
    opt = tx.init(p)
    idx, losses = [], []
    net = ported(p)
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        i = jax.random.randint(k, (BATCH,), 0, x.shape[0])
        idx.append(np.asarray(i))
        batch = jnp.asarray(x)[i]
        loss, g = jax.value_and_grad(lambda q: jnp.mean((model.apply(q, batch) - batch) ** 2))(p)
        upd, opt = tx.update(g, opt, p)
        p = optax.apply_updates(p, upd)
        losses.append(float(loss))
    for a, b in zip(jax.tree_util.tree_leaves(p), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=0)

    net, t_losses = tae.train_autoencoder(torch.from_numpy(x), LATENT, BATCH, n_steps,
                                          log_interval=0, model=net,
                                          batch_idx=torch.as_tensor(np.stack(idx)))
    np.testing.assert_allclose(t_losses, losses, atol=1e-5, rtol=0)
    assert _l2_rel(net, ported(jparams)) <= 1e-4


def test_trainer_draws_its_own_batches():
    """``test_autoencoder_trains`` on the port: 30 steps from a seed, the
    reconstruction and latent shapes, the loss falling."""
    x = torch.from_numpy(frames())
    model, losses = tae.train_autoencoder(x, latent_dim=LATENT, batch_size=BATCH, n_steps=30,
                                          log_interval=0)
    assert tuple(model(x[:4]).shape) == (4, 1, *HW)
    assert tuple(model.encode(x[:4]).shape) == (4, LATENT)
    assert len(losses) == 30 and np.mean(losses[-5:]) < np.mean(losses[:5])
    again, losses2 = tae.train_autoencoder(x, latent_dim=LATENT, batch_size=BATCH, n_steps=3,
                                           log_interval=0)
    assert losses2 == losses[:3]


def test_collect_depth_frames():
    env = NavigationEnv(
        num_agent_per_scene=4, visual=True, device="cpu",
        scene_kwargs={"path": "garage_simple_l_medium"},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 16]}],
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})
    out = tae.collect_depth_frames(env, 10, torch.Generator().manual_seed(0))
    assert tuple(out.shape) == (10, 1, 16, 16) and out.dtype == torch.float32
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0 and float(out.std()) > 0
    with pytest.raises(ValueError, match="no depth sensor"):
        tae.collect_depth_frames(HoverEnv(num_agent_per_scene=2, device="cpu"), 4)
