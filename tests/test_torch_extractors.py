"""The port's small image modules and extractor branches
(``visfly_tpu_torch/policies/extractors.py``: ``ResNetCNN``, ``TransCNN``,
``required_input_shape``, ``DecoderHead``, the ``resnet`` and ``backbone``
branches of ``MultiInputExtractor``) against the flax modules of
``visfly_tpu/policies/extractors.py``.

Inputs come from numpy seeds and the flax parameters cross over with
``interop``: outputs within 1e-5 (2e-4 / 1e-3 relative through a
full-width backbone).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.policies import extractors as jx
from visfly_tpu.policies import networks as jn
from visfly_tpu_torch.interop import actor_params_from_flax, module_params_from_flax
from visfly_tpu_torch.policies import extractors as tx
from visfly_tpu_torch.policies import networks as tn

torch.set_num_threads(1)

TOL = 1e-5
KEY = jax.random.PRNGKey(0)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(a, b, atol=TOL, rtol=0.0):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=atol, rtol=rtol)


def images(n, c, h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, size=(n, c, h, w)).astype(np.float32)


# ---------------------------------------------------------------------------
# the small modules: ResNetCNN, TransCNN, DecoderHead
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 16, 16), (3, 12, 20)])
def test_resnet_cnn_matches_jax(shape):
    x = images(2, *shape, seed=4)
    mod = jx.ResNetCNN(out_features=24)
    params = jax.jit(mod.init)(KEY, jnp.asarray(x))
    net = module_params_from_flax(to_numpy(params), tx.ResNetCNN(shape, 24))
    close(net(torch.from_numpy(x)), jax.jit(mod.apply)(params, jnp.asarray(x)))


@pytest.mark.parametrize("layer_norm", [False, True])
def test_trans_cnn_shape_semantics_and_values(layer_norm):
    kw = dict(channels=(8, 4), kernel_sizes=(3, 4, 3), strides=(2, 2, 1),
              paddings=(1, 1, 1), output_paddings=(1, 0, 0), output_channel=1,
              layer_norm=layer_norm)
    mod = jx.TransCNN(**kw)
    net = tx.TransCNN(3, **kw)
    cfgs = net.layer_cfgs()
    assert cfgs == mod.layer_cfgs()
    x = np.random.default_rng(5).normal(size=(2, 5, 7, 3)).astype(np.float32)  # NHWC
    params = mod.init(KEY, jnp.asarray(x))
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    h, w = 5, 7
    for _, k, s, p, op in cfgs:
        h, w = (h - 1) * s + k - 2 * p + op, (w - 1) * s + k - 2 * p + op
    assert want.shape == (2, h, w, 1)
    module_params_from_flax(to_numpy(params), net)
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 1, h, w)
    close(got.permute(0, 2, 3, 1), want)
    assert tx.required_input_shape(cfgs, (h, w)) == (5, 7) == jx.required_input_shape(
        cfgs, (h, w))
    with pytest.raises(ValueError, match="too large"):
        tx.TransCNN(3, (4,), kernel_sizes=3, paddings=3)


def test_decoder_head_matches_jax():
    dec = jx.DecoderHead(target_shape=(1, 64, 64), channels=(32, 16), kernel_sizes=4,
                         strides=2, paddings=1)
    z = np.random.default_rng(6).normal(size=(3, 32)).astype(np.float32)
    params = dec.init(jax.random.PRNGKey(1), jnp.asarray(z))
    want = dec.apply(params, jnp.asarray(z))
    net = module_params_from_flax(to_numpy(params), tx.DecoderHead(
        32, (1, 64, 64), channels=(32, 16), kernel_sizes=4, strides=2, paddings=1))
    zt = torch.from_numpy(z)
    img = net(zt)
    assert tuple(img.shape) == (3, 1, 64, 64)
    close(img, want)
    img.sum().backward()
    gn = sum(float(p.grad.abs().sum()) for p in net.parameters())
    assert np.isfinite(gn) and gn > 0


# ---------------------------------------------------------------------------
# the new branches inside MultiInputExtractor and an Actor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [{"resnet": 16}, {"backbone": "resnet18", "out": 16},
                                  {"backbone": "resnet18"}])
def test_new_branches_in_actor_match_jax(spec):
    arch = {"depth": spec, "state": {"mlp": [16]}}
    obs = {"depth": images(2, 1, 16, 16, seed=7),
           "state": np.random.default_rng(8).normal(size=(2, 13)).astype(np.float32)}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    actor = jn.Actor(net_arch=arch, latent_dim=(16,))
    params = jax.jit(actor.init)(KEY, jobs)
    mean = jax.jit(lambda p, o: actor.apply(p, o, None, True)[0])(params, jobs)
    port = actor_params_from_flax(to_numpy(params), tn.Actor(
        {"depth": (1, 16, 16), "state": (13,)}, net_arch=arch, latent_dim=(16,)))
    atol, rtol = (TOL, 0.0) if "resnet" in spec else (2e-4, 1e-3)
    close(port({k: torch.from_numpy(v) for k, v in obs.items()}, deterministic=True)[0], mean,
          atol, rtol)
    ext = port.extractor
    width = {"resnet": 16}.get(next(iter(spec)), spec.get("out") or 512)
    assert ext.out_features == width + 16
    assert ("depth_proj" in ext.extractors) == bool(spec.get("out"))
