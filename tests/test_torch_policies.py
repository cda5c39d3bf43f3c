"""The port's policy networks (``visfly_tpu_torch/policies``) against the flax
modules of ``visfly_tpu/policies``.

Each flax module is initialised from a PRNG key, its parameters cross over as
numpy arrays (``interop.actor_params_from_flax`` for the actors, the loaders it
is built from for a single module), and both sides map the same numpy-seeded
inputs: outputs within 1e-5. The stochastic branch gets the noise the JAX
module draws from its key, handed to the port as ``noise``; the
log-probability is held to 1e-4 on samples whose squashed action stays inside
±0.999 (past that, ``log(1 − a² + 1e-6)`` amplifies the last ulp of ``tanh``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.policies import extractors as jx
from visfly_tpu.policies import networks as jn
from visfly_tpu_torch import policies as tp
from visfly_tpu_torch.interop import (
    _load_cnn,
    _load_gru,
    _load_mlp,
    actor_params_from_flax,
    policy_params_from_flax,
)
from visfly_tpu_torch.policies import extractors as tx
from visfly_tpu_torch.policies import networks as tn

torch.set_num_threads(1)

TOL = 1e-5
KEY = jax.random.PRNGKey(0)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randn(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=tol, rtol=0)


def close_log_prob(lp_t, lp_j, action):
    inside = (action.detach().abs().amax(-1) < 0.999).numpy()
    assert inside.sum() >= 3
    close(lp_t[inside], np.asarray(lp_j)[inside], 1e-4)
    close(lp_t, lp_j, 5e-2)


def obs_batch(n=5, res=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"state": rng.normal(size=(n, 13)).astype(np.float32),
            "depth": rng.uniform(0, 1, size=(n, 1, res, res)).astype(np.float32),
            "collision_vector": rng.normal(size=(n, 3)).astype(np.float32)}


def both(obs):
    return {k: jnp.asarray(v) for k, v in obs.items()}, {k: torch.from_numpy(v)
                                                         for k, v in obs.items()}


def shapes(obs):
    return {k: v.shape[1:] for k, v in obs.items()}


# ---------------------------------------------------------------------------
# extractors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"layer_norm": True}, {"squash_output": True}, {"layer_norm": True, "squash_output": True},
    {"activation": "tanh"}, {"activation": "gelu"}, {"activation": "leakyrelu"},
    {"activation": "elu"}, {"activation": "silu"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()) or "plain")
def test_mlp_matches_flax(kw):
    x = randn(7, 11)
    jm = jx.MLP((24, 16, 8), **kw)
    params = to_numpy(jm.init(KEY, jnp.asarray(x)))["params"]
    tm = tx.MLP(11, (24, 16, 8), **kw)
    with torch.no_grad():
        _load_mlp(tm, params)
    close(tm(torch.from_numpy(x)), jm.apply({"params": params}, jnp.asarray(x)))
    assert tm.out_features == 8


@pytest.mark.parametrize("shape,kw", [
    ((1, 16, 16), {}),  # NCHW, even: flax's SAME pads 0 before and 1 after
    ((1, 15, 17), {}),  # odd sizes pad 1 and 1
    ((3, 16, 12), {"channels": (8, 16)}),
    ((16, 16, 3), {}),  # NHWC in
    ((16, 16), {"out_features": 32, "kernel": 5, "activation": "elu"}),  # no channel axis
], ids=["nchw-even", "nchw-odd", "rgb", "nhwc", "hw-k5"])
def test_image_cnn_matches_flax(shape, kw):
    x = randn(4, *shape, seed=1)
    jm = jx.ImageCNN(**kw)
    params = to_numpy(jm.init(KEY, jnp.asarray(x)))["params"]
    tm = tx.ImageCNN(shape, **kw)
    with torch.no_grad():
        _load_cnn(tm, params)
    out = tm(torch.from_numpy(x))
    close(out, jm.apply({"params": params}, jnp.asarray(x)))
    assert tuple(out.shape) == (4, kw.get("out_features", 128))


def test_same_padding_is_not_symmetric():
    """The case that separates flax's ``SAME`` from ``Conv2d(padding=1)``."""
    assert tx._same_pad(16, 3, 2) == (0, 1)
    assert tx._same_pad(15, 3, 2) == (1, 1)
    assert tx._same_pad(16, 5, 2) == (1, 2)


def test_gru_cell_matches_flax():
    x, h = randn(6, 10, seed=2), randn(6, 12, seed=3)
    jm = jx.GRUCell(hidden_dim=12)
    params = to_numpy(jm.init(KEY, jnp.asarray(x), jnp.asarray(h)))["params"]
    tm = tx.GRUCell(10, 12)
    with torch.no_grad():
        _load_gru(tm, params["GRUCell_0"])
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(h))
    got = tm(torch.from_numpy(x), torch.from_numpy(h))
    close(got, want)
    # two steps: the update is h' = (1 − z)·n + z·h on both sides
    close(tm(torch.from_numpy(x), got), jm.apply({"params": params}, jnp.asarray(x), want))
    # the four biases flax has, and no others
    assert sorted(n for n, _ in tm.named_parameters() if n.endswith("bias")) == [
        "hn.bias", "x_proj.bias"]


@pytest.mark.parametrize("case", ["arch", "defaults", "five_d", "layer_norm"])
def test_multi_input_extractor_matches_flax(case):
    obs = obs_batch()
    arch, kw = None, {}
    if case == "arch":
        arch = {"depth": {"cnn": 32}, "state": {"mlp": [32]}, "collision_vector": {"mlp": [16]}}
    elif case == "five_d":  # two images a sample share the CNN; a key without a default
        obs["depth"] = np.random.default_rng(4).uniform(0, 20, (5, 2, 1, 16, 16)).astype(np.float32)
        obs["gate"] = randn(5, 2, 3, seed=5)
        arch = {"depth": {"cnn": 24}}
    elif case == "layer_norm":
        kw = {"layer_norm": True, "activation": "tanh"}
    jobs, tobs = both(obs)
    jm = jx.MultiInputExtractor(arch, **kw)
    params = to_numpy(jm.init(KEY, jobs))["params"]
    tm = tx.MultiInputExtractor(shapes(obs), arch, **kw)
    with torch.no_grad():
        for name, sub in tm.extractors.items():
            (_load_cnn if isinstance(sub, tx.ImageCNN) else _load_mlp)(sub, params[name])
    want = jm.apply({"params": params}, jobs)
    got = tm(tobs)
    close(got, want)
    assert got.shape[1] == tm.out_features == want.shape[1]
    assert tm.keys == sorted(obs)
    with pytest.raises(KeyError, match="observation keys"):
        tm({k: v for k, v in tobs.items() if k != "state"})


def test_tables_and_aliases_equal_the_jax_package():
    assert tx.DEFAULT_KEY_EXTRACTORS == jx.DEFAULT_KEY_EXTRACTORS
    assert tx.EXTRACTOR_ALIASES == jx.EXTRACTOR_ALIASES
    assert sorted(tx.ACTIVATIONS) == sorted(jx.ACTIVATIONS)
    assert tp.resolve_extractor("StateExtractor") == jx.resolve_extractor("StateExtractor")
    assert tp.resolve_extractor({"state": {"mlp": [8]}}) == {"state": {"mlp": [8]}}
    assert tp.resolve_activation(torch.tanh) is torch.tanh
    assert (tp.LOG_STD_MIN, tp.LOG_STD_MAX) == (jn.LOG_STD_MIN, jn.LOG_STD_MAX)
    from visfly_tpu.policies.common import INITIALIZERS as jax_inits
    from visfly_tpu_torch.policies.common import INITIALIZERS

    assert set(jax_inits) <= set(INITIALIZERS)


@pytest.mark.parametrize("name,kw,std", [
    ("lecun_normal", {}, (1 / 256) ** 0.5), ("kaiming", {}, (2 / 256) ** 0.5),
    ("xavier", {}, (2 / (256 + 128)) ** 0.5), ("normal", {"stddev": 0.02}, 0.02),
    ("kaiming_uniform", {}, (2 / 256) ** 0.5), ("xavier_uniform", {}, (2 / 384) ** 0.5),
    ("orthogonal", {"scale": 2.0}, 2.0 / 256 ** 0.5), ("zeros", {}, 0.0),
])
def test_initializers_have_the_jax_variance(name, kw, std):
    w = torch.empty(128, 256)  # (out, in)
    tp.get_initializer(name, **kw)(w, generator=torch.Generator().manual_seed(0))
    assert float(w.std()) == pytest.approx(std, rel=0.03, abs=1e-12)
    if name == "orthogonal":
        torch.testing.assert_close(w @ w.T, 4.0 * torch.eye(128), atol=1e-4, rtol=0)


def test_unported_extractors_raise():
    """The extractors once unported (Queue A item 14) build; an unknown
    backbone name raises KeyError, as in the JAX package."""
    with pytest.raises(KeyError):
        tx.MultiInputExtractor({"depth": (1, 16, 16)}, {"depth": {"backbone": "resnet19"}})
    ext = tx.MultiInputExtractor({"depth": (1, 16, 16)}, {"depth": {"backbone": "resnet18"}})
    assert ext.out_features == 512
    ext = tx.MultiInputExtractor({"depth": (1, 16, 16)}, {"depth": {"resnet": 64}})
    assert ext({"depth": torch.zeros(2, 1, 16, 16)}).shape == (2, 64)
    net = tx.TransCNN(8, (4,), output_channel=1)
    assert net(torch.zeros(2, 8, 5, 5)).shape == (2, 1, 23, 23)
    dec = tx.DecoderHead(16, (1, 32, 32), channels=(8, 4))
    assert dec(torch.zeros(3, 16)).shape == (3, 1, 32, 32)


# ---------------------------------------------------------------------------
# actors
# ---------------------------------------------------------------------------

ARCH = {"depth": {"cnn": 32}, "state": {"mlp": [32]}, "collision_vector": {"mlp": [16]}}


@pytest.mark.parametrize("kw", [
    {"net_arch": ARCH, "latent_dim": (32,)},
    {"latent_dim": (24, 24), "layer_norm": True, "activation": "tanh"},
], ids=["visual", "layer_norm"])
def test_actor_matches_flax(kw):
    obs = obs_batch()
    if "net_arch" not in kw:
        obs = {"state": obs["state"]}
    jobs, tobs = both(obs)
    jm = jn.Actor(action_dim=4, **kw)
    params = to_numpy(jm.init(KEY, jobs))
    tm = actor_params_from_flax(params, tn.Actor(shapes(obs), 4, **kw))
    a_j, lp_j = jm.apply(params, jobs, None, True)
    a_t, lp_t = tm(tobs, deterministic=True)
    close(a_t, a_j)
    assert lp_j is None and lp_t is None
    a_none, _ = tm(tobs)  # neither generator nor noise: the squashed mean
    assert torch.equal(a_none, a_t)

    k = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(k, (5, 4)))
    a_j, lp_j = jm.apply(params, jobs, k)
    a_t, lp_t = tm(tobs, noise=torch.from_numpy(noise))
    close(a_t, a_j)
    close_log_prob(lp_t, lp_j, a_t)
    assert float(a_t.abs().max()) <= 1.0 and not torch.equal(a_t, a_none)


def test_actor_gradients_match_flax():
    """∂ Σ action / ∂ parameters through the extractor, CNN included."""
    obs = obs_batch(n=3)
    jobs, tobs = both(obs)
    kw = {"net_arch": ARCH, "latent_dim": (32,)}
    jm = jn.Actor(action_dim=4, **kw)
    params = jm.init(KEY, jobs)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (3, 4)))
    grads = jax.grad(lambda p: jnp.sum(jm.apply(p, jobs, jax.random.PRNGKey(3))[0]))(params)
    tm = actor_params_from_flax(to_numpy(params), tn.Actor(shapes(obs), 4, **kw))
    tm(tobs, noise=torch.from_numpy(noise))[0].sum().backward()
    twin = actor_params_from_flax(to_numpy(grads), tn.Actor(shapes(obs), 4, **kw))
    for (name, p), g in zip(tm.named_parameters(), twin.parameters()):
        scale = float(g.abs().max())
        np.testing.assert_allclose(p.grad.numpy(), g.detach().numpy(), atol=1e-4 * scale + 1e-7,
                                   rtol=0, err_msg=name)


def test_recurrent_actor_matches_flax():
    obs = obs_batch()
    jobs, tobs = both(obs)
    kw = dict(hidden_dim=12, net_arch=ARCH, latent_dim=(16,))
    jm = jn.RecurrentActor(action_dim=4, **kw)
    h0 = randn(5, 12, seed=9) * 0.3
    params = to_numpy(jm.init(KEY, jobs, jnp.asarray(h0)))
    tm = actor_params_from_flax(params, tn.RecurrentActor(shapes(obs), 4, **kw))
    assert tuple(tm.initial_hidden(5).shape) == (5, 12) and not tm.initial_hidden(5).any()
    a_j, _, h_j = jm.apply(params, jobs, jnp.asarray(h0), None, True)
    a_t, lp, h_t = tm(tobs, torch.from_numpy(h0), deterministic=True)
    close(a_t, a_j)
    close(h_t, h_j)
    assert lp is None
    k = jax.random.PRNGKey(11)
    noise = np.asarray(jax.random.normal(k, (5, 4)))
    a_j, lp_j, h_j2 = jm.apply(params, jobs, h_j, k)
    a_t, lp_t, h_t2 = tm(tobs, h_t, noise=torch.from_numpy(noise))
    close(a_t, a_j)
    close_log_prob(lp_t, lp_j, a_t)
    close(h_t2, h_j2)


# ---------------------------------------------------------------------------
# critics and the actor-critic policies
# ---------------------------------------------------------------------------

CRITICS = {
    "qcritic": ("QCritic", {"n_critics": 2, "net_arch": ARCH, "latent_dim": (24, 24)}),
    "qcritic_ln": ("QCritic", {"n_critics": 3, "latent_dim": (16,), "layer_norm": True,
                               "activation": "tanh"}),
    "state_critic": ("StateCritic", {"n_critics": 3, "net_arch": ARCH, "latent_dim": (32,)}),
    "actor_critic": ("ActorCriticPolicy", {"net_arch": ARCH, "pi_layers": (16, 16),
                                           "vf_layers": (24,)}),
    "recurrent_actor_critic": ("RecurrentActorCriticPolicy", {
        "hidden_dim": 12, "net_arch": ARCH, "pi_layers": (16,), "vf_layers": (8,)}),
}


def _call(module, cls, obs, action, h0):
    """The module's outputs as a tuple, in both packages' argument order."""
    if cls == "QCritic":
        return (module(obs, action),)
    if cls == "RecurrentActorCriticPolicy":
        return tuple(module(obs, h0))
    return tuple(module(obs)) if cls == "ActorCriticPolicy" else (module(obs),)


@pytest.mark.parametrize("case", list(CRITICS))
def test_critics_and_policies_match_flax(case):
    """Each critic and actor-critic policy, its flax parameters carried over
    by ``policy_params_from_flax``: outputs within 1e-5, and ∂ Σ outputs /
    ∂ parameters within 1e-4 of each parameter's largest gradient entry."""
    cls, kw = CRITICS[case]
    obs = obs_batch()
    if "net_arch" not in kw:
        obs = {"state": obs["state"]}
    jobs, tobs = both(obs)
    action, h0 = randn(5, 4, seed=4), randn(5, 12, seed=5) * 0.3
    ja, jh = jnp.asarray(action), jnp.asarray(h0)
    ta, th = torch.from_numpy(action), torch.from_numpy(h0)
    jkw = dict(kw)
    tkw = dict(kw)
    if cls in ("ActorCriticPolicy", "RecurrentActorCriticPolicy"):
        jkw["action_dim"] = 4
        tkw["action_dim"] = 4
    elif cls == "QCritic":
        tkw["action_dim"] = 4
    jm = getattr(jn, cls)(**jkw)
    args = {"QCritic": (jobs, ja), "RecurrentActorCriticPolicy": (jobs, jh)}.get(cls, (jobs,))
    params = jm.init(KEY, *args)
    if cls in ("ActorCriticPolicy", "RecurrentActorCriticPolicy"):
        # a log-std away from its zero start, so that its copy is checked
        params = {"params": {**params["params"],
                             "log_std": jnp.asarray([0.1, -0.2, 0.3, -0.4])}}
    tm = policy_params_from_flax(to_numpy(params), getattr(tn, cls)(shapes(obs), **tkw))

    def total(p):
        out = jm.apply(p, *args)
        return sum(jnp.sum(jnp.sin(o)) for o in (out if isinstance(out, tuple) else (out,)))

    outs_j = jm.apply(params, *args)
    outs_j = outs_j if isinstance(outs_j, tuple) else (outs_j,)
    outs_t = _call(tm, cls, tobs, ta, th)
    assert len(outs_j) == len(outs_t)
    for o_t, o_j in zip(outs_t, outs_j):
        assert tuple(o_t.shape) == tuple(o_j.shape)
        close(o_t, o_j)
    if cls in ("QCritic", "StateCritic"):  # independent heads
        assert not np.allclose(outs_t[0][:, 0].detach().numpy(), outs_t[0][:, 1].detach().numpy())
    sum(torch.sin(o).sum() for o in outs_t).backward()
    grads = jax.grad(total)(params)
    twin = policy_params_from_flax(to_numpy(grads), getattr(tn, cls)(shapes(obs), **tkw))
    for (name, p), g in zip(tm.named_parameters(), twin.parameters()):
        scale = float(g.abs().max())
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), g.detach().numpy(), atol=1e-4 * scale + 1e-7,
                                   rtol=0, err_msg=name)


def test_policy_params_from_flax_rejects_other_modules():
    with pytest.raises(TypeError, match="no flax counterpart"):
        policy_params_from_flax({"params": {"extractor": {}}},
                                tx.MultiInputExtractor({"state": (13,)}))


def test_sample_from_a_generator_is_reproducible():
    obs = {"state": torch.from_numpy(randn(6, 13))}
    actor = tn.Actor({"state": (13,)}, 4, latent_dim=(16,),
                     generator=torch.Generator().manual_seed(0))
    a1, lp1 = actor(obs, torch.Generator().manual_seed(5))
    a2, lp2 = actor(obs, torch.Generator().manual_seed(5))
    a3, _ = actor(obs, torch.Generator().manual_seed(6))
    assert torch.equal(a1, a2) and torch.equal(lp1, lp2) and not torch.equal(a1, a3)
    assert bool(torch.isfinite(lp1).all()) and float(a1.abs().max()) <= 1.0
    # the same seed builds the same policy
    twin = tn.Actor({"state": (13,)}, 4, latent_dim=(16,),
                    generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(actor.parameters(), twin.parameters()))
    assert all(float(p.abs().max()) == 0 for n, p in actor.named_parameters() if "bias" in n)


def test_gaussian_helpers_match_jax():
    mean, log_std, action = randn(5, 4, seed=1), randn(5, 4, seed=2) * 0.5, randn(5, 4, seed=3)
    close(tp.gaussian_log_prob(*(torch.from_numpy(x) for x in (mean, log_std, action))),
          jn.gaussian_log_prob(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(action)))
    close(tp.gaussian_entropy(torch.from_numpy(log_std)),
          jn.gaussian_entropy(jnp.asarray(log_std)))


def test_building_a_policy_turns_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tn.Actor({"state": (13,)}, 4, latent_dim=(8,))
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
