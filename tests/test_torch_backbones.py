"""The port's torchvision-layout backbones (``visfly_tpu_torch/policies/
torch_backbones.py``, ``compact_backbones.py``) and the ``backbone`` branch
of its extractor against the flax modules of ``visfly_tpu/policies``.

Inputs come from numpy seeds. The flax modules' parameters cross over with
``interop.module_params_from_flax``; the backbones besides load a random
torchvision-layout state dict through the port's own loaders, and both are
held to the JAX forward of the same state dict through the JAX converters:
atol 2e-4 / rtol 1e-3 (``tests/test_aux_subsystems.py``'s limits for
full-width backbones).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.policies import compact_backbones as jcb
from visfly_tpu.policies import extractors as jx
from visfly_tpu.policies import torch_backbones as jtb
from visfly_tpu_torch.interop import module_params_from_flax
from visfly_tpu_torch.policies import compact_backbones as tcb
from visfly_tpu_torch.policies import extractors as tx
from visfly_tpu_torch.policies import networks as tn
from visfly_tpu_torch.policies import torch_backbones as ttb

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
# torchvision-layout state dicts from a numpy seed
# ---------------------------------------------------------------------------


class _SD:
    def __init__(self, seed, gain=1.0):
        self.rng = np.random.default_rng(seed)
        self.gain = gain
        self.sd = {}

    def conv(self, name, *shape):
        # fan-in-normalised weights keep activations O(1) through deep trunks
        self.sd[name] = torch.from_numpy((self.rng.normal(size=shape) * self.gain
                                          / np.sqrt(np.prod(shape[1:]))).astype(np.float32))

    def vec(self, name, c, scale=0.1, offset=0.0):
        self.sd[name] = torch.from_numpy(
            (self.rng.normal(size=c) * scale + offset).astype(np.float32))

    def bn(self, prefix, c):
        self.vec(f"{prefix}.weight", c, offset=1.0)
        self.vec(f"{prefix}.bias", c)
        self.vec(f"{prefix}.running_mean", c)
        self.sd[f"{prefix}.running_var"] = torch.from_numpy(
            (np.abs(self.rng.normal(size=c)) * 0.1 + 0.5).astype(np.float32))

    def cbn(self, conv, bn, *shape):
        self.conv(f"{conv}.weight", *shape)
        self.bn(bn, shape[0])


def resnet_sd(arch, seed=0):
    s = _SD(seed)
    s.cbn("conv1", "bn1", 64, 3, 7, 7)
    bottleneck = arch in jtb.BOTTLENECK_ARCHS
    exp = jtb.BOTTLENECK_EXPANSION if bottleneck else 1
    cin = 64
    for stage, blocks in enumerate(jtb.ARCH_STAGES[arch]):
        c = 64 * 2 ** stage
        for b in range(blocks):
            tp = f"layer{stage + 1}.{b}"
            if bottleneck:
                s.cbn(f"{tp}.conv1", f"{tp}.bn1", c, cin, 1, 1)
                s.cbn(f"{tp}.conv2", f"{tp}.bn2", c, c, 3, 3)
                s.cbn(f"{tp}.conv3", f"{tp}.bn3", c * exp, c, 1, 1)
            else:
                s.cbn(f"{tp}.conv1", f"{tp}.bn1", c, cin, 3, 3)
                s.cbn(f"{tp}.conv2", f"{tp}.bn2", c, c, 3, 3)
            stride = 2 if (b == 0 and stage > 0) else 1
            if stride != 1 or cin != c * exp:
                s.cbn(f"{tp}.downsample.0", f"{tp}.downsample.1", c * exp, cin, 1, 1)
            cin = c * exp
    return s.sd


def mobilenet_sd(arch, seed=0):
    s = _SD(seed)
    cfg = jcb.MOBILENET_V3[arch]
    s.cbn("features.0.0", "features.0.1", cfg["stem"], 3, 3, 3)
    cin = cfg["stem"]
    for i, (k, exp, out, use_se, _a, _s) in enumerate(cfg["blocks"]):
        f, j = f"features.{i + 1}.block", 0
        if exp != cin:
            s.cbn(f"{f}.{j}.0", f"{f}.{j}.1", exp, cin, 1, 1)
            j += 1
        s.cbn(f"{f}.{j}.0", f"{f}.{j}.1", exp, 1, k, k)
        j += 1
        if use_se:
            sq = jcb._make_divisible(exp // 4)
            s.conv(f"{f}.{j}.fc1.weight", sq, exp, 1, 1)
            s.vec(f"{f}.{j}.fc1.bias", sq)
            s.conv(f"{f}.{j}.fc2.weight", exp, sq, 1, 1)
            s.vec(f"{f}.{j}.fc2.bias", exp)
            j += 1
        s.cbn(f"{f}.{j}.0", f"{f}.{j}.1", out, exp, 1, 1)
        cin = out
    nf = len(cfg["blocks"]) + 1
    s.cbn(f"features.{nf}.0", f"features.{nf}.1", cfg["head"], cin, 1, 1)
    return s.sd


def efficientnet_sd(arch, seed=0):
    # 40-odd residual blocks: a gain of 0.5 keeps the features O(1), so that
    # the comparison tests the graph and not float32 accumulation order
    s = _SD(seed, gain=0.5)
    cfg = jcb.EFFICIENTNET_V2[arch]
    s.cbn("features.0.0", "features.0.1", cfg["stem"], 3, 3, 3)
    cin = cfg["stem"]
    for si, (btype, e, k, _s0, out, layers) in enumerate(cfg["stages"]):
        for li in range(layers):
            f = f"features.{si + 1}.{li}.block"
            if btype == "fused" and e == 1:
                s.cbn(f"{f}.0.0", f"{f}.0.1", out, cin, k, k)
            elif btype == "fused":
                s.cbn(f"{f}.0.0", f"{f}.0.1", cin * e, cin, k, k)
                s.cbn(f"{f}.1.0", f"{f}.1.1", out, cin * e, 1, 1)
            else:
                exp, sq = cin * e, max(1, cin // 4)
                s.cbn(f"{f}.0.0", f"{f}.0.1", exp, cin, 1, 1)
                s.cbn(f"{f}.1.0", f"{f}.1.1", exp, 1, k, k)
                s.conv(f"{f}.2.fc1.weight", sq, exp, 1, 1)
                s.vec(f"{f}.2.fc1.bias", sq)
                s.conv(f"{f}.2.fc2.weight", exp, sq, 1, 1)
                s.vec(f"{f}.2.fc2.bias", exp)
                s.cbn(f"{f}.3.0", f"{f}.3.1", out, exp, 1, 1)
            cin = out
    nf = len(cfg["stages"]) + 1
    s.cbn(f"features.{nf}.0", f"features.{nf}.1", cfg["head"], cin, 1, 1)
    return s.sd


# name → (torchvision state dict, JAX module and converter, port module and converter)
def _resnet(arch):
    return (lambda: resnet_sd(arch), lambda: jtb.TorchResNet(arch=arch),
            lambda sd: jtb.convert_torch_resnet(sd, arch), lambda: ttb.TorchResNet(arch),
            lambda sd: ttb.convert_torch_resnet(sd, arch))


def _compact(name):
    cls, kw = jcb.COMPACT_BACKBONES[name]
    tcls, tkw = tcb.COMPACT_BACKBONES[name]
    if cls is jcb.MobileNetV3:
        make, jconv, tconv = mobilenet_sd, jcb.convert_torch_mobilenet_v3, \
            tcb.convert_torch_mobilenet_v3
    else:
        make, jconv, tconv = efficientnet_sd, jcb.convert_torch_efficientnet_v2, \
            tcb.convert_torch_efficientnet_v2
    return (lambda: make(kw["arch"]), lambda: cls(**kw),
            lambda sd: jconv({k: v.numpy() for k, v in sd.items()}, kw["arch"]),
            lambda: tcls(**tkw), lambda sd: tconv(sd, tkw["arch"]))


BACKBONES = {
    "resnet18": _resnet("resnet18"), "resnet34": _resnet("resnet34"),
    "resnet50": _resnet("resnet50"), "resnet101": _resnet("resnet101"),
    **{k: _compact(k) for k in jcb.COMPACT_BACKBONES},
}
WIDTH = {"resnet18": 512, "resnet34": 512, "resnet50": 2048, "resnet101": 2048,
         "mobilenet_s": 576, "mobilenet_l": 960, "efficientnet_s": 1280,
         "efficientnet_m": 1280, "efficientnet_l": 1280}


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "mobilenet_s", "efficientnet_s"])
def test_backbone_full_width_forward_matches_jax(name):
    make_sd, jmod, jconv, tmod, tconv = BACKBONES[name]
    sd = make_sd()
    params = jconv(sd)
    x = np.random.default_rng(1).normal(size=(2, 3, 32, 32)).astype(np.float32)
    want = np.asarray(jax.jit(jmod().apply)({"params": params}, jnp.asarray(x)))
    assert want.shape == (2, WIDTH[name])
    # the port's own loader of the torchvision layout
    net = tmod()
    net.load_state_dict(tconv(sd))
    xt = torch.from_numpy(x)
    close(net(xt), want, atol=2e-4, rtol=1e-3)
    # depth is tiled to three channels, as the JAX module tiles it
    d = xt[:, :1]
    assert torch.equal(net(d), net(d.expand(-1, 3, -1, -1)))
    # the JAX parameters through interop
    module_params_from_flax(to_numpy(params), net)
    close(net(xt), want, atol=2e-4, rtol=1e-3)


def _port_name(path):
    """A flax parameter path → the port's state-dict key."""
    *mods, leaf = path
    parts = []
    for m in mods:
        head, _, tail = m.partition("_")
        parts += [head, tail] if head.startswith("layer") and tail.isdigit() else [m]
    return ".".join(parts + ["weight" if leaf == "kernel" else "bias"])


@pytest.mark.parametrize("name", ["resnet34", "resnet101", "mobilenet_l", "efficientnet_m",
                                  "efficientnet_l"])
def test_backbone_parameter_shapes_match_jax(name):
    _, jmod, _, tmod, _ = BACKBONES[name]
    shapes = jax.eval_shape(jmod().init, KEY, jnp.zeros((1, 3, 32, 32)))["params"]
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    with torch.device("meta"):  # shapes only
        net = tmod()
    own = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert len(flat) == len(own)
    for path, leaf in flat:
        key = _port_name([p.key for p in path])
        shape = leaf.shape
        want = (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else shape
        assert own[key] == tuple(want), key
    assert net.out_features == WIDTH[name]
    assert net(torch.zeros(1, 1, 32, 32, device="meta")).shape == (1, WIDTH[name])


def test_unknown_backbone_raises_key_error():
    with pytest.raises(KeyError):
        jx.MultiInputExtractor(net_arch={"depth": {"backbone": "vgg16"}}).init(
            KEY, {"depth": jnp.zeros((1, 1, 32, 32))})
    with pytest.raises(KeyError):
        tx.MultiInputExtractor({"depth": (1, 32, 32)}, {"depth": {"backbone": "vgg16"}})


def test_apply_pretrained_swaps_the_folded_weights():
    sd = resnet_sd("resnet18", seed=3)
    arch = {"depth": {"backbone": "resnet18", "out": 16}, "state": {"mlp": [8]}}
    actor = tn.Actor({"depth": (1, 16, 16), "state": (13,)}, net_arch=arch, latent_dim=(16,),
                     generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in actor.state_dict().items()}
    ttb.apply_pretrained(actor, {"depth_extractor": sd})
    after = actor.state_dict()
    folded = ttb.convert_torch_resnet(sd)
    for k, v in folded.items():
        torch.testing.assert_close(after[f"extractor.extractors.depth_extractor.{k}"], v,
                                   atol=0, rtol=0)
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert moved and all(".depth_extractor." in k for k in moved)
    # the same swap on the JAX side gives the same forward
    jext = jx.MultiInputExtractor(net_arch=arch)
    obs = {"depth": images(2, 1, 16, 16), "state": np.zeros((2, 13), np.float32)}
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    params = jax.jit(jext.init)(KEY, jobs)["params"]
    params = jtb.apply_pretrained(params, {"depth_extractor": sd})
    port = tx.MultiInputExtractor({"depth": (1, 16, 16), "state": (13,)}, arch)
    ttb.apply_pretrained(port, {"depth_extractor": sd})
    port.extractors["depth_proj"].load_state_dict({
        "weight": torch.from_numpy(np.array(params["depth_proj"]["kernel"]).T),
        "bias": torch.from_numpy(np.array(params["depth_proj"]["bias"]))})
    module_params_from_flax(to_numpy(params["state_extractor"]),
                            port.extractors["state_extractor"])
    want = jax.jit(jext.apply)({"params": params}, jobs)
    close(port({k: torch.from_numpy(v) for k, v in obs.items()}), want, atol=2e-4, rtol=1e-3)
    with pytest.raises(KeyError):
        ttb.apply_pretrained(actor, {"color_extractor": sd})
    with pytest.raises(ValueError, match="mismatch|counterpart"):
        ttb.apply_pretrained(actor, {"depth_extractor": resnet_sd("resnet50")}, "resnet50")
