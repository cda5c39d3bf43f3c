"""Multi-input feature extractors (counterpart of
``visfly_tpu/policies/extractors.py``, the part the BPTT trainer needs).

A dict observation is routed through per-key sub-extractors (an MLP for
vectors, a CNN for images) whose features are concatenated on the last
dimension, keys in sorted order. Images arrive NCHW, as the envs hand them
out; the JAX package computes in NHWC, so its ``proj`` kernel sees the
flattened features in (H, W, C) order and ``interop.actor_params_from_flax``
permutes it to this module's (C, H, W).

torch modules know their input sizes when they are built, so every module
here takes the shape of its input (without the batch dimension) where flax
infers it at the first call.

Besides ``mlp`` and ``cnn``, a key's spec may be ``{"resnet": n}`` (the
small GroupNorm ResNet, ``ResNetCNN``) or ``{"backbone": name, "out": n}``
(a torchvision-layout backbone, ``torch_backbones.py`` and
``compact_backbones.py``, with an optional ``<key>_proj`` Dense + ReLU to
``n``). ``TransCNN`` and ``DecoderHead`` map features back to images; they
take and give NCHW, where the JAX ``TransCNN`` takes NHWC.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .common import get_initializer, lecun_normal
from .compact_backbones import COMPACT_BACKBONES
from .torch_backbones import TorchResNet

ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "leakyrelu": F.leaky_relu,  # slope 0.01 in both packages
    "tanh": torch.tanh,
    "elu": F.elu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's default is the tanh form
}
_LN_EPS = 1e-6  # flax's LayerNorm epsilon


def resolve_activation(act) -> Callable:
    if callable(act):
        return act
    return ACTIVATIONS[str(act).lower()]


def _init_layer(layer: nn.Module, generator=None, kernel_init: Callable = lecun_normal):
    kernel_init(layer.weight, generator=generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)
    return layer


class MLP(nn.Module):
    """Dense stack: optional layer norm, configurable activation, optional
    squashed output. ``dense[i]`` is the JAX module's ``dense_i``, ``norm[i]``
    its i-th ``LayerNorm``."""

    def __init__(self, in_features: int, features: Sequence[int], activation: Any = "relu",
                 layer_norm: bool = False, squash_output: bool = False, generator=None):
        super().__init__()
        self.act = resolve_activation(activation)
        self.squash_output = squash_output
        sizes = [int(in_features), *(int(f) for f in features)]
        self.dense = nn.ModuleList(_init_layer(nn.Linear(a, b), generator)
                                   for a, b in zip(sizes[:-1], sizes[1:]))
        # the squashed last layer has neither norm nor activation
        n_act = len(features) - (1 if squash_output else 0)
        self.norm = nn.ModuleList(nn.LayerNorm(f, eps=_LN_EPS) for f in features[:n_act]
                                  ) if layer_norm else None
        self.out_features = sizes[-1]

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for i, dense in enumerate(self.dense):
            h = dense(h)
            if i < len(self.dense) - 1 or not self.squash_output:
                if self.norm is not None:
                    h = self.norm[i](h)
                h = self.act(h)
        return torch.tanh(h) if self.squash_output else h


def _same_pad(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax's ``SAME`` padding of one axis: the output is ceil(size / stride)
    wide and the odd cell goes after. With stride 2, kernel 3 and an even
    size that is (0, 1), where ``Conv2d(padding=1)`` would pad (1, 1)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ImageCNN(nn.Module):
    """Compact CNN for 64×64-ish depth or RGB sensors: strided convolutions
    (stride 2, ``SAME`` padding, no pooling), then a dense projection to
    ``out_features``. ``in_shape`` is (C, H, W) or (H, W)."""

    def __init__(self, in_shape: Sequence[int], out_features: int = 128,
                 channels: Sequence[int] = (16, 32, 64), kernel: int = 3,
                 activation: Any = "relu", generator=None):
        super().__init__()
        self.act = resolve_activation(activation)
        self.kernel = int(kernel)
        c, h, w = _chw(tuple(in_shape))
        self.conv = nn.ModuleList()
        for out_c in channels:
            self.conv.append(_init_layer(nn.Conv2d(c, out_c, self.kernel, stride=2), generator))
            c, h, w = out_c, math.ceil(h / 2), math.ceil(w / 2)
        self.feat_shape = (c, h, w)  # of the last convolution's output, flattened in this order
        self.proj = _init_layer(nn.Linear(c * h * w, int(out_features)), generator)
        self.out_features = int(out_features)

    def forward(self, x: Tensor) -> Tensor:
        if x.dim() == 3:
            x = x[:, None]
        elif not (x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3)):
            x = x.permute(0, 3, 1, 2)  # NHWC in, as the JAX module also accepts
        h = x.to(self.proj.weight.dtype)
        for conv in self.conv:
            h = self.act(conv_same(conv, h))
        return self.act(self.proj(h.flatten(1)))


def _chw(shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(C, H, W) of an image shape (C, H, W), (H, W, C) or (H, W), by the rule
    ``ImageCNN.forward`` applies to a batch."""
    if len(shape) == 2:
        return (1, *shape)
    if shape[0] in (1, 3) and shape[-1] not in (1, 3):
        return shape
    return (shape[2], shape[0], shape[1])


def conv_same(conv: nn.Conv2d, x: Tensor) -> Tensor:
    """``conv`` (built without padding) with flax's ``SAME`` padding for its
    stride and kernel."""
    k, s = conv.kernel_size[0], conv.stride[0]
    ph, pw = _same_pad(x.shape[2], k, s), _same_pad(x.shape[3], k, s)
    return conv(F.pad(x, (*pw, *ph)))


class GroupNorm(nn.Module):
    """flax's ``GroupNorm``: contiguous channel groups, epsilon 1e-6 and the
    variance as E[x²] − E[x]² clamped at 0 (``use_fast_variance``); a scale
    and a bias per channel."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = int(num_groups), float(eps)
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: Tensor) -> Tensor:
        n, c = x.shape[:2]
        g = x.reshape(n, self.num_groups, x.shape[1:].numel() // self.num_groups)
        mean = g.mean(-1, keepdim=True)
        var = torch.clamp((g * g).mean(-1, keepdim=True) - mean * mean, min=0.0)
        g = (g - mean) * torch.rsqrt(var + self.eps)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return g.reshape(x.shape) * self.weight.reshape(shape) + self.bias.reshape(shape)


class ResNetBlock(nn.Module):
    """Basic residual block: conv3×3 (stride) → GroupNorm(8) → ReLU → conv3×3
    → GroupNorm(8), plus a strided 1×1 ``shortcut`` convolution where the
    block changes the shape, then ReLU. ``SAME`` padding throughout.
    ``in_shape`` is (C, H, W); ``out_shape`` is the block's."""

    def __init__(self, in_shape: Sequence[int], channels: int, strides: int = 1, generator=None):
        super().__init__()
        cin, h, w = (int(d) for d in in_shape)
        s = int(strides)
        self.conv1 = _init_layer(nn.Conv2d(cin, channels, 3, stride=s), generator)
        self.norm1 = GroupNorm(8, channels)
        self.conv2 = _init_layer(nn.Conv2d(channels, channels, 3), generator)
        self.norm2 = GroupNorm(8, channels)
        self.out_shape = (int(channels), math.ceil(h / s), math.ceil(w / s))
        self.shortcut = (_init_layer(nn.Conv2d(cin, channels, 1, stride=s), generator)
                         if (cin, h, w) != self.out_shape else None)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.norm1(conv_same(self.conv1, x)))
        h = self.norm2(conv_same(self.conv2, h))
        residual = x if self.shortcut is None else conv_same(self.shortcut, x)
        return F.relu(h + residual)


class ResNetCNN(nn.Module):
    """Small ResNet image extractor: a 5×5/2 ``stem`` convolution and ReLU,
    stages of ``ResNetBlock``s of ``width · 2^stage`` channels (each stage's
    first block strides 2), a global average pool and a Dense + ReLU
    ``proj`` to ``out_features``. ``in_shape`` is (C, H, W)."""

    def __init__(self, in_shape: Sequence[int], out_features: int = 128,
                 stage_sizes: Sequence[int] = (1, 1, 1, 1), width: int = 16, generator=None):
        super().__init__()
        c, h, w = _chw(tuple(in_shape))
        self.stem = _init_layer(nn.Conv2d(c, width, 5, stride=2), generator)
        shape = (width, math.ceil(h / 2), math.ceil(w / 2))
        self.blocks = nn.ModuleList()
        for stage, blocks in enumerate(stage_sizes):
            for b in range(blocks):
                block = ResNetBlock(shape, width * 2 ** stage, 2 if b == 0 else 1, generator)
                self.blocks.append(block)
                shape = block.out_shape
        self.proj = _init_layer(nn.Linear(shape[0], int(out_features)), generator)
        self.out_features = int(out_features)

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(conv_same(self.stem, x.to(self.proj.weight.dtype)))
        for block in self.blocks:
            h = block(h)
        return F.relu(self.proj(h.mean(dim=(2, 3))))


def conv_transpose(x: Tensor, layer: nn.ConvTranspose2d, lo: int, hi: int) -> Tensor:
    """flax's ``ConvTranspose`` (``transpose_kernel=False``) with the dilated
    input padded ``(lo, hi)``: torch's ``padding=p`` pads it ``k − 1 − p``
    and ``output_padding`` adds to the end, so ``p = k − 1 − lo`` and the
    difference ``hi − lo`` is added (or, negative, cropped). ``layer`` holds
    the flax kernel flipped in both spatial axes, laid out (in, out, kh, kw)."""
    k, s = layer.kernel_size[0], layer.stride[0]
    extra = hi - lo
    y = F.conv_transpose2d(x, layer.weight, layer.bias, stride=s, padding=k - 1 - lo,
                           output_padding=max(extra, 0))
    return y[..., :extra, :extra] if extra < 0 else y


class TransCNN(nn.Module):
    """Configurable transposed-conv stack with torch's output size per layer,
    ``out = (in − 1)·s + k − 2p + op``: ``deconv[i]`` is the JAX module's
    ``deconv_i``, ``norm[i]`` its i-th ``LayerNorm`` (over the channels).
    Input and output are NCHW; ``in_channels`` is the input's C."""

    def __init__(self, in_channels: int, channels: Sequence[int], kernel_sizes: Any = 3,
                 strides: Any = 2, paddings: Any = 0, output_paddings: Any = 0,
                 output_channel: Optional[int] = None, activation: Any = "relu",
                 layer_norm: bool = False, squash_output: bool = False, generator=None):
        super().__init__()
        self.act = resolve_activation(activation)
        self.squash_output = squash_output
        chans = list(channels) + ([] if output_channel is None else [output_channel])
        n = len(chans)
        per = [[v] * n if isinstance(v, int) else list(v)
               for v in (kernel_sizes, strides, paddings, output_paddings)]
        self.cfgs = list(zip(chans, *per))
        self.deconv = nn.ModuleList()
        cin = int(in_channels)
        for c, k, s, p, op in self.cfgs:
            if k - 1 - p < 0:
                raise ValueError(f"padding {p} too large for kernel {k}")
            self.deconv.append(_init_layer(nn.ConvTranspose2d(cin, c, k, stride=s), generator,
                                           _lecun_transposed))
            cin = c
        self.norm = nn.ModuleList(nn.LayerNorm(c, eps=_LN_EPS) for c in chans[:-1]
                                  ) if layer_norm else None

    def layer_cfgs(self) -> Sequence[Tuple[int, int, int, int, int]]:
        """(out_ch, k, s, p, op) per layer, the output layer included."""
        return list(self.cfgs)

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for i, ((_, k, s, p, op), layer) in enumerate(zip(self.cfgs, self.deconv)):
            h = conv_transpose(h, layer, k - 1 - p, k - 1 - p + op)
            if i < len(self.deconv) - 1:
                if self.norm is not None:
                    h = self.norm[i](h.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                h = self.act(h)
        return torch.tanh(h) if self.squash_output else h


def _lecun_transposed(w: Tensor, generator=None) -> Tensor:
    """lecun_normal of a transposed convolution's (in, out, kh, kw) weight
    with flax's fan-in, ``in · kh · kw``."""
    return lecun_normal(w.transpose(0, 1), generator=generator)


def required_input_shape(layer_cfgs, target_hw: Tuple[int, int]) -> Tuple[int, int]:
    """Invert a trans-CNN's size arithmetic: the (H, W) input that produces
    ``target_hw``, ``in = (out + 2p − k − op) // s + 1`` from the last layer
    back."""
    h, w = target_hw
    for _, k, s, p, op in reversed(list(layer_cfgs)):
        h = (h + 2 * p - k - op) // s + 1
        w = (w + 2 * p - k - op) // s + 1
        if h < 1 or w < 1:
            raise ValueError(f"target {target_hw} unreachable: need {h}x{w}")
    return h, w


class DecoderHead(nn.Module):
    """Feature vector → image: a Dense ``proj`` to the trans-CNN's required
    input, reshaped to (C0, H0, W0), then the ``TransCNN`` ``net`` → NCHW
    of ``target_shape`` (C, H, W). ``in_features`` is the feature width."""

    def __init__(self, in_features: int, target_shape: Tuple[int, int, int],
                 channels: Sequence[int] = (64, 32), kernel_sizes: Any = 4, strides: Any = 2,
                 paddings: Any = 1, activation: Any = "relu", generator=None):
        super().__init__()
        c, th, tw = (int(d) for d in target_shape)
        self.target_hw = (th, tw)
        self.net = TransCNN(channels[0], channels, kernel_sizes, strides, paddings,
                            output_channel=c, activation=activation, generator=generator)
        h0, w0 = required_input_shape(self.net.layer_cfgs(), (th, tw))
        self.in_shape = (int(channels[0]), h0, w0)
        self.proj = _init_layer(nn.Linear(int(in_features), math.prod(self.in_shape)), generator)

    def forward(self, z: Tensor) -> Tensor:
        img = self.net(self.proj(z).reshape(-1, *self.in_shape))
        if tuple(img.shape[2:]) != self.target_hw:
            raise ValueError(f"decoder produced {tuple(img.shape[2:])}, wanted {self.target_hw}")
        return img


class GRUCell(nn.Module):
    """Recurrent feature wrapper, called with (features (N, F), hidden
    (N, H)) → new hidden. The gates are flax's: biases on the input
    projections and on the candidate's hidden projection only,

        r = σ(W_ir x + b_ir + W_hr h)       z = σ(W_iz x + b_iz + W_hz h)
        n = tanh(W_in x + b_in + r · (W_hn h + b_hn))
        h' = (1 − z) · n + z · h

    (``torch.nn.GRUCell`` has two more biases, which an optimiser would
    train). ``x_proj`` stacks [ir | iz | in], ``h_proj`` [hr | hz]."""

    def __init__(self, in_features: int, hidden_dim: int = 128, generator=None):
        super().__init__()
        self.hidden_dim = int(hidden_dim)
        self.x_proj = nn.Linear(int(in_features), 3 * self.hidden_dim)
        self.h_proj = nn.Linear(self.hidden_dim, 2 * self.hidden_dim, bias=False)
        self.hn = nn.Linear(self.hidden_dim, self.hidden_dim)
        orthogonal = get_initializer("orthogonal")
        H = self.hidden_dim
        with torch.no_grad():
            for k in range(3):  # each gate's kernel on its own, as flax draws them
                lecun_normal(self.x_proj.weight[k * H:(k + 1) * H], generator=generator)
            for k in range(2):
                orthogonal(self.h_proj.weight[k * H:(k + 1) * H], generator=generator)
            orthogonal(self.hn.weight, generator=generator)
            nn.init.zeros_(self.x_proj.bias)
            nn.init.zeros_(self.hn.bias)

    def forward(self, x: Tensor, h: Tensor) -> Tensor:
        xr, xz, xn = self.x_proj(x).chunk(3, dim=-1)
        hr, hz = self.h_proj(h).chunk(2, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * self.hn(h))
        return (1.0 - z) * n + z * h


DEFAULT_KEY_EXTRACTORS = {
    # vector keys → identity-ish MLP; image keys → CNN
    "state": {"mlp": [128, 64]},
    "target": {"mlp": [64]},
    "collision_vector": {"mlp": [64]},
    "swarm": {"mlp": [128]},
    "depth": {"cnn": 128},
    "color": {"cnn": 128},
    "semantic": {"cnn": 128},
}


def backbone(name: str, generator=None) -> nn.Module:
    """The torchvision-layout backbone of an extractor's ``{"backbone":
    name}`` spec (resnet18/34/50/101, mobilenet_s/l, efficientnet_s/m/l); its
    ``out_features`` is the pooled width. An unknown name raises KeyError."""
    if name in COMPACT_BACKBONES:
        cls, kw = COMPACT_BACKBONES[name]
        return cls(generator=generator, **kw)
    return TorchResNet(name, generator=generator)


class MultiInputExtractor(nn.Module):
    """Dispatch per-key sub-extractors and concatenate their features, keys in
    sorted order.

    ``obs_shapes``: {obs_key: shape without the batch dimension};
    ``net_arch``: {obs_key: {"mlp": [sizes]} | {"cnn": out_features} |
    {"resnet": out_features} | {"backbone": name, "out": n}}. Keys
    present in the observation but absent from ``net_arch`` fall back to
    defaults (a CNN for images, an MLP for vectors); 5-D image batches are
    flattened into the batch dimension and their features merged again.
    ``extractors[f"{key}_extractor"]`` is the JAX module's sub-module of that
    name, and so is ``extractors[f"{key}_proj"]``, a backbone's projection."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]],
                 net_arch: Optional[Dict[str, dict]] = None, activation: Any = "relu",
                 layer_norm: bool = False, generator=None):
        super().__init__()
        arch = dict(net_arch or {})
        self.keys = sorted(obs_shapes)
        self.extractors = nn.ModuleDict()
        self.out_features = 0
        for key in self.keys:
            shape = tuple(int(d) for d in obs_shapes[key])
            ndim = len(shape) + 1
            spec = arch.get(key) or DEFAULT_KEY_EXTRACTORS.get(key) or (
                {"cnn": 128} if ndim >= 3 else {"mlp": [64]})
            group = 1
            if ndim == 5:  # (k, C, H, W) a sample: k images share the extractor
                group, shape = shape[0], shape[1:]
            if "backbone" in spec:
                sub = backbone(spec["backbone"], generator)
                if spec.get("out"):
                    proj = _init_layer(nn.Linear(sub.out_features, int(spec["out"])), generator)
                    self.extractors[f"{key}_proj"] = proj
            elif "resnet" in spec:
                sub = ResNetCNN(shape, spec["resnet"], generator=generator)
            elif "cnn" in spec:
                sub = ImageCNN(shape, spec["cnn"], activation=activation, generator=generator)
            else:
                sub = MLP(math.prod(shape), spec["mlp"], activation, layer_norm,
                          generator=generator)
            self.extractors[f"{key}_extractor"] = sub
            width = (self.extractors[f"{key}_proj"].out_features
                     if f"{key}_proj" in self.extractors else sub.out_features)
            self.out_features += width * group

    def forward(self, obs: Dict[str, Tensor]) -> Tensor:
        if sorted(obs) != self.keys:
            raise KeyError(f"observation keys {sorted(obs)} differ from the extractor's "
                           f"{self.keys}")
        feats = []
        for key in self.keys:
            x, sub = obs[key], self.extractors[f"{key}_extractor"]
            # explicit widths: a rank's share of a minibatch may hold no rows
            batch, frames = x.shape[0], (x.shape[1] if x.dim() == 5 else 1)
            if x.dim() == 5:
                x = x.reshape(-1, *x.shape[2:])
            if isinstance(sub, MLP) and x.dim() > 2:
                x = x.flatten(1)
            f = sub(x.to(torch.float32))
            if f"{key}_proj" in self.extractors:
                f = F.relu(self.extractors[f"{key}_proj"](f))
            feats.append(f.reshape(batch, frames * f.shape[1:].numel()))
        return torch.cat(feats, dim=-1)


# named presets for MultiInputExtractor's ``net_arch``
EXTRACTOR_ALIASES: Dict[str, Dict[str, dict]] = {
    "StateExtractor": {"state": {"mlp": [128, 64]}},
    "TargetExtractor": {"target": {"mlp": [64]}},
    "ImageExtractor": {"depth": {"cnn": 128}},
    "StateTargetExtractor": {
        "state": {"mlp": [128, 64]}, "target": {"mlp": [64]},
    },
    "StateImageExtractor": {
        "state": {"mlp": [128, 64]}, "depth": {"cnn": 128},
    },
    "StateTargetImageExtractor": {
        "state": {"mlp": [128, 64]}, "target": {"mlp": [64]},
        "depth": {"cnn": 128},
    },
    "SwarmStateTargetImageExtractor": {
        "state": {"mlp": [128, 64]}, "target": {"mlp": [64]},
        "depth": {"cnn": 128}, "swarm": {"mlp": [128]},
    },
    "StateGateExtractor": {
        "state": {"mlp": [128, 64]}, "gate": {"mlp": [32]},
    },
    "FlexibleExtractor": {},  # per-key defaults
    "EmptyExtractor": {},
    "LatentCombineExtractor": {
        "state": {"mlp": [128, 64]}, "deter": {"mlp": [128]},
        "stoch": {"mlp": [64]},
    },
}


def resolve_extractor(name_or_arch) -> Optional[Dict[str, dict]]:
    """String alias → net_arch preset; anything else passes through."""
    if isinstance(name_or_arch, str):
        return EXTRACTOR_ALIASES[name_or_arch]
    return name_or_arch
