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

Not ported yet, each raising ``NotImplementedError``: the ``backbone`` and
``resnet`` branches, ``TransCNN`` and ``DecoderHead`` (ROADMAP Queue A item
14).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .common import get_initializer, lecun_normal

ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "leakyrelu": F.leaky_relu,  # slope 0.01 in both packages
    "tanh": torch.tanh,
    "elu": F.elu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's default is the tanh form
}
_LN_EPS = 1e-6  # flax's LayerNorm epsilon


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: Queue A item 14, the rest "
                               "of policies/)")


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
            ph = _same_pad(h.shape[2], self.kernel, 2)
            pw = _same_pad(h.shape[3], self.kernel, 2)
            h = self.act(conv(F.pad(h, (*pw, *ph))))
        return self.act(self.proj(h.flatten(1)))


def _chw(shape: Tuple[int, ...]) -> Tuple[int, int, int]:
    """(C, H, W) of an image shape (C, H, W), (H, W, C) or (H, W), by the rule
    ``ImageCNN.forward`` applies to a batch."""
    if len(shape) == 2:
        return (1, *shape)
    if shape[0] in (1, 3) and shape[-1] not in (1, 3):
        return shape
    return (shape[2], shape[0], shape[1])


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


class MultiInputExtractor(nn.Module):
    """Dispatch per-key sub-extractors and concatenate their features, keys in
    sorted order.

    ``obs_shapes``: {obs_key: shape without the batch dimension};
    ``net_arch``: {obs_key: {"mlp": [sizes]} | {"cnn": out_features}}. Keys
    present in the observation but absent from ``net_arch`` fall back to
    defaults (a CNN for images, an MLP for vectors); 5-D image batches are
    flattened into the batch dimension and their features merged again.
    ``extractors[f"{key}_extractor"]`` is the JAX module's sub-module of that
    name."""

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
                raise _unported(f"the {spec['backbone']!r} backbone extractor")
            if "resnet" in spec:
                raise _unported("the ResNet extractor")
            if "cnn" in spec:
                sub = ImageCNN(shape, spec["cnn"], activation=activation, generator=generator)
            else:
                sub = MLP(math.prod(shape), spec["mlp"], activation, layer_norm,
                          generator=generator)
            self.extractors[f"{key}_extractor"] = sub
            self.out_features += sub.out_features * group

    def forward(self, obs: Dict[str, Tensor]) -> Tensor:
        if sorted(obs) != self.keys:
            raise KeyError(f"observation keys {sorted(obs)} differ from the extractor's "
                           f"{self.keys}")
        feats = []
        for key in self.keys:
            x, sub = obs[key], self.extractors[f"{key}_extractor"]
            batch = x.shape[0]
            if x.dim() == 5:
                x = x.reshape(-1, *x.shape[2:])
            if isinstance(sub, MLP) and x.dim() > 2:
                x = x.reshape(x.shape[0], -1)
            feats.append(sub(x.to(torch.float32)).reshape(batch, -1))
        return torch.cat(feats, dim=-1)


class TransCNN(nn.Module):
    def __init__(self, *args, **kwargs):
        raise _unported("TransCNN")


class DecoderHead(nn.Module):
    def __init__(self, *args, **kwargs):
        raise _unported("DecoderHead")


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
