"""Torchvision-layout ResNet backbones (counterpart of
``visfly_tpu/policies/torch_backbones.py``).

:class:`TorchResNet` is torchvision's resnet18/34 (BasicBlock) and
resnet50/101 (Bottleneck, the stride on the 3×3) feature trunk: a 7×7/2 stem,
a 3×3/2 max-pool, four stages and a global average pool, the fc head dropped.
BatchNorm is folded into the convolution before it, as in the JAX module, so
the module is convolutions with biases and nothing else: the parameters a
trainer moves are the JAX module's, and there are no running statistics to
carry. The module names follow torchvision's (``conv1``,
``layer2.0.conv1``, ``layer2.0.downsample``), each a folded ``Conv2d``.

A torchvision ``state_dict`` (a local ``.pth``, e.g. saved once with
``torch.save(torchvision.models.resnet18(weights=...).state_dict(), p)``;
torchvision is not needed here) is the loaders' contract:
:func:`convert_torch_resnet` folds it into this module's state dict,
:func:`load_torch_resnet` reads a file with ``weights_only=True``, and
:func:`apply_pretrained` loads it into a built policy by extractor name.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .common import lecun_normal

ARCH_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
               "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
# torchvision Bottleneck archs (1×1 → 3×3 → 1×1·expansion residual blocks)
BOTTLENECK_ARCHS = frozenset({"resnet50", "resnet101"})
BOTTLENECK_EXPANSION = 4


def folded_conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                generator=None) -> nn.Conv2d:
    """A convolution with a bias and symmetric ``k // 2`` padding, as torch
    pads whatever the stride (flax ``SAME`` would pad 0 before and 1 after
    at stride 2); weights drawn as flax draws a ``Conv``'s, biases zero."""
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, groups=groups)
    lecun_normal(conv.weight, generator=generator)
    nn.init.zeros_(conv.bias)
    return conv


class BasicBlock(nn.Module):
    """BasicBlock with BN folded: conv3×3 → ReLU → conv3×3, plus a 1×1
    ``downsample`` on the residual where the shape changes, then ReLU."""

    def __init__(self, cin: int, channels: int, stride: int = 1, generator=None):
        super().__init__()
        self.conv1 = folded_conv(cin, channels, 3, stride, generator=generator)
        self.conv2 = folded_conv(channels, channels, 3, generator=generator)
        self.downsample = (folded_conv(cin, channels, 1, stride, generator=generator)
                           if cin != channels or stride != 1 else None)
        self.out_channels = channels

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv2(F.relu(self.conv1(x)))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    """Bottleneck (ResNet v1.5) with BN folded: conv1×1 → ReLU → conv3×3
    (stride) → ReLU → conv1×1 to 4× the channels, plus a strided 1×1
    ``downsample`` on the residual where the shape changes, then ReLU."""

    def __init__(self, cin: int, channels: int, stride: int = 1, generator=None):
        super().__init__()
        out = channels * BOTTLENECK_EXPANSION
        self.conv1 = folded_conv(cin, channels, 1, generator=generator)
        self.conv2 = folded_conv(channels, channels, 3, stride, generator=generator)
        self.conv3 = folded_conv(channels, out, 1, generator=generator)
        self.downsample = (folded_conv(cin, out, 1, stride, generator=generator)
                           if cin != out or stride != 1 else None)
        self.out_channels = out

    def forward(self, x: Tensor) -> Tensor:
        h = self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


def tile_depth(x: Tensor) -> Tensor:
    """NCHW in; a 1-channel (depth) image is tiled to the 3 channels an RGB
    backbone takes, as the JAX backbones do."""
    if x.dim() == 3:
        x = x[:, None]
    return x.expand(-1, 3, -1, -1) if x.shape[1] == 1 else x


class TorchResNet(nn.Module):
    """torchvision resnet18/34/50/101 trunk (BN folded) → the pooled
    features, ``out_features`` 512 (BasicBlock) or 2048 (Bottleneck). Takes
    NCHW images of 1 or 3 channels. An unknown ``arch`` raises KeyError."""

    def __init__(self, arch: str = "resnet18", generator=None):
        super().__init__()
        stages = ARCH_STAGES[arch]
        self.arch = arch
        block = Bottleneck if arch in BOTTLENECK_ARCHS else BasicBlock
        self.conv1 = folded_conv(3, 64, 7, 2, generator=generator)
        cin = 64
        for stage, blocks in enumerate(stages):
            layer = nn.Sequential()
            for b in range(blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                layer.append(block(cin, 64 * 2 ** stage, stride, generator))
                cin = layer[-1].out_channels
            self.add_module(f"layer{stage + 1}", layer)
        self.out_features = cin

    def forward(self, x: Tensor) -> Tensor:
        h = F.relu(self.conv1(tile_depth(x).to(self.conv1.weight.dtype)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for stage in range(len(ARCH_STAGES[self.arch])):
            h = getattr(self, f"layer{stage + 1}")(h)
        return h.mean(dim=(2, 3))


def _as_tensor(v) -> Tensor:
    return v.detach().cpu() if isinstance(v, Tensor) else torch.as_tensor(v)


def fold_bn(sd: Dict[str, Any], conv: str, bn: str, eps: float = 1e-5) -> Dict[str, Tensor]:
    """A torchvision convolution ``conv`` and the BatchNorm ``bn`` after it
    (running statistics, affine) → {weight, bias} of one convolution:
    W' = W·γ/σ per output channel, b' = β − γ·μ/σ (torchvision's
    convolutions before a BatchNorm have no bias)."""
    w = _as_tensor(sd[f"{conv}.weight"])
    scale = _as_tensor(sd[f"{bn}.weight"]) / torch.sqrt(_as_tensor(sd[f"{bn}.running_var"]) + eps)
    return {"weight": w * scale[:, None, None, None],
            "bias": _as_tensor(sd[f"{bn}.bias"]) - _as_tensor(sd[f"{bn}.running_mean"]) * scale}


def plain_conv(sd: Dict[str, Any], conv: str) -> Dict[str, Tensor]:
    """A torchvision convolution with its own bias, unchanged."""
    return {"weight": _as_tensor(sd[f"{conv}.weight"]), "bias": _as_tensor(sd[f"{conv}.bias"])}


def flatten_state(tree: Dict[str, Dict[str, Tensor]]) -> Dict[str, Tensor]:
    """{module: {weight, bias}} → a state dict ``module.weight`` / ``.bias``."""
    return {f"{m}.{k}": v for m, p in tree.items() for k, v in p.items()}


def convert_torch_resnet(state_dict: Dict[str, Any], arch: str = "resnet18"
                         ) -> Dict[str, Tensor]:
    """A torchvision ``resnet{18,34,50,101}`` state dict (tensors or numpy
    arrays) → the state dict of :class:`TorchResNet` ``arch``, every
    BatchNorm folded; the fc head is ignored."""
    sd = state_dict
    tree = {"conv1": fold_bn(sd, "conv1", "bn1")}
    for stage, blocks in enumerate(ARCH_STAGES[arch]):
        for b in range(blocks):
            tp = f"layer{stage + 1}.{b}"
            for j in (1, 2, 3):
                if f"{tp}.conv{j}.weight" in sd:
                    tree[f"{tp}.conv{j}"] = fold_bn(sd, f"{tp}.conv{j}", f"{tp}.bn{j}")
            if f"{tp}.downsample.0.weight" in sd:
                tree[f"{tp}.downsample"] = fold_bn(sd, f"{tp}.downsample.0",
                                                   f"{tp}.downsample.1")
    return flatten_state(tree)


def load_torch_resnet(path_or_dict, arch: str = "resnet18") -> Dict[str, Tensor]:
    """A torchvision resnet ``.pth`` (read with ``weights_only=True``) or
    state dict → :func:`convert_torch_resnet`'s state dict."""
    if isinstance(path_or_dict, (str, bytes)):
        path_or_dict = torch.load(path_or_dict, map_location="cpu", weights_only=True)
    return convert_torch_resnet(path_or_dict, arch=arch)


def apply_pretrained(module: nn.Module, pretrained: Dict[str, Any], arch: str = "resnet18"
                     ) -> nn.Module:
    """Load folded backbone weights into a built policy, in place.

    ``pretrained`` maps extractor module names (``"depth_extractor"``, as a
    ``{"backbone": ...}`` spec names it in ``MultiInputExtractor``) to a
    ``.pth`` path or a torchvision state dict, which :func:`load_torch_resnet`
    folds; every module of that name takes the
    weights and everything else is kept. A shape that differs raises
    ValueError, a name that names nothing KeyError. Returns ``module``."""
    for name, src in pretrained.items():
        converted = load_torch_resnet(src, arch=arch)
        targets = [m for path, m in module.named_modules() if path.split(".")[-1] == name]
        if not targets:
            raise KeyError(f"no params found under module name {name!r}")
        for target in targets:
            own = target.state_dict()
            for k, v in converted.items():
                if k not in own:
                    raise ValueError(f"{name}.{k} has no counterpart in the module")
                if own[k].shape != v.shape:
                    raise ValueError(f"shape mismatch at {name}.{k}: {tuple(own[k].shape)} "
                                     f"vs {tuple(v.shape)}")
            target.load_state_dict(converted, strict=True)
    return module
