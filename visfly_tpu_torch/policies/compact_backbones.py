"""Compact torchvision-layout backbones: MobileNetV3 and EfficientNetV2
(counterpart of ``visfly_tpu/policies/compact_backbones.py``).

``mobilenet_s`` / ``mobilenet_l`` are torchvision's ``mobilenet_v3_small`` /
``_large`` trunks, ``efficientnet_s`` / ``_m`` / ``_l`` its
``efficientnet_v2_s/m/l``. As in :mod:`torch_backbones`, BatchNorm is folded
into the convolution before it: the modules are convolutions with biases
(depthwise ones with ``groups`` = channels), and the converters fold a
torchvision state dict into their state dicts. The modules' names are the
JAX modules' (``stem``, ``b<i>_expand``, ``b<i>_dw``, ``b<i>_se_fc1``,
``b<i>_se_fc2``, ``b<i>_project``, ``b<i>_fused``, ``head``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .torch_backbones import flatten_state, fold_bn, folded_conv, plain_conv, tile_depth


def _make_divisible(v: float, divisor: int = 8) -> int:
    """torchvision's channel rounding rule."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hardswish(x: Tensor) -> Tensor:
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x: Tensor) -> Tensor:
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def silu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(x)


_ACT = {"RE": F.relu, "HS": hardswish, "SI": silu}

# MobileNetV3 block rows: (kernel, exp, out, use_se, act, stride)
# (torchvision mobilenetv3._mobilenet_v3_conf)
MOBILENET_V3 = {
    "small": {
        "stem": 16,
        "blocks": [
            (3, 16, 16, True, "RE", 2),
            (3, 72, 24, False, "RE", 2),
            (3, 88, 24, False, "RE", 1),
            (5, 96, 40, True, "HS", 2),
            (5, 240, 40, True, "HS", 1),
            (5, 240, 40, True, "HS", 1),
            (5, 120, 48, True, "HS", 1),
            (5, 144, 48, True, "HS", 1),
            (5, 288, 96, True, "HS", 2),
            (5, 576, 96, True, "HS", 1),
            (5, 576, 96, True, "HS", 1),
        ],
        "head": 576,
    },
    "large": {
        "stem": 16,
        "blocks": [
            (3, 16, 16, False, "RE", 1),
            (3, 64, 24, False, "RE", 2),
            (3, 72, 24, False, "RE", 1),
            (5, 72, 40, True, "RE", 2),
            (5, 120, 40, True, "RE", 1),
            (5, 120, 40, True, "RE", 1),
            (3, 240, 80, False, "HS", 2),
            (3, 200, 80, False, "HS", 1),
            (3, 184, 80, False, "HS", 1),
            (3, 184, 80, False, "HS", 1),
            (3, 480, 112, True, "HS", 1),
            (3, 672, 112, True, "HS", 1),
            (5, 672, 160, True, "HS", 2),
            (5, 960, 160, True, "HS", 1),
            (5, 960, 160, True, "HS", 1),
        ],
        "head": 960,
    },
}

# EfficientNetV2 stage rows: (block_type, expand, kernel, stride, out, layers)
# (torchvision efficientnet._efficientnet_conf, v2 variants)
EFFICIENTNET_V2 = {
    "s": {"stem": 24, "head": 1280, "stages": [
        ("fused", 1, 3, 1, 24, 2),
        ("fused", 4, 3, 2, 48, 4),
        ("fused", 4, 3, 2, 64, 4),
        ("mb", 4, 3, 2, 128, 6),
        ("mb", 6, 3, 1, 160, 9),
        ("mb", 6, 3, 2, 256, 15),
    ]},
    "m": {"stem": 24, "head": 1280, "stages": [
        ("fused", 1, 3, 1, 24, 3),
        ("fused", 4, 3, 2, 48, 5),
        ("fused", 4, 3, 2, 80, 5),
        ("mb", 4, 3, 2, 160, 7),
        ("mb", 6, 3, 1, 176, 14),
        ("mb", 6, 3, 2, 304, 18),
        ("mb", 6, 3, 1, 512, 5),
    ]},
    "l": {"stem": 32, "head": 1280, "stages": [
        ("fused", 1, 3, 1, 32, 4),
        ("fused", 4, 3, 2, 64, 7),
        ("fused", 4, 3, 2, 96, 7),
        ("mb", 4, 3, 2, 192, 10),
        ("mb", 6, 3, 1, 224, 19),
        ("mb", 6, 3, 2, 384, 25),
        ("mb", 6, 3, 1, 640, 7),
    ]},
}


class _Trunk(nn.Module):
    """Named folded convolutions; ``conv(name, x)`` applies one."""

    def _add(self, name: str, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
             generator=None) -> None:
        self.add_module(name, folded_conv(cin, cout, k, stride, groups, generator))

    def conv(self, name: str, x: Tensor) -> Tensor:
        return getattr(self, name)(x)


class MobileNetV3(_Trunk):
    """torchvision MobileNetV3 trunk (BN folded): NCHW images of 1 or 3
    channels → the pooled features, ``out_features`` 576 (small) or 960
    (large)."""

    def __init__(self, arch: str = "small", generator=None):
        super().__init__()
        cfg = MOBILENET_V3[arch]
        self.arch = arch
        self._add("stem", 3, cfg["stem"], 3, 2, generator=generator)
        cin = cfg["stem"]
        for i, (k, exp, out, use_se, _act, s) in enumerate(cfg["blocks"]):
            if exp != cin:
                self._add(f"b{i}_expand", cin, exp, 1, generator=generator)
            self._add(f"b{i}_dw", exp, exp, k, s, groups=exp, generator=generator)
            if use_se:
                sq = _make_divisible(exp // 4)
                self._add(f"b{i}_se_fc1", exp, sq, 1, generator=generator)
                self._add(f"b{i}_se_fc2", sq, exp, 1, generator=generator)
            self._add(f"b{i}_project", exp, out, 1, generator=generator)
            cin = out
        self._add("head", cin, cfg["head"], 1, generator=generator)
        self.out_features = cfg["head"]

    def forward(self, x: Tensor) -> Tensor:
        cfg = MOBILENET_V3[self.arch]
        h = hardswish(self.conv("stem", tile_depth(x).to(self.stem.weight.dtype)))
        cin = cfg["stem"]
        for i, (k, exp, out, use_se, act_name, s) in enumerate(cfg["blocks"]):
            act = _ACT[act_name]
            inp = h
            if exp != cin:
                h = act(self.conv(f"b{i}_expand", h))
            h = act(self.conv(f"b{i}_dw", h))
            if use_se:
                w = h.mean(dim=(2, 3), keepdim=True)
                w = F.relu(self.conv(f"b{i}_se_fc1", w))
                h = h * hardsigmoid(self.conv(f"b{i}_se_fc2", w))
            h = self.conv(f"b{i}_project", h)
            if s == 1 and cin == out:
                h = h + inp
            cin = out
        return hardswish(self.conv("head", h)).mean(dim=(2, 3))


class EfficientNetV2(_Trunk):
    """torchvision EfficientNetV2 trunk (BN folded): NCHW images of 1 or 3
    channels → the pooled 1280-wide features."""

    def __init__(self, arch: str = "s", generator=None):
        super().__init__()
        cfg = EFFICIENTNET_V2[arch]
        self.arch = arch
        self._add("stem", 3, cfg["stem"], 3, 2, generator=generator)
        cin, bi = cfg["stem"], 0
        for btype, e, k, s0, out, layers in cfg["stages"]:
            for li in range(layers):
                s = s0 if li == 0 else 1
                if btype == "fused" and e == 1:
                    self._add(f"b{bi}_fused", cin, out, k, s, generator=generator)
                elif btype == "fused":
                    self._add(f"b{bi}_expand", cin, cin * e, k, s, generator=generator)
                    self._add(f"b{bi}_project", cin * e, out, 1, generator=generator)
                else:
                    exp, sq = cin * e, max(1, cin // 4)
                    self._add(f"b{bi}_expand", cin, exp, 1, generator=generator)
                    self._add(f"b{bi}_dw", exp, exp, k, s, groups=exp, generator=generator)
                    self._add(f"b{bi}_se_fc1", exp, sq, 1, generator=generator)
                    self._add(f"b{bi}_se_fc2", sq, exp, 1, generator=generator)
                    self._add(f"b{bi}_project", exp, out, 1, generator=generator)
                cin = out
                bi += 1
        self._add("head", cin, cfg["head"], 1, generator=generator)
        self.out_features = cfg["head"]

    def forward(self, x: Tensor) -> Tensor:
        cfg = EFFICIENTNET_V2[self.arch]
        h = silu(self.conv("stem", tile_depth(x).to(self.stem.weight.dtype)))
        cin, bi = cfg["stem"], 0
        for btype, e, k, s0, out, layers in cfg["stages"]:
            for li in range(layers):
                s = s0 if li == 0 else 1
                inp = h
                if btype == "fused" and e == 1:
                    h = silu(self.conv(f"b{bi}_fused", h))
                elif btype == "fused":
                    h = self.conv(f"b{bi}_project", silu(self.conv(f"b{bi}_expand", h)))
                else:
                    h = silu(self.conv(f"b{bi}_expand", h))
                    h = silu(self.conv(f"b{bi}_dw", h))
                    w = h.mean(dim=(2, 3), keepdim=True)
                    w = silu(self.conv(f"b{bi}_se_fc1", w))
                    h = h * torch.sigmoid(self.conv(f"b{bi}_se_fc2", w))
                    h = self.conv(f"b{bi}_project", h)
                if s == 1 and cin == out:
                    h = h + inp
                cin = out
                bi += 1
        return silu(self.conv("head", h)).mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# torchvision state dict → folded state dict
# ---------------------------------------------------------------------------


def convert_torch_mobilenet_v3(state_dict: Dict[str, Any], arch: str = "small"
                               ) -> Dict[str, Tensor]:
    """torchvision ``mobilenet_v3_{small,large}`` state dict → the state dict
    of :class:`MobileNetV3` (BN folded; the classifier ignored)."""
    sd = state_dict
    cfg = MOBILENET_V3[arch]
    tree = {"stem": fold_bn(sd, "features.0.0", "features.0.1")}
    cin = cfg["stem"]
    for i, (k, exp, out, use_se, _act, s) in enumerate(cfg["blocks"]):
        f = f"features.{i + 1}.block"
        j = 0
        if exp != cin:
            tree[f"b{i}_expand"] = fold_bn(sd, f"{f}.{j}.0", f"{f}.{j}.1")
            j += 1
        tree[f"b{i}_dw"] = fold_bn(sd, f"{f}.{j}.0", f"{f}.{j}.1")
        j += 1
        if use_se:
            tree[f"b{i}_se_fc1"] = plain_conv(sd, f"{f}.{j}.fc1")
            tree[f"b{i}_se_fc2"] = plain_conv(sd, f"{f}.{j}.fc2")
            j += 1
        tree[f"b{i}_project"] = fold_bn(sd, f"{f}.{j}.0", f"{f}.{j}.1")
        cin = out
    n_feat = len(cfg["blocks"]) + 1
    tree["head"] = fold_bn(sd, f"features.{n_feat}.0", f"features.{n_feat}.1")
    return flatten_state(tree)


def convert_torch_efficientnet_v2(state_dict: Dict[str, Any], arch: str = "s"
                                  ) -> Dict[str, Tensor]:
    """torchvision ``efficientnet_v2_{s,m,l}`` state dict → the state dict of
    :class:`EfficientNetV2` (BN folded; the classifier ignored)."""
    sd = state_dict
    cfg = EFFICIENTNET_V2[arch]
    tree = {"stem": fold_bn(sd, "features.0.0", "features.0.1")}
    bi = 0
    for si, (btype, e, k, s0, out, layers) in enumerate(cfg["stages"]):
        for li in range(layers):
            f = f"features.{si + 1}.{li}.block"
            if btype == "fused" and e == 1:
                tree[f"b{bi}_fused"] = fold_bn(sd, f"{f}.0.0", f"{f}.0.1")
            elif btype == "fused":
                tree[f"b{bi}_expand"] = fold_bn(sd, f"{f}.0.0", f"{f}.0.1")
                tree[f"b{bi}_project"] = fold_bn(sd, f"{f}.1.0", f"{f}.1.1")
            else:
                tree[f"b{bi}_expand"] = fold_bn(sd, f"{f}.0.0", f"{f}.0.1")
                tree[f"b{bi}_dw"] = fold_bn(sd, f"{f}.1.0", f"{f}.1.1")
                tree[f"b{bi}_se_fc1"] = plain_conv(sd, f"{f}.2.fc1")
                tree[f"b{bi}_se_fc2"] = plain_conv(sd, f"{f}.2.fc2")
                tree[f"b{bi}_project"] = fold_bn(sd, f"{f}.3.0", f"{f}.3.1")
            bi += 1
    n_feat = len(cfg["stages"]) + 1
    tree["head"] = fold_bn(sd, f"features.{n_feat}.0", f"features.{n_feat}.1")
    return flatten_state(tree)


# the reference's backbone aliases; the resnets live in torch_backbones.py
COMPACT_BACKBONES = {
    "mobilenet_s": (MobileNetV3, {"arch": "small"}),
    "mobilenet_l": (MobileNetV3, {"arch": "large"}),
    "efficientnet_s": (EfficientNetV2, {"arch": "s"}),
    "efficientnet_m": (EfficientNetV2, {"arch": "m"}),
    "efficientnet_l": (EfficientNetV2, {"arch": "l"}),
}
