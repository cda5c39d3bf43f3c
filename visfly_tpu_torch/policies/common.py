"""Weight-initialisation helpers (counterpart of
``visfly_tpu/policies/common.py``): a name → initialiser map. An initialiser
fills a weight tensor in place, ``init(tensor, generator=None)``, with torch's
``(out, in, ...)`` layout giving fan-in and fan-out.

``lecun_normal`` is what the JAX package's layers use by default (flax's
``Dense``, ``Conv`` and the input kernels of ``GRUCell``): a normal of variance
1 / fan_in, truncated at two standard deviations; the modules here use it too,
so that a fresh policy starts from the same distribution.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def _fans(w: torch.Tensor):
    fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(w)
    return fan_in, fan_out


def lecun_normal(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Truncated normal of variance 1 / fan_in (the constant undoes the
    variance lost to truncating at ±2σ, as in ``jax.nn.initializers``)."""
    std = math.sqrt(1.0 / _fans(w)[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _kaiming_normal(w, generator=None):
    return nn.init.normal_(w, 0.0, math.sqrt(2.0 / _fans(w)[0]), generator=generator)


def _kaiming_uniform(w, generator=None):
    bound = math.sqrt(6.0 / _fans(w)[0])
    return nn.init.uniform_(w, -bound, bound, generator=generator)


def _xavier_normal(w, generator=None):
    return nn.init.normal_(w, 0.0, math.sqrt(2.0 / sum(_fans(w))), generator=generator)


def _xavier_uniform(w, generator=None):
    bound = math.sqrt(6.0 / sum(_fans(w)))
    return nn.init.uniform_(w, -bound, bound, generator=generator)


INITIALIZERS: dict = {
    "kaiming": lambda: _kaiming_normal,
    "kaiming_uniform": lambda: _kaiming_uniform,
    "xavier": lambda: _xavier_normal,
    "xavier_uniform": lambda: _xavier_uniform,
    "orthogonal": lambda scale=1.0: (
        lambda w, generator=None: nn.init.orthogonal_(w, gain=scale, generator=generator)),
    "normal": lambda stddev=0.01: (
        lambda w, generator=None: nn.init.normal_(w, 0.0, stddev, generator=generator)),
    "zeros": lambda: (lambda w, generator=None: nn.init.zeros_(w)),
    "lecun_normal": lambda: lecun_normal,
}


def get_initializer(name: str, **kwargs) -> Callable:
    return INITIALIZERS[name](**kwargs)
