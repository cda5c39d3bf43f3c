# Frozen copy of visfly_tpu_torch/core/types.py at commit 2b650bf71ac506a5b36a60b5e2300d8c3685e117, kept unchanged
# (only imports rewired) as the benchmark's plain reference; not the program.
"""Small value types shared across the package (counterpart of
``visfly_tpu/core/types.py``)."""
from __future__ import annotations

import enum
from typing import NamedTuple, Union

import torch
from torch import Tensor


class ActionType(enum.IntEnum):
    """Control modes."""

    THRUST = 0
    BODYRATE = 1
    VELOCITY = 2
    POSITION = 3


ACTION_TYPE_ALIAS = {
    "thrust": ActionType.THRUST,
    "bodyrate": ActionType.BODYRATE,
    "velocity": ActionType.VELOCITY,
    "position": ActionType.POSITION,
}


class Bound(NamedTuple):
    """Closed interval."""

    min: Union[float, Tensor]
    max: Union[float, Tensor]


class Uniform(NamedTuple):
    """Uniform distribution as mean ± half-range.

    ``sample`` draws ``(U[0,1) − 0.5) · half + mean``: the *full* width is
    ``half``, a quirk of the reference kept for parity."""

    mean: Tensor
    half: Tensor

    def sample(self, gen: torch.Generator, shape=()) -> Tensor:
        mean = torch.as_tensor(self.mean, device=gen.device)
        u = torch.rand((*shape, *mean.shape), generator=gen, device=gen.device)
        return (u - 0.5) * self.half + mean


class Normal(NamedTuple):
    """Gaussian distribution."""

    mean: Tensor
    std: Tensor

    def sample(self, gen: torch.Generator, shape=()) -> Tensor:
        mean = torch.as_tensor(self.mean, device=gen.device)
        n = torch.randn((*shape, *mean.shape), generator=gen, device=gen.device)
        return n * self.std + mean


class PID(NamedTuple):
    """Diagonal PID gains, each a (3,) diagonal (the reference keeps full
    3×3 matrices whose off-diagonal entries are zero in every drone
    config)."""

    p: Tensor
    i: Tensor
    d: Tensor
