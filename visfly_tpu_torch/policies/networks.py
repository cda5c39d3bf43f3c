"""Actor networks (counterpart of ``visfly_tpu/policies/networks.py``, the
part the BPTT trainer needs): ``Actor`` and ``RecurrentActor``, squashed
diagonal Gaussians with a clamped log-std, and the Gaussian helpers.

A stochastic action needs its noise from the caller: an explicit ``noise``
tensor (N, action_dim), or a ``torch.Generator`` to draw it from. With neither,
or with ``deterministic=True``, the squashed mean is returned and the
log-probability is ``None``. (JAX's threefry keys and torch's generators give
different numbers from one seed, so a test that compares the two packages
hands both the same noise.)

The policies compute in float32: building one turns TF32 off for cuDNN
convolutions and matrix products (``full_fp32_matmul``), which torch leaves on
for convolutions by default.

Not ported yet (ROADMAP Queue A items 13 and 14): ``QCritic``,
``StateCritic``, ``ActorCriticPolicy`` and ``RecurrentActorCriticPolicy``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ..core.math_utils import full_fp32_matmul
from .extractors import MLP, GRUCell, MultiInputExtractor, _init_layer

LOG_STD_MIN, LOG_STD_MAX = -10.0, 2.0


def _squashed_gaussian(mean: Tensor, log_std: Tensor, generator, noise: Optional[Tensor],
                       deterministic: bool) -> Tuple[Tensor, Optional[Tensor]]:
    """tanh-squashed reparameterised sample and its log-probability, or the
    squashed mean and None."""
    if deterministic or (generator is None and noise is None):
        return torch.tanh(mean), None
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
    action = torch.tanh(mean + torch.exp(log_std) * noise)
    log_prob = ((-0.5 * (noise ** 2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
                - torch.log(1 - action ** 2 + 1e-6).sum(-1))
    return action, log_prob


class _GaussianHead(nn.Module):
    """``mu`` and ``log_std`` layers on a latent; the log-std is clamped."""

    def __init__(self, in_features: int, action_dim: int, generator=None):
        super().__init__()
        self.mu = _init_layer(nn.Linear(in_features, action_dim), generator)
        self.log_std = _init_layer(nn.Linear(in_features, action_dim), generator)

    def forward(self, h: Tensor) -> Tuple[Tensor, Tensor]:
        return self.mu(h), torch.clamp(self.log_std(h), LOG_STD_MIN, LOG_STD_MAX)


class Actor(nn.Module):
    """Gaussian actor with tanh squash: extractor → latent MLP → mean and
    log-std. ``obs_shapes`` gives each observation's shape without the batch
    dimension."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]], action_dim: int = 4,
                 net_arch: Optional[Dict[str, dict]] = None,
                 latent_dim: Sequence[int] = (256, 256), activation: Any = "relu",
                 layer_norm: bool = False, generator=None):
        super().__init__()
        full_fp32_matmul()
        self.extractor = MultiInputExtractor(obs_shapes, net_arch, activation, layer_norm,
                                             generator)
        self.latent = MLP(self.extractor.out_features, latent_dim, activation, layer_norm,
                          generator=generator)
        self.head = _GaussianHead(self.latent.out_features, action_dim, generator)

    def forward(self, obs: Dict[str, Tensor], generator: Optional[torch.Generator] = None,
                deterministic: bool = False, noise: Optional[Tensor] = None
                ) -> Tuple[Tensor, Optional[Tensor]]:
        mean, log_std = self.head(self.latent(self.extractor(obs)))
        return _squashed_gaussian(mean, log_std, generator, noise, deterministic)


class RecurrentActor(nn.Module):
    """GRU-recurrent Gaussian actor: extractor features feed a GRU whose
    hidden state persists across the rollout. The caller carries the hidden
    state and zeroes it at episode boundaries."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]], action_dim: int = 4,
                 hidden_dim: int = 128, net_arch: Optional[Dict[str, dict]] = None,
                 latent_dim: Sequence[int] = (128,), activation: Any = "relu", generator=None):
        super().__init__()
        full_fp32_matmul()
        self.hidden_dim = int(hidden_dim)
        self.extractor = MultiInputExtractor(obs_shapes, net_arch, activation,
                                             generator=generator)
        self.gru = GRUCell(self.extractor.out_features, self.hidden_dim, generator)
        self.latent = MLP(self.hidden_dim, latent_dim, activation, generator=generator)
        self.head = _GaussianHead(self.latent.out_features, action_dim, generator)

    def forward(self, obs: Dict[str, Tensor], hidden: Tensor,
                generator: Optional[torch.Generator] = None, deterministic: bool = False,
                noise: Optional[Tensor] = None) -> Tuple[Tensor, Optional[Tensor], Tensor]:
        hidden = self.gru(self.extractor(obs), hidden)
        mean, log_std = self.head(self.latent(hidden))
        action, log_prob = _squashed_gaussian(mean, log_std, generator, noise, deterministic)
        return action, log_prob, hidden

    def initial_hidden(self, batch: int) -> Tensor:
        w = self.gru.hn.weight
        return torch.zeros((batch, self.hidden_dim), dtype=w.dtype, device=w.device)


def gaussian_log_prob(mean: Tensor, log_std: Tensor, action: Tensor) -> Tensor:
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi))).sum(-1)


def gaussian_entropy(log_std: Tensor) -> Tensor:
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)


def _unported(name: str):
    def raise_(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP: Queue A items 13 and 14, "
                                  "the other trainers' networks)")
    return raise_


QCritic = _unported("QCritic")
StateCritic = _unported("StateCritic")
ActorCriticPolicy = _unported("ActorCriticPolicy")
RecurrentActorCriticPolicy = _unported("RecurrentActorCriticPolicy")
