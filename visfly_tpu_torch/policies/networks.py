"""Actor and critic networks (counterpart of
``visfly_tpu/policies/networks.py``): ``Actor`` and ``RecurrentActor``,
squashed diagonal Gaussians with a clamped log-std; ``QCritic`` (n Q(s, a)
heads) and ``StateCritic`` (n V(s) heads); ``ActorCriticPolicy`` and
``RecurrentActorCriticPolicy``, PPO's Gaussian policies with a
state-independent log-std and a value head; and the Gaussian helpers.

A stochastic action needs its noise from the caller: an explicit ``noise``
tensor (N, action_dim), or a ``torch.Generator`` to draw it from. With neither,
or with ``deterministic=True``, the squashed mean is returned and the
log-probability is ``None``. (JAX's threefry keys and torch's generators give
different numbers from one seed, so a test that compares the two packages
hands both the same noise.)

The policies compute in float32: building one turns TF32 off for cuDNN
convolutions and matrix products (``full_fp32_matmul``), which torch leaves on
for convolutions by default.

Every module takes the shapes of its observations without the batch
dimension, ``obs_shapes``, where flax infers them at the first call; the
names of the sub-modules are the flax modules' (``qf0``, ``qf0_out``,
``mlp_pi``, ``value``, ...), which ``interop.policy_params_from_flax``
reads.
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


class _Heads(nn.Module):
    """``n`` MLP heads, each ending in one output: ``{prefix}{i}`` and
    ``{prefix}{i}_out`` in flax's names."""

    def __init__(self, prefix: str, n: int, in_features: int, latent_dim: Sequence[int],
                 activation: Any, layer_norm: bool, generator=None):
        super().__init__()
        self.prefix = prefix
        for i in range(int(n)):
            mlp = MLP(in_features, latent_dim, activation, layer_norm, generator=generator)
            self.add_module(f"{prefix}{i}", mlp)
            self.add_module(f"{prefix}{i}_out", _init_layer(nn.Linear(mlp.out_features, 1),
                                                            generator))
        self.n = int(n)

    def forward(self, x: Tensor) -> Tensor:
        return torch.cat([getattr(self, f"{self.prefix}{i}_out")(
            getattr(self, f"{self.prefix}{i}")(x)) for i in range(self.n)], dim=-1)


class QCritic(nn.Module):
    """``n_critics`` Q(s, a) heads on the extractor's features and the
    action → (N, n_critics)."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]], action_dim: int = 4,
                 n_critics: int = 2, net_arch: Optional[Dict[str, dict]] = None,
                 latent_dim: Sequence[int] = (256, 256), activation: Any = "relu",
                 layer_norm: bool = False, generator=None):
        super().__init__()
        full_fp32_matmul()
        self.extractor = MultiInputExtractor(obs_shapes, net_arch, activation, layer_norm,
                                             generator)
        self.heads = _Heads("qf", n_critics, self.extractor.out_features + int(action_dim),
                            latent_dim, activation, layer_norm, generator)

    def forward(self, obs: Dict[str, Tensor], action: Tensor) -> Tensor:
        feat = self.extractor(obs)
        return self.heads(torch.cat([feat, action.to(feat.dtype)], dim=-1))


class StateCritic(nn.Module):
    """``n_critics`` V(s) heads on the extractor's features → (N, n_critics)."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]], n_critics: int = 2,
                 net_arch: Optional[Dict[str, dict]] = None,
                 latent_dim: Sequence[int] = (256, 256), activation: Any = "relu",
                 layer_norm: bool = False, generator=None):
        super().__init__()
        full_fp32_matmul()
        self.extractor = MultiInputExtractor(obs_shapes, net_arch, activation, layer_norm,
                                             generator)
        self.heads = _Heads("vf", n_critics, self.extractor.out_features, latent_dim,
                            activation, layer_norm, generator)

    def forward(self, obs: Dict[str, Tensor]) -> Tensor:
        return self.heads(self.extractor(obs))


class _PolicyHeads(nn.Module):
    """PPO's heads on a trunk's features: ``mlp_pi`` → ``mu``, ``mlp_vf`` →
    ``value``, and a state-independent ``log_std`` (zeros at first)."""

    def __init__(self, in_features: int, action_dim: int, pi_layers: Sequence[int],
                 vf_layers: Sequence[int], activation: Any, layer_norm: bool, generator=None):
        super().__init__()
        self.mlp_pi = MLP(in_features, pi_layers, activation, layer_norm, generator=generator)
        self.mlp_vf = MLP(in_features, vf_layers, activation, layer_norm, generator=generator)
        self.mu = _init_layer(nn.Linear(self.mlp_pi.out_features, action_dim), generator)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        self.value = _init_layer(nn.Linear(self.mlp_vf.out_features, 1), generator)

    def forward(self, h: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        mean = self.mu(self.mlp_pi(h))
        value = self.value(self.mlp_vf(h))[..., 0]
        return mean, self.log_std.expand_as(mean), value


class ActorCriticPolicy(nn.Module):
    """PPO's policy: extractor → (mean, log-std, value). The Gaussian is not
    squashed; the trainer clips the action."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]], action_dim: int = 4,
                 net_arch: Optional[Dict[str, dict]] = None, pi_layers: Sequence[int] = (64, 64),
                 vf_layers: Sequence[int] = (64, 64), activation: Any = "relu",
                 layer_norm: bool = False, generator=None):
        super().__init__()
        full_fp32_matmul()
        self.extractor = MultiInputExtractor(obs_shapes, net_arch, activation, layer_norm,
                                             generator)
        self.heads = _PolicyHeads(self.extractor.out_features, int(action_dim), pi_layers,
                                  vf_layers, activation, layer_norm, generator)

    def forward(self, obs: Dict[str, Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
        return self.heads(self.extractor(obs))


class RecurrentActorCriticPolicy(nn.Module):
    """PPO's policy with a GRU trunk shared by both heads → (mean, log-std,
    value, new hidden). The caller carries the hidden state and zeroes it at
    episode boundaries."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]], action_dim: int = 4,
                 hidden_dim: int = 128, net_arch: Optional[Dict[str, dict]] = None,
                 pi_layers: Sequence[int] = (64,), vf_layers: Sequence[int] = (64,),
                 activation: Any = "relu", layer_norm: bool = False, generator=None):
        super().__init__()
        full_fp32_matmul()
        self.hidden_dim = int(hidden_dim)
        self.extractor = MultiInputExtractor(obs_shapes, net_arch, activation, layer_norm,
                                             generator)
        self.gru = GRUCell(self.extractor.out_features, self.hidden_dim, generator)
        self.heads = _PolicyHeads(self.hidden_dim, int(action_dim), pi_layers, vf_layers,
                                  activation, layer_norm, generator)

    def forward(self, obs: Dict[str, Tensor], hidden: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        hidden = self.gru(self.extractor(obs), hidden)
        return (*self.heads(hidden), hidden)

    def initial_hidden(self, batch: int) -> Tensor:
        w = self.gru.hn.weight
        return torch.zeros((batch, self.hidden_dim), dtype=w.dtype, device=w.device)


def gaussian_log_prob(mean: Tensor, log_std: Tensor, action: Tensor) -> Tensor:
    var = torch.exp(2 * log_std)
    return (-0.5 * ((action - mean) ** 2 / var + 2 * log_std + math.log(2 * math.pi))).sum(-1)


def gaussian_entropy(log_std: Tensor) -> Tensor:
    return (log_std + 0.5 * math.log(2 * math.pi * math.e)).sum(-1)
