"""Recurrent world model (RSSM) behind the envs' latent hooks (counterpart of
``visfly_tpu/policies/world_model.py``).

An env with latents (``initialize_latent(deter, stoch, world)``) carries a
deterministic state ``deter`` and a stochastic one ``stoch`` per agent and
hands them out as observations; with a world model attached, each step
updates them by the posterior, :meth:`WorldModel.step`.

Randomness: where the JAX modules take a PRNG key, these take a
``torch.Generator`` to draw the Gaussian noise from, or the noise itself
(``noise``, of the mean's shape) so that a test can hand both packages the
same draws. With ``deterministic=True``, or with neither generator nor noise,
the mean is returned, as the JAX modules return it without a key.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .extractors import MLP, GRUCell, MultiInputExtractor, _init_layer


def _sample(mean: Tensor, log_std: Tensor, generator, noise, deterministic: bool) -> Tensor:
    if deterministic or (generator is None and noise is None):
        return mean
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                            device=mean.device)
    return mean + torch.exp(log_std) * noise


class _GaussianOut(nn.Module):
    """``mean`` and ``log_std`` Dense heads, the log-std clipped to [−5, 2]."""

    def __init__(self, in_features: int, out_features: int, generator=None):
        super().__init__()
        self.mean = _init_layer(nn.Linear(in_features, out_features), generator)
        self.log_std = _init_layer(nn.Linear(in_features, out_features), generator)

    def forward(self, h: Tensor, generator=None, deterministic: bool = False,
                noise: Optional[Tensor] = None) -> Tensor:
        return _sample(self.mean(h), torch.clamp(self.log_std(h), -5.0, 2.0), generator, noise,
                       deterministic)


class SequenceModel(nn.Module):
    """Deterministic GRU core and stochastic prior: (action, stoch, deter) →
    (stoch prior, deter'). ``inp`` (Dense + ReLU on [action | stoch]) →
    ``gru`` → ``hid`` (Dense + ReLU) → ``out`` (mean, log-std)."""

    def __init__(self, action_dim: int = 4, deter_dim: int = 128, stoch_dim: int = 32,
                 hidden: int = 128, generator=None):
        super().__init__()
        self.deter_dim, self.stoch_dim = int(deter_dim), int(stoch_dim)
        self.inp = _init_layer(nn.Linear(int(action_dim) + self.stoch_dim, hidden), generator)
        self.gru = GRUCell(hidden, self.deter_dim, generator)
        self.hid = _init_layer(nn.Linear(self.deter_dim, hidden), generator)
        self.out = _GaussianOut(hidden, self.stoch_dim, generator)

    def forward(self, action: Tensor, stoch: Tensor, deter: Tensor, generator=None,
                deterministic: bool = False, noise: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        x = F.relu(self.inp(torch.cat([action, stoch], dim=-1)))
        deter = self.gru(x, deter)
        prior = self.out(F.relu(self.hid(deter)), generator, deterministic, noise)
        return prior, deter

    def initial(self, batch: int) -> Dict[str, Tensor]:
        w = self.inp.weight
        return {"deter": w.new_zeros((batch, self.deter_dim)),
                "stoch": w.new_zeros((batch, self.stoch_dim))}


class Encoder(nn.Module):
    """Posterior: (observation, deter) → stoch. ``obs_extractor`` (a
    ``MultiInputExtractor`` over ``obs_shapes``), then ``hid`` (Dense + ReLU
    on [features | deter]) → ``out`` (mean, log-std)."""

    def __init__(self, obs_shapes: Dict[str, Sequence[int]], deter_dim: int = 128,
                 stoch_dim: int = 32, hidden: int = 128,
                 net_arch: Optional[Dict[str, dict]] = None, generator=None):
        super().__init__()
        self.obs_extractor = MultiInputExtractor(obs_shapes, net_arch, generator=generator)
        self.hid = _init_layer(nn.Linear(self.obs_extractor.out_features + int(deter_dim),
                                         hidden), generator)
        self.out = _GaussianOut(hidden, int(stoch_dim), generator)

    def forward(self, observation: Dict[str, Tensor], deter: Tensor, generator=None,
                deterministic: bool = False, noise: Optional[Tensor] = None) -> Tensor:
        h = torch.cat([self.obs_extractor(observation), deter], dim=-1)
        return self.out(F.relu(self.hid(h)), generator, deterministic, noise)


class Decoder(nn.Module):
    """Features → flat observation reconstruction: ``mlp`` then ``out``."""

    def __init__(self, in_features: int, out_dim: int = 13, hidden: Sequence[int] = (128, 128),
                 generator=None):
        super().__init__()
        self.mlp = MLP(in_features, hidden, generator=generator)
        self.out = _init_layer(nn.Linear(self.mlp.out_features, int(out_dim)), generator)

    def forward(self, features: Tensor) -> Tensor:
        return self.out(self.mlp(features))


class WorldModel(nn.Module):
    """The three parts, ``sequence``, ``encoder`` and ``decoder`` (the JAX
    bundle's three parameter trees), and the calls an env makes."""

    def __init__(self, sequence: SequenceModel, encoder: Encoder, decoder: Decoder):
        super().__init__()
        self.sequence, self.encoder, self.decoder = sequence, encoder, decoder

    @staticmethod
    def get_features(deter: Tensor, stoch: Tensor) -> Tensor:
        return torch.cat([deter, stoch], dim=-1)

    def step(self, action, stoch, deter, next_observation, generator=None,
             deterministic: bool = False, noise: Optional[Tuple[Tensor, Tensor]] = None
             ) -> Tuple[Tensor, Tensor]:
        """Posterior latent update → (stoch posterior, deter'). The prior's
        noise is drawn first and the posterior's second (``noise`` = the
        pair), as the JAX model splits its key."""
        n_prior, n_post = (None, None) if noise is None else noise
        _prior, next_deter = self.sequence(action, stoch, deter, generator, deterministic,
                                           n_prior)
        post = self.encoder(next_observation, next_deter, generator, deterministic, n_post)
        return post, next_deter

    def imagine(self, action, stoch, deter, generator=None, deterministic: bool = False,
                noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """Prior rollout step → (stoch prior, deter')."""
        return self.sequence(action, stoch, deter, generator, deterministic, noise)

    def decode(self, deter: Tensor, stoch: Tensor) -> Tensor:
        return self.decoder(self.get_features(deter, stoch))


def create_world_model(obs_example: Dict[str, Tensor], action_dim: int = 4,
                       deter_dim: int = 128, stoch_dim: int = 32, decode_key: str = "state",
                       generator: Optional[torch.Generator] = None) -> WorldModel:
    """A world model for observations shaped like ``obs_example`` (a batch),
    on their device; the parameters are drawn on the CPU from ``generator``
    (default: seeded with 0)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    shapes = {k: tuple(v.shape[1:]) for k, v in obs_example.items()}
    device = next(iter(obs_example.values())).device
    seq = SequenceModel(action_dim, deter_dim, stoch_dim, generator=generator)
    enc = Encoder(shapes, deter_dim, stoch_dim, generator=generator)
    dec = Decoder(deter_dim + stoch_dim, obs_example[decode_key].shape[-1], generator=generator)
    return WorldModel(seq, enc, dec).to(device)
