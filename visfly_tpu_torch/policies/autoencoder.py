"""Depth-image convolutional autoencoder and its trainer (counterpart of
``visfly_tpu/policies/autoencoder.py``).

``DepthEncoder`` maps (N, 1, H, W) depth in [0, 1] to a latent vector,
``DepthDecoder`` maps it back, and :func:`train_autoencoder` fits both with
Adam on frames that :func:`collect_depth_frames` gathers from any env with a
depth sensor. Images are NCHW; the JAX modules compute in NHWC, so
``interop.autoencoder_params_from_flax`` permutes the two Dense layers that
meet a flattened image.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .extractors import _init_layer, _lecun_transposed, conv_same, conv_transpose


class DepthEncoder(nn.Module):
    """3×3/2 ``SAME`` convolutions with ReLU (``conv[i]``), flattened, then a
    Dense ``proj`` to ``latent_dim``. ``in_hw`` is the image's (H, W)."""

    def __init__(self, in_hw: Tuple[int, int] = (64, 64), latent_dim: int = 64,
                 channels: Sequence[int] = (16, 32, 64), generator=None):
        super().__init__()
        h, w = in_hw
        c = 1
        self.conv = nn.ModuleList()
        for out_c in channels:
            self.conv.append(_init_layer(nn.Conv2d(c, out_c, 3, stride=2), generator))
            c, h, w = out_c, math.ceil(h / 2), math.ceil(w / 2)
        self.feat_shape = (c, h, w)
        self.proj = _init_layer(nn.Linear(c * h * w, int(latent_dim)), generator)

    def forward(self, x: Tensor) -> Tensor:
        h = x.to(self.proj.weight.dtype)
        for conv in self.conv:
            h = F.relu(conv_same(conv, h))
        return self.proj(h.flatten(1))


class DepthDecoder(nn.Module):
    """A Dense ``proj`` to (C0, H/8, W/8) and ReLU, then 3×3/2 ``SAME``
    transposed convolutions (``deconv[i]``, ReLU between them) up to one
    channel: (N, 1, H, W)."""

    def __init__(self, latent_dim: int = 64, out_hw: Tuple[int, int] = (64, 64),
                 channels: Sequence[int] = (64, 32, 16), generator=None):
        super().__init__()
        scale = 2 ** len(channels)
        self.in_shape = (int(channels[0]), out_hw[0] // scale, out_hw[1] // scale)
        self.proj = _init_layer(nn.Linear(int(latent_dim), math.prod(self.in_shape)), generator)
        chans = list(channels) + [1]
        self.deconv = nn.ModuleList(
            _init_layer(nn.ConvTranspose2d(a, b, 3, stride=2), generator, _lecun_transposed)
            for a, b in zip(chans[:-1], chans[1:]))

    def forward(self, z: Tensor) -> Tensor:
        h = F.relu(self.proj(z).reshape(-1, *self.in_shape))
        for i, layer in enumerate(self.deconv):
            # flax's SAME for k = 3, s = 2 pads the dilated input (2, 1)
            h = conv_transpose(h, layer, 2, 1)
            if i < len(self.deconv) - 1:
                h = F.relu(h)
        return h


class DepthAutoencoder(nn.Module):
    """``encoder`` then ``decoder``; ``encode`` alone gives the latent."""

    def __init__(self, latent_dim: int = 64, out_hw: Tuple[int, int] = (64, 64), generator=None):
        super().__init__()
        self.encoder = DepthEncoder(tuple(out_hw), latent_dim, generator=generator)
        self.decoder = DepthDecoder(latent_dim, tuple(out_hw), generator=generator)

    def forward(self, x: Tensor) -> Tensor:
        return self.decoder(self.encoder(x))

    def encode(self, x: Tensor) -> Tensor:
        return self.encoder(x)


def train_autoencoder(frames: Tensor, latent_dim: int = 64, batch_size: int = 128,
                      n_steps: int = 2000, learning_rate: float = 1e-3, seed: int = 0,
                      log_interval: int = 200, generator: Optional[torch.Generator] = None,
                      batch_idx: Optional[Tensor] = None,
                      model: Optional[DepthAutoencoder] = None
                      ) -> Tuple[DepthAutoencoder, List[float]]:
    """Train on depth frames (M, 1, H, W) in [0, 1] → (model, the loss of
    every step). Each step draws ``batch_size`` frame indices with
    replacement from ``generator`` (default: on the frames' device, seeded
    with ``seed``), or takes row i of ``batch_idx`` (n_steps, batch_size),
    and takes one Adam step on the mean squared reconstruction error.
    ``model`` (default: a new one, its parameters drawn on the CPU from
    ``seed``) is trained in place."""
    dev = frames.device
    if model is None:
        model = DepthAutoencoder(latent_dim, tuple(frames.shape[-2:]),
                                 torch.Generator().manual_seed(seed)).to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate, eps=1e-8)
    losses = []
    for i in range(n_steps):
        idx = (batch_idx[i].to(dev) if batch_idx is not None else
               torch.randint(0, frames.shape[0], (batch_size,), generator=generator, device=dev))
        batch = frames[idx]
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(batch) - batch) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if log_interval and i % log_interval == 0:
            print(f"[autoencoder] step {i} mse={float(loss):.5f}", flush=True)
    return model, [float(x) for x in losses]


@torch.no_grad()
def collect_depth_frames(env, n_frames: int = 1024, gen: Optional[torch.Generator] = None
                         ) -> Tensor:
    """Random-action rollout (actions uniform in [−0.5, 0.5] from ``gen``,
    default: on the env's device, seeded with 0) harvesting depth / 20
    clipped to [0, 1] → (n_frames, 1, H, W). Raises ValueError for an env
    without a depth sensor."""
    if gen is None:
        gen = torch.Generator(device=env.device).manual_seed(0)
    state, _ = env.reset(gen)
    frames, total = [], 0
    while total < n_frames:
        a = torch.rand((env.num_envs, 4), generator=gen, device=env.device) - 0.5
        state, out = env.step(state, a)
        d = out.obs.get("depth")
        if d is None:
            raise ValueError("env has no depth sensor")
        frames.append(torch.clamp(d / 20.0, 0.0, 1.0))
        total += d.shape[0]
    return torch.cat(frames)[:n_frames]
