"""Camera noise models (counterpart of ``visfly_tpu/render/noise.py``).

A sensor's model comes from ``random_kwargs["noise_kwargs"][uuid] =
{"model": ..., "kwargs": {...}}``. Each function is ``(gen, img, **kwargs)
→ img`` and draws from the ``torch.Generator`` it is given, on the image's
device. Where the images are the block ``rows`` = (start, stop, n) of a
batch of n (an env of ``parallel.make_rank_env``), every draw is the whole
batch's, sliced, so that the blocks together draw what the one batch draws.

Colour models (uint8 images, (N, 3, H, W)):

* ``GaussianNoiseModel``: additive read noise, σ = intensity_constant·255
* ``SaltAndPepperNoiseModel``: dead (0) and saturated (255) pixels
* ``PoissonNoiseModel``: shot noise, the Gaussian approximation
  ``x + sqrt(x)·η``
* ``SpeckleNoiseModel``: multiplicative ``x·(1 + η)``

Depth models ((N, 1, H, W) metres, float):

* ``RedwoodDepthNoiseModel``: lateral jitter, axial noise σ_z(z) =
  0.0012 + 0.0019(z − 0.4)², disparity quantisation and dropout at depth
  discontinuities
* ``GaussianNoiseModel``: additive ``N(mean, sigma)`` metres
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor


Rows = Optional[Tuple[int, int, int]]


def _draw(fn, gen: torch.Generator, like: Tensor, rows: Rows, **kw) -> Tensor:
    """``fn(shape)`` of ``like``'s shape, or of the whole batch's where
    ``like`` is its block ``rows``, sliced."""
    if rows is None:
        return fn(like.shape, generator=gen, device=like.device, **kw)
    lo, hi, n = rows
    return fn((n, *like.shape[1:]), generator=gen, device=like.device, **kw)[lo:hi]


def _normal(gen: torch.Generator, like: Tensor, rows: Rows = None) -> Tensor:
    return _draw(torch.randn, gen, like, rows, dtype=torch.float32)


def _uniform(gen: torch.Generator, like: Tensor, rows: Rows = None) -> Tensor:
    return _draw(torch.rand, gen, like, rows, dtype=torch.float32)


def gaussian(gen: torch.Generator, img: Tensor, intensity_constant: float = 0.2,
             mean: float = 0.0, rows: Rows = None) -> Tensor:
    """Additive Gaussian read noise on uint8 colour."""
    x = img.to(torch.float32)
    noise = _normal(gen, x, rows) * (intensity_constant * 255.0) + mean
    return torch.clamp(x + noise, 0, 255).to(img.dtype)


def salt_and_pepper(gen: torch.Generator, img: Tensor, s_vs_p: float = 0.5,
                    amount: float = 0.05, rows: Rows = None) -> Tensor:
    """Saturated (salt, 255) and dead (pepper, 0) pixels on uint8 colour."""
    u = _uniform(gen, img, rows)
    salt = u < amount * s_vs_p
    pepper = u > 1.0 - amount * (1.0 - s_vs_p)
    out = torch.where(salt, torch.full_like(img, 255), img)
    return torch.where(pepper, torch.zeros_like(img), out)


def poisson(gen: torch.Generator, img: Tensor, intensity_constant: float = 1.0,
            rows: Rows = None) -> Tensor:
    """Shot noise with variance proportional to intensity: the Gaussian
    approximation of Poisson(λ = x·k)/k."""
    x = img.to(torch.float32) * intensity_constant
    noise = _normal(gen, x, rows) * torch.sqrt(torch.clamp(x, min=0.0))
    return torch.clamp((x + noise) / intensity_constant, 0, 255).to(img.dtype)


def speckle(gen: torch.Generator, img: Tensor, mean: float = 0.0, sigma: float = 0.1,
            rows: Rows = None) -> Tensor:
    """Multiplicative speckle x·(1 + η), η ~ N(mean, sigma)."""
    x = img.to(torch.float32)
    noise = _normal(gen, x, rows) * sigma + mean
    return torch.clamp(x * (1.0 + noise), 0, 255).to(img.dtype)


# Redwood/Kinect constants: the baseline·focal product of the disparity model
# and its quantisation steps
_REDWOOD_DISPARITY = 35.130
_REDWOOD_QUANT = 8.0


def redwood_depth(gen: torch.Generator, depth: Tensor, noise_multiplier: float = 1.0,
                  lateral_prob: float = 0.5, dropout_scale: float = 0.25,
                  invalid_value: float = 0.0, rows: Rows = None) -> Tensor:
    """Redwood-style depth noise on metres-valued (N, 1, H, W) maps:

    1. lateral jitter: with probability ``lateral_prob`` a pixel reads a
       neighbour one pixel away (±x or ±y, one of the four at random);
    2. axial noise: z += σ_z(z)·η·noise_multiplier;
    3. disparity quantisation: d = round(35.130/z · 8)/8, z = 35.130/d;
    4. dropout at discontinuities: a pixel whose depth differs from its
       left or upper neighbour by g drops to ``invalid_value`` with
       probability clip(g·dropout_scale, 0, 0.9).

    Draws in this order: the direction, the lateral choice, the axial noise,
    the dropout."""
    z = depth.to(torch.float32)
    pick = _draw(lambda shape, **kw: torch.randint(0, 4, shape, **kw), gen, z, rows)
    lateral = torch.roll(z, 1, dims=-1)
    for i, shifted in enumerate([torch.roll(z, -1, dims=-1), torch.roll(z, 1, dims=-2),
                                 torch.roll(z, -1, dims=-2)]):
        lateral = torch.where(pick == i + 1, shifted, lateral)
    z = torch.where(_uniform(gen, z, rows) < lateral_prob, lateral, z)

    sigma = (0.0012 + 0.0019 * (z - 0.4) ** 2) * noise_multiplier
    z = z + _normal(gen, z, rows) * sigma

    disp = torch.round(_REDWOOD_DISPARITY / torch.clamp(z, min=1e-3) * _REDWOOD_QUANT
                       ) / _REDWOOD_QUANT
    z_q = _REDWOOD_DISPARITY / torch.clamp(disp, min=1e-3)
    z = torch.where(z > 1e-3, z_q, z)

    gx = torch.abs(z - torch.roll(z, 1, dims=-1))
    gy = torch.abs(z - torch.roll(z, 1, dims=-2))
    p_drop = torch.clamp(torch.maximum(gx, gy) * dropout_scale, 0.0, 0.9)
    z = torch.where(_uniform(gen, z, rows) < p_drop, torch.full_like(z, invalid_value), z)
    return z.to(depth.dtype)


def _gaussian_depth(gen: torch.Generator, depth: Tensor, mean: float = 0.0,
                    sigma: float = 0.01, rows: Rows = None) -> Tensor:
    z = depth.to(torch.float32)
    return (z + _normal(gen, z, rows) * sigma + mean).to(depth.dtype)


_RGB_MODELS = {
    "GaussianNoiseModel": gaussian,
    "SaltAndPepperNoiseModel": salt_and_pepper,
    "PoissonNoiseModel": poisson,
    "SpeckleNoiseModel": speckle,
}
_DEPTH_MODELS = {
    "RedwoodDepthNoiseModel": redwood_depth,
    "GaussianNoiseModel": _gaussian_depth,
}


def apply_noise(gen: torch.Generator, uuid: str, img: Tensor,
                settings: Dict[str, Any], rows: Rows = None) -> Tensor:
    """Apply the noise model ``settings[uuid]`` names to a sensor's image: a
    float image takes the depth models, any other the colour models. No
    entry, or the model ``"None"``, leaves the image as it is; an unknown
    model raises ``ValueError``. ``rows``: the images are this block of a
    larger batch, whose draws are made and sliced."""
    spec = settings.get(uuid)
    if not spec:
        return img
    model = spec.get("model", "None")
    if model in (None, "None", "none"):
        return img
    is_depth = img.dtype.is_floating_point
    fn = (_DEPTH_MODELS if is_depth else _RGB_MODELS).get(model)
    if fn is None:
        raise ValueError(f"unknown noise model {model!r} for sensor {uuid!r} "
                         f"({'depth' if is_depth else 'rgb'})")
    return fn(gen, img, rows=rows, **dict(spec.get("kwargs", {})))
