"""Learning-rate schedules (counterpart of
``visfly_tpu/algos/lr_scheduler.py``): callables from the update count,
starting at 0, to the rate, with the formulas of the optax schedules the JAX
package builds.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Union


def linear_schedule(initial: float, final: float = 0.0, total_steps: int = 1):
    def schedule(step):
        frac = min(max(step / total_steps, 0.0), 1.0)
        return initial + (final - initial) * frac

    return schedule


def exponential_schedule(initial: float, decay_rate: float = 0.99,
                         transition_steps: int = 1000):
    return lambda step: initial * decay_rate ** (step / transition_steps)


def cosine_schedule(initial: float, total_steps: int = 1, final_scale: float = 0.0):
    def schedule(step):
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(step, total_steps) / total_steps))
        return initial * ((1.0 - final_scale) * cosine + final_scale)

    return schedule


def transfer_schedule(cfg: Union[float, dict, Callable]) -> Any:
    """Dict-config dispatcher: a float is constant, a dict {"class": "linear" |
    "exponential" | "cosine", "kwargs": {…}} builds the schedule, a callable
    passes through."""
    if callable(cfg):
        return cfg
    if isinstance(cfg, (int, float)):
        return float(cfg)
    cls = cfg["class"].lower()
    kw = cfg.get("kwargs", {})
    if cls in ("linear",):
        return linear_schedule(**kw)
    if cls in ("exponential", "exp"):
        return exponential_schedule(**kw)
    if cls in ("cosine",):
        return cosine_schedule(**kw)
    raise ValueError(f"unknown schedule {cls!r}")
