"""Return and advantage recursions (counterpart of
``visfly_tpu/algos/returns.py``): TD(λ) targets by the reference's Ai / Bi /
λ recursion with done and episode-done masks, and SB3's GAE. Both are exact
backward recursions, a Python loop over the H steps on (N,) tensors where the
JAX package scans.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def compute_td_returns(rewards: Tensor, dones: Tensor, next_values: Tensor,
                       episode_dones: Tensor, gamma: float = 0.99, lam: float = 0.95) -> Tensor:
    """(H, N) TD(λ) targets from (H, N) rewards, dones (bool), the values of
    the next states and episode dones (bool: terminal, not truncated)."""
    ai = torch.zeros_like(rewards[0])
    lam_t = torch.ones_like(rewards[0])
    bi = next_values[-1] * (~dones[-1])
    out = torch.empty_like(rewards)
    for t in reversed(range(rewards.shape[0])):
        active = (~dones[t]).to(rewards.dtype)
        done_f = dones[t].to(rewards.dtype)
        ep_active = (~episode_dones[t]).to(rewards.dtype)
        lam_t = lam_t * lam * active + done_f
        ai = active * (lam * gamma * ai + gamma * next_values[t]
                       + ((1.0 - lam_t) / (1.0 - lam)) * rewards[t])
        bi = gamma * (next_values[t] * done_f * ep_active + bi * active) + rewards[t]
        out[t] = (1.0 - lam) * ai + lam_t * bi
    return out


def compute_gae(rewards: Tensor, values: Tensor, dones: Tensor, last_value: Tensor,
                last_done: Tensor = None, gamma: float = 0.99, gae_lambda: float = 0.95
                ) -> Tuple[Tensor, Tensor]:
    """SB3's GAE → (advantages, returns), each (H, N). ``dones[t]`` marks an
    episode that ended at step t and gates the bootstrap from V(s_{t+1});
    ``last_done`` is accepted for the JAX signature and unused (the final
    step's terminality is ``dones[-1]``)."""
    adv = torch.empty_like(rewards)
    next_adv = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(rewards.shape[0])):
        nonterminal = (~dones[t]).to(rewards.dtype)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        next_adv = delta + gamma * gae_lambda * nonterminal * next_adv
        adv[t] = next_adv
        next_value = values[t]
    return adv, adv + values
