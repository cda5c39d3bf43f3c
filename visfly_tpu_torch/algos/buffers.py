"""Device-resident replay buffer (counterpart of
``visfly_tpu/algos/buffers.py``): a preallocated ring of transitions on the
env's device, so that off-policy training never copies to the host.

The functions take and return a ``ReplayBuffer`` as the JAX package's do, but
``insert`` writes into the buffer's tensors in place (a copy of half a million
rows a step would cost more than the step); the returned buffer holds the same
tensors and the new ring position. ``pos`` and ``full`` are Python values, so
the sampled range is known on the host. Indices are drawn from a
``torch.Generator`` on the buffer's device, uniform over the filled rows.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import Tensor


class ReplayBuffer(NamedTuple):
    obs: Dict[str, Tensor]  # (C, ...) each
    next_obs: Dict[str, Tensor]
    actions: Tensor  # (C, A)
    rewards: Tensor  # (C,)
    dones: Tensor  # (C,) bool: terminal, not timeout (SB3's convention)
    pos: int  # next write index
    full: bool
    full_states: Any = ()  # (C, 22) dynamics states, for resets from the buffer


def create(capacity: int, obs_example: Dict[str, Tensor], action_dim: int,
           store_full_state: bool = False) -> ReplayBuffer:
    """An empty buffer of ``capacity`` rows shaped like ``obs_example``'s
    rows, on its device."""
    dev = next(iter(obs_example.values())).device

    def alloc(x):
        return torch.zeros((capacity,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)

    return ReplayBuffer(
        obs={k: alloc(v) for k, v in obs_example.items()},
        next_obs={k: alloc(v) for k, v in obs_example.items()},
        actions=torch.zeros((capacity, action_dim), device=dev),
        rewards=torch.zeros((capacity,), device=dev),
        dones=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        pos=0,
        full=False,
        full_states=torch.zeros((capacity, 22), device=dev) if store_full_state else (),
    )


def size(buf: ReplayBuffer) -> int:
    return buf.rewards.shape[0] if buf.full else buf.pos


def insert(buf: ReplayBuffer, obs, next_obs, action, reward, done,
           full_state: Optional[Tensor] = None) -> ReplayBuffer:
    """Write a batch of N transitions at the ring position (in place)."""
    n = reward.shape[0]
    capacity = buf.rewards.shape[0]
    idx = (buf.pos + torch.arange(n, device=buf.rewards.device)) % capacity

    def put(store, x):
        store.index_copy_(0, idx, x.detach().to(store.dtype))

    for k in buf.obs:
        put(buf.obs[k], obs[k])
        put(buf.next_obs[k], next_obs[k])
    put(buf.actions, action)
    put(buf.rewards, reward)
    put(buf.dones, done)
    if full_state is not None and isinstance(buf.full_states, Tensor):
        put(buf.full_states, full_state)
    return buf._replace(pos=(buf.pos + n) % capacity, full=buf.full or buf.pos + n >= capacity)


def sample_indices(buf: ReplayBuffer, gen: torch.Generator, n: int) -> Tensor:
    """``n`` row indices uniform over the filled rows (at least row 0)."""
    upper = max(size(buf), 1)
    return torch.randint(0, upper, (n,), generator=gen, device=buf.rewards.device)


def sample(buf: ReplayBuffer, gen: Optional[torch.Generator], batch_size: int,
           idx: Optional[Tensor] = None):
    """(obs, next_obs, actions, rewards, dones) of ``batch_size`` rows drawn
    from ``gen``, or of the rows ``idx``."""
    if idx is None:
        idx = sample_indices(buf, gen, batch_size)
    return ({k: v[idx] for k, v in buf.obs.items()},
            {k: v[idx] for k, v in buf.next_obs.items()},
            buf.actions[idx], buf.rewards[idx], buf.dones[idx])


def sample_full_states(buf: ReplayBuffer, gen: torch.Generator, n: int) -> Tensor:
    """Stored dynamics states of ``n`` rows, for resets from the buffer."""
    return buf.full_states[sample_indices(buf, gen, n)]
