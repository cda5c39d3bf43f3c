"""Device-resident replay buffer (counterpart of
``visfly_tpu/algos/buffers.py``): a preallocated ring of transitions on the
env's device, so that off-policy training never copies to the host.

The functions take and return a ``ReplayBuffer`` as the JAX package's do, but
``insert`` writes into the buffer's tensors in place (a copy of half a million
rows a step would cost more than the step); the returned buffer holds the same
tensors and the new ring position. ``pos`` and ``full`` are Python values, so
the sampled range is known on the host. Indices are drawn from a
``torch.Generator`` on the buffer's device, uniform over the filled rows.

A rank's block (``create(..., rows=(start, stop, n))``, data-parallel SAC):
every step writes n transitions into a ring of ``capacity`` rows, write
counter c into row c mod capacity, and a rank holds only the writes of its
agents start..stop. Its buffer keeps the ring's global position (``pos``,
``full`` and ``writes``, the count of writes so far), so every rank samples
the same global rows, and stores its agents' writes of the last
⌈capacity / n⌉ steps, which hold every write still in the ring:
⌈capacity / n⌉ · (stop − start) rows, its share of the ring plus at most
one step. Global row r holds the newest write c_r ≡ r (mod capacity), of
agent c_r mod n, so the owner of a row follows the writes even where the
capacity is not a multiple of n. :func:`held` says which of a sample's rows
a block holds and where.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

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
    writes: int = 0  # transitions written so far, over all blocks
    block: Any = ()  # (start, stop, n, capacity) when it holds a block's rows


def create(capacity: int, obs_example: Dict[str, Tensor], action_dim: int,
           store_full_state: bool = False,
           rows: Optional[Tuple[int, int, int]] = None) -> ReplayBuffer:
    """An empty buffer of ``capacity`` rows shaped like ``obs_example``'s
    rows, on its device; with ``rows`` = (start, stop, n) of a step's n
    transitions, the ring of a block (see the module docstring)."""
    dev = next(iter(obs_example.values())).device
    block, length = (), int(capacity)
    if rows is not None and rows[1] - rows[0] < rows[2]:
        lo, hi, n = rows
        block, length = (lo, hi, n, int(capacity)), -(-int(capacity) // n) * (hi - lo)

    def alloc(x):
        return torch.zeros((length,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)

    return ReplayBuffer(
        obs={k: alloc(v) for k, v in obs_example.items()},
        next_obs={k: alloc(v) for k, v in obs_example.items()},
        actions=torch.zeros((length, action_dim), device=dev),
        rewards=torch.zeros((length,), device=dev),
        dones=torch.zeros((length,), dtype=torch.bool, device=dev),
        pos=0,
        full=False,
        full_states=torch.zeros((length, 22), device=dev) if store_full_state else (),
        block=block,
    )


def capacity(buf: ReplayBuffer) -> int:
    """Rows of the (global) ring."""
    return buf.block[3] if buf.block else buf.rewards.shape[0]


def size(buf: ReplayBuffer) -> int:
    return capacity(buf) if buf.full else buf.pos


def nbytes(buf: ReplayBuffer) -> int:
    """Bytes the buffer's tensors hold."""
    ts = [*buf.obs.values(), *buf.next_obs.values(), buf.actions, buf.rewards, buf.dones]
    if isinstance(buf.full_states, Tensor):
        ts.append(buf.full_states)
    return sum(t.numel() * t.element_size() for t in ts)


def insert(buf: ReplayBuffer, obs, next_obs, action, reward, done,
           full_state: Optional[Tensor] = None) -> ReplayBuffer:
    """Write a batch of N transitions at the ring position (in place); a
    block's buffer is given its agents' transitions of the step."""
    k = reward.shape[0]
    cap = capacity(buf)
    arange = torch.arange(k, device=buf.rewards.device)
    if buf.block:
        lo, hi, n, _ = buf.block
        if k != hi - lo:
            raise ValueError(f"{k} transitions for a block of {hi - lo} agents")
        laps = buf.rewards.shape[0] // k  # the steps whose writes it keeps
        idx = (buf.writes // n) % laps * k + arange
    else:
        n = k
        idx = (buf.pos + arange) % cap

    def put(store, x):
        store.index_copy_(0, idx, x.detach().to(store.dtype))

    for key in buf.obs:
        put(buf.obs[key], obs[key])
        put(buf.next_obs[key], next_obs[key])
    put(buf.actions, action)
    put(buf.rewards, reward)
    put(buf.dones, done)
    if full_state is not None and isinstance(buf.full_states, Tensor):
        put(buf.full_states, full_state)
    return buf._replace(pos=(buf.pos + n) % cap, full=buf.full or buf.pos + n >= cap,
                        writes=buf.writes + n)


def sample_indices(buf: ReplayBuffer, gen: torch.Generator, n: int) -> Tensor:
    """``n`` row indices uniform over the filled rows (at least row 0)."""
    upper = max(size(buf), 1)
    return torch.randint(0, upper, (n,), generator=gen, device=buf.rewards.device)


def held(buf: ReplayBuffer, idx: Tensor) -> Tuple[Optional[Tensor], Tensor]:
    """Of the ring rows ``idx``, which this buffer holds and where → (mask
    over ``idx``, or None where it holds them all; the held rows' places in
    its tensors, in ``idx``'s order)."""
    if not buf.block:
        return None, idx
    lo, hi, n, cap = buf.block
    k = hi - lo
    laps = buf.rewards.shape[0] // k
    # the newest write of each row; an empty ring's row 0 as write 0
    c = torch.clamp(idx + cap * torch.div(buf.writes - 1 - idx, cap, rounding_mode="floor"),
                    min=0)
    step, agent = c // n, c % n
    mine = (agent >= lo) & (agent < hi)
    return mine, step[mine] % laps * k + (agent[mine] - lo)


def take(buf: ReplayBuffer, idx: Tensor):
    """(obs, next_obs, actions, rewards, dones) of the buffer's rows ``idx``
    (places in its tensors, :func:`held`)."""
    return ({k: v[idx] for k, v in buf.obs.items()},
            {k: v[idx] for k, v in buf.next_obs.items()},
            buf.actions[idx], buf.rewards[idx], buf.dones[idx])


def sample(buf: ReplayBuffer, gen: Optional[torch.Generator], batch_size: int,
           idx: Optional[Tensor] = None):
    """(obs, next_obs, actions, rewards, dones) of ``batch_size`` ring rows
    drawn from ``gen``, or of the ring rows ``idx``: of those a block's
    buffer holds."""
    if idx is None:
        idx = sample_indices(buf, gen, batch_size)
    return take(buf, held(buf, idx)[1])


def sample_full_states(buf: ReplayBuffer, gen: torch.Generator, n: int) -> Tensor:
    """Stored dynamics states of ``n`` ring rows, for resets from the
    buffer: of those a block's buffer holds."""
    return buf.full_states[held(buf, sample_indices(buf, gen, n))[1]]
