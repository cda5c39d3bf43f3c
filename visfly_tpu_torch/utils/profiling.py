"""Tracing and profiling helpers (counterpart of
``visfly_tpu/utils/profiling.py``): a ``torch.profiler`` trace written for
TensorBoard or Perfetto, and the program's own spans and counters.

Tracing is on exactly while a ``torch.profiler`` records (under
:func:`device_trace`, a benchmark's traced window, or a caller's own
profiler); there is no setting for it. A :func:`span` is then a
``record_function`` range, a ``user_annotation`` event on the same timeline
as the card's kernels, nested in the spans open around it; with no profiler
it is one shared null context. Counters are kept in memory: call sites
count only ``if tracing()``, so with tracing off no counter tensor,
reduction or synchronize exists. Spans, by layer:

    env.dynamics, env.collision, env.reward, env.auto_reset, env.spawn
    render.sensors, render.scene_trace, render.object_hits

Counters: ``spawn.agents`` (agents a spawn draws), ``spawn.redraws`` (the
sum over them of the index of the try the rejection keeps), ``spawn.exhausted``
(those rejected on every tested try), ``reset.respawned``
(agents an auto-reset respawns), ``object_hits.tests`` (ray-triangle tests
of the drones' mesh hits), ``object_hits.candidate_tests`` (those on rays
that meet the object's bounding sphere from outside it).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Union

import torch

_OFF = contextlib.nullcontext()
_counts: Dict[str, Union[int, torch.Tensor]] = {}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and, where a card is present, the card with
    ``torch.profiler``; the chrome trace lands in ``log_dir`` when the block
    ends. Yields the profiler (``key_averages()`` for sums by kernel and by
    span)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def tracing() -> bool:
    """Whether a ``torch.profiler`` is recording in this process."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A named range on the profiler's timeline while tracing; otherwise a
    shared null context that calls into nothing."""
    if tracing():
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: Union[int, torch.Tensor]) -> None:
    """Add ``n`` (a host int or a 0-d tensor, left on its device) to the
    counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Every counter's value; device counters (all on one device) are read
    with one synchronize."""
    out = {k: int(v) for k, v in _counts.items() if not isinstance(v, torch.Tensor)}
    dev = [k for k in _counts if k not in out]
    if dev:
        vals = torch.stack([_counts[k].detach().reshape(()).to(torch.int64) for k in dev])
        out.update(zip(dev, vals.tolist()))
    return out


def reset_counters() -> None:
    _counts.clear()
