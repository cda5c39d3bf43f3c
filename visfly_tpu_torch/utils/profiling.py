"""Tracing and profiling helpers (counterpart of
``visfly_tpu/utils/profiling.py``): a ``torch.profiler`` trace written for
TensorBoard or Perfetto, and a per-phase step timer that waits for the card
before it reads the clock."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the host and, where a card is present, the card with
    ``torch.profiler``; the chrome trace lands in ``log_dir`` when the block
    ends. Yields the profiler (``key_averages()`` for sums by kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _synchronize(x) -> None:
    """Wait for every card that holds a tensor of ``x`` (a tensor or a
    nested tuple, list or dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _synchronize(v)
    elif isinstance(x, dict):
        for v in x.values():
            _synchronize(v)


class StepTimer:
    """Accumulate wall-clock per named phase; ``sync_on`` (tensors the phase
    produced) makes the timer wait for the card first, so timings are honest
    under asynchronous launches."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            _synchronize(sync_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}

    def report(self) -> str:
        return " | ".join(f"{k}: {v * 1e3:.2f} ms" for k, v in sorted(self.summary().items()))
