"""Debugging helpers: network weight statistics (counterpart of
``visfly_tpu/utils/debug.py``) over an ``nn.Module``'s parameters or a
trainer state's ``{name: tensor}`` dict."""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
from torch import nn


def _named_arrays(params: Any) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, float32 array) of each parameter; dotted module names become
    '/'-joined as in the JAX package's parameter paths."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    for name, p in params.items():
        if isinstance(p, dict):
            for sub, arr in _named_arrays(p):
                yield f"{name}/{sub}", arr
        else:
            yield str(name).replace(".", "/"), p.detach().cpu().numpy()


def get_network_statistics(params: Any, logger=None, prefix: str = "weights",
                           is_record: bool = True) -> Dict[str, float]:
    """Per-tensor mean/std/absmax of the parameters; optionally records
    them into a Logger."""
    stats: Dict[str, float] = {}
    for name, arr in _named_arrays(params):
        stats[f"{prefix}/{name}/mean"] = float(arr.mean())
        stats[f"{prefix}/{name}/std"] = float(arr.std())
        stats[f"{prefix}/{name}/absmax"] = float(np.abs(arr).max())
    if logger is not None and is_record:
        for k, v in stats.items():
            logger.record(k, v)
    return stats


def check_nan_parameters(params: Any) -> Dict[str, bool]:
    """Which parameters hold only finite values (False marks a NaN or an
    infinity)."""
    return {name: bool(np.isfinite(arr).all()) for name, arr in _named_arrays(params)}
