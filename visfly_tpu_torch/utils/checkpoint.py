"""Full training-state checkpoints (counterpart of
``visfly_tpu/utils/checkpoint.py``).

A trainer's state is a NamedTuple whose fields hold the networks' parameters
(the modules' own tensors, updated in place), the trainer's ``AdamChain``
optimisers, the env state with its ``torch.Generator``, the observation,
generators, counters, and per trainer the episode window, the GRU hidden
state, ``log_alpha`` or the replay ring. :func:`save_train_state` writes every
field with ``torch.save`` as plain containers: tensors (on the CPU), dicts,
lists, tuples and scalars; a generator as ``{"generator_state": bytes}`` from
``get_state()``, an ``AdamChain`` as its step count and Adam's
``state_dict()``. So ``torch.load(..., weights_only=True)`` reads the file.
:func:`save_pytree` and :func:`load_pytree` do the same for any nested
structure of tensors, restored into a template's shape as below.

:func:`load_train_state` restores into a template state built by the
trainer's ``init()``, field by field: a field whose structure and tensor
shapes match the template's is restored, any other keeps the template's
value and is listed as skipped (loading a trained policy into an eval env of
another size keeps the eval env's state). Parameters, and every tensor that
requires a gradient, are written in place (``copy_``), so the modules and the
optimisers keep the tensors they hold; an ``AdamChain`` restores Adam's
moments and its step count, which drives the learning-rate schedule; a
generator is made anew on the template generator's device and given the
saved state.
"""
from __future__ import annotations

import os
from typing import Any, List, Tuple

import torch
from torch import Tensor, nn

from ..algos.common import AdamChain

SUFFIX = ".pt"
_GEN = "generator_state"
_ADAM = ("adam_count", "adam_state")

_SCALARS = (bool, int, float, str, type(None))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_payload(x: Any) -> Any:
    """A state (or any part of one) → plain containers of CPU tensors."""
    if isinstance(x, Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, torch.Generator):
        return {_GEN: x.get_state()}
    if isinstance(x, AdamChain):
        return {_ADAM[0]: x.count, _ADAM[1]: to_payload(x.adam.state_dict())}
    if _is_namedtuple(x):
        return {f: to_payload(getattr(x, f)) for f in x._fields}
    if isinstance(x, dict):
        return {k: to_payload(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_payload(v) for v in x]
    if isinstance(x, tuple):
        return tuple(to_payload(v) for v in x)
    if isinstance(x, _SCALARS):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def save_train_state(path: str, st: Any) -> str:
    """Every field of the trainer state ``st`` → ``path`` (``.pt`` appended
    unless present); returns the file's path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    p = path if path.endswith(SUFFIX) else path + SUFFIX
    torch.save({f: to_payload(getattr(st, f)) for f in st._fields}, p)
    return p


def _adam_compatible(saved: Any, chain: AdamChain) -> bool:
    if not (isinstance(saved, dict) and set(saved) == set(_ADAM)):
        return False
    sd = saved[_ADAM[1]]
    groups = chain.adam.param_groups
    if (not isinstance(sd, dict) or len(sd.get("param_groups", ())) != len(groups)
            or any(len(s["params"]) != len(g["params"])
                   for s, g in zip(sd["param_groups"], groups))):
        return False
    for idx, moments in sd.get("state", {}).items():
        if not 0 <= idx < len(chain.params):
            return False
        shape = chain.params[idx].shape
        if any(isinstance(v, Tensor) and v.dim() and v.shape != shape
               for v in moments.values()):
            return False
    return True


def _compatible(saved: Any, tmpl: Any) -> bool:
    """Same structure and tensor shapes as the template."""
    if isinstance(tmpl, Tensor):
        return isinstance(saved, Tensor) and saved.shape == tmpl.shape
    if isinstance(tmpl, torch.Generator):
        return (isinstance(saved, dict) and set(saved) == {_GEN}
                and saved[_GEN].shape == tmpl.get_state().shape)
    if isinstance(tmpl, AdamChain):
        return _adam_compatible(saved, tmpl)
    if _is_namedtuple(tmpl):
        return (isinstance(saved, dict) and set(saved) == set(tmpl._fields)
                and all(_compatible(saved[f], getattr(tmpl, f)) for f in tmpl._fields))
    if isinstance(tmpl, dict):
        return (isinstance(saved, dict) and set(saved) == set(tmpl)
                and all(_compatible(saved[k], v) for k, v in tmpl.items()))
    if isinstance(tmpl, (list, tuple)):
        return (isinstance(saved, (list, tuple)) and len(saved) == len(tmpl)
                and all(_compatible(s, t) for s, t in zip(saved, tmpl)))
    return isinstance(saved, _SCALARS) and isinstance(tmpl, _SCALARS)


def _restore(saved: Any, tmpl: Any) -> Any:
    """The template with the saved values; see the module docstring for what
    is written in place. Call only where :func:`_compatible` holds."""
    if isinstance(tmpl, Tensor):
        value = asarray_like(saved, tmpl)
        if isinstance(tmpl, nn.Parameter) or tmpl.requires_grad:
            with torch.no_grad():
                tmpl.copy_(value)
            return tmpl
        return value
    if isinstance(tmpl, torch.Generator):
        gen = torch.Generator(device=tmpl.device)
        gen.set_state(saved[_GEN])
        return gen
    if isinstance(tmpl, AdamChain):
        tmpl.adam.load_state_dict(saved[_ADAM[1]])
        tmpl.count = int(saved[_ADAM[0]])
        return tmpl
    if _is_namedtuple(tmpl):
        return type(tmpl)(**{f: _restore(saved[f], getattr(tmpl, f)) for f in tmpl._fields})
    if isinstance(tmpl, dict):
        return {k: _restore(saved[k], v) for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        return type(tmpl)(_restore(s, t) for s, t in zip(saved, tmpl))
    return saved


def _resolve(path: str) -> str:
    """``path`` if it exists, else ``path`` with the suffix the saver adds."""
    if not os.path.exists(path) and os.path.exists(path + SUFFIX):
        return path + SUFFIX
    return path


def save_pytree(path: str, tree: Any) -> str:
    """Any nested structure of tensors (NamedTuples, dicts, lists, tuples,
    scalars, generators) → ``path`` (``.pt`` appended unless present), as
    plain containers of CPU tensors; returns the file's path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    p = path if path.endswith(SUFFIX) else path + SUFFIX
    torch.save(to_payload(tree), p)
    return p


def asarray_like(saved: Any, tmpl: Any) -> Any:
    """A saved leaf cast to the template leaf's dtype and device where both
    are arrays; any other leaf as saved."""
    if isinstance(tmpl, Tensor) and hasattr(saved, "dtype"):
        return torch.as_tensor(saved).to(device=tmpl.device, dtype=tmpl.dtype)
    return saved


def load_pytree(path: str, template: Any) -> Any:
    """The structure saved by :func:`save_pytree`, restored into the shape of
    ``template`` (same structure and tensor shapes, else ``ValueError``):
    each tensor on the template leaf's device and in its dtype, written in
    place where the template's tensor requires a gradient, as
    :func:`load_train_state` restores parameters."""
    p = _resolve(path)
    saved = torch.load(p, map_location="cpu", weights_only=True)
    if not _compatible(saved, template):
        raise ValueError(f"{p} does not match the template's structure and shapes")
    return _restore(saved, template)


def load_train_state(path: str, st_template: Any) -> Tuple[Any, List[str]]:
    """Restore a state saved by :func:`save_train_state` into the template
    state → (state, names of the fields kept from the template)."""
    p = _resolve(path)
    payload = torch.load(p, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or not _is_namedtuple(st_template):
        raise ValueError(f"not a train-state checkpoint: {p}")
    updates, skipped = {}, []
    for field in st_template._fields:
        tmpl = getattr(st_template, field)
        if field in payload and _compatible(payload[field], tmpl):
            updates[field] = _restore(payload[field], tmpl)
        else:
            updates[field] = tmpl
            skipped.append(field)
    return type(st_template)(**updates), skipped


def unique_path(base: str, comment: str | None, name: str) -> str:
    """Auto-incrementing save path ``{base}/{name}_{comment}_{i}``: the first
    ``i`` from 1 that names neither an entry of ``base`` nor a checkpoint
    file (``.pt``) there."""
    index = 1
    stem = f"{name}_{comment}" if comment else name
    path = os.path.join(base, f"{stem}_{index}")
    while os.path.exists(path) or os.path.exists(path + SUFFIX):
        index += 1
        path = os.path.join(base, f"{stem}_{index}")
    return path
