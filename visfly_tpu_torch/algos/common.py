"""Shared trainer plumbing (counterpart of ``visfly_tpu/algos/common.py``):
the differentiable-env requirement, deterministic evaluation rollouts, the
hooks a stateful policy overrides, the optimiser every trainer uses
(``AdamChain``: optax's global-norm clip, then Adam or AdamW at a schedule's
rate), metric logs (``utils/logger.py``) and full-state checkpoints for an
exact resume (``utils/checkpoint.py``): every field of a trainer's state,
its networks' parameters, its optimisers' moments and step counts, the env
state and every generator.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
from torch import Tensor, nn

from .lr_scheduler import transfer_schedule


def clip_grads_(params: Iterable[Tensor], max_norm: Optional[float]) -> Tensor:
    """Scale the gradients of ``params`` to the global norm ``max_norm`` as
    optax's ``clip_by_global_norm`` does (scale = max_norm / max(norm,
    max_norm); ``clip_grad_norm_`` would divide by norm + 1e-6) and return the
    norm before the clip. ``max_norm=None`` only measures."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if max_norm is not None:
        scale = max_norm / torch.clamp(norm, min=max_norm)
        for g in grads:
            g.mul_(scale)
    return norm


class AdamChain:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(schedule))``
    over ``params``: no clip when ``max_grad_norm`` is None, and with a
    ``weight_decay`` AdamW, whose decoupled decay is optax's ``adamw``'s
    (both scale the decay by the rate). Adam's eps is 1e-8 outside the root
    in both packages. The rate is the schedule's at the count of steps taken
    so far, as optax counts them."""

    def __init__(self, params: Iterable[Tensor], learning_rate,
                 max_grad_norm: Optional[float] = None, weight_decay: float = 0.0):
        self.params = list(params)
        self.schedule = transfer_schedule(learning_rate)
        self.max_grad_norm = None if max_grad_norm is None else float(max_grad_norm)
        self.count = 0
        if weight_decay:
            self.adam = torch.optim.AdamW(self.params, lr=self.lr(), eps=1e-8,
                                          weight_decay=float(weight_decay))
        else:
            self.adam = torch.optim.Adam(self.params, lr=self.lr(), eps=1e-8)

    def lr(self) -> float:
        return float(self.schedule(self.count)) if callable(self.schedule) else self.schedule

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> Tensor:
        """Clip the gradients, step at the current rate → the norm before the
        clip."""
        norm = clip_grads_(self.params, self.max_grad_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.lr()
        self.adam.step()
        self.count += 1
        return norm


def frozen_copy(module: nn.Module) -> nn.Module:
    """A copy of ``module`` that no optimiser trains: a target network."""
    target = copy.deepcopy(module)
    target.requires_grad_(False)
    return target


@torch.no_grad()
def polyak_(target: nn.Module, source: nn.Module, tau: float) -> None:
    """target ← (1 − τ)·target + τ·source, parameter by parameter."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.mul_(1.0 - tau).add_(s, alpha=tau)


class TrainerMixin:
    """Requires: self.env, self.predict(st, obs)."""

    @staticmethod
    def _require_grad_env(env) -> None:
        """Analytic-gradient trainers need a differentiable env: the flag is
        flipped here, as the reference does inside the algorithm. ``step``
        reads it at every call."""
        if not env.requires_grad:
            env.requires_grad = True

    def make_logger(self, log_dir: Optional[str] = None,
                    formats=("stdout", "csv", "tensorboard")):
        from ..utils.logger import Logger

        return Logger(log_dir, formats) if log_dir else None

    def evaluate(self, st, eval_env=None, max_steps: int = 1024,
                 gen: Optional[torch.Generator] = None) -> Dict[str, float]:
        """Deterministic rollout, without auto-reset, until all agents finish
        or ``max_steps``; returns episode stats."""
        env = eval_env if eval_env is not None else self.env
        if gen is None:
            gen = torch.Generator(device=env.device).manual_seed(1234)
        n = env.num_envs
        all_done = np.zeros(n, bool)
        returns = np.zeros(n)
        lengths = np.zeros(n, np.int32)
        success = np.zeros(n, bool)
        with torch.no_grad():
            env_state, obs = env.reset(gen)
            carry = self.init_predict_carry(obs)
            for _ in range(max_steps):
                action, carry = self.predict_step(st, obs, carry)
                env_state, out = env.step(env_state, action, is_test=True)
                obs = out.obs
                carry = self.mask_predict_carry(carry, out.done)
                active = ~all_done
                returns += out.reward.cpu().numpy() * active
                lengths += active.astype(np.int32)
                success |= out.info["is_success"].cpu().numpy() & active
                all_done |= out.done.cpu().numpy()
                if all_done.all():
                    break
        return {
            "eval/ep_rew_mean": float(returns.mean()),
            "eval/ep_len_mean": float(lengths.mean()),
            "eval/success_rate": float(success.mean()),
        }

    # recurrent-policy hooks: trainers with a stateful policy (GRU hidden)
    # override these so that evaluation threads the hidden state through the
    # rollout instead of re-using a frozen one.
    def init_predict_carry(self, obs):
        return ()

    def predict_step(self, st, obs, carry):
        return self.predict(st, obs), carry

    def mask_predict_carry(self, carry, done):
        return carry

    # -- exact-resume checkpoints ---------------------------------------------
    def save(self, st, path: str) -> str:
        """Every field of the state → ``path`` (``.pt``); returns the file."""
        from ..utils.checkpoint import save_train_state

        return save_train_state(path, st)

    def load(self, st, path: str):
        """The state saved at ``path`` restored into ``st``, a state of this
        trainer (from ``init()``); fields whose shapes do not match (the env's
        when the env differs in size) keep ``st``'s values and are printed."""
        from ..utils.checkpoint import load_train_state

        new_st, skipped = load_train_state(path, st)
        if skipped:
            print(f"[{type(self).__name__}] checkpoint fields kept from the fresh init "
                  f"(shape/structure mismatch): {skipped}", flush=True)
        return new_st

    def save_interrupt_cache(self, st, log_dir: Optional[str] = None) -> str:
        """The checkpoint taken on Ctrl-C, at
        ``{log_dir or ./saved}/{trainer}_interrupt_cache``; returns that path."""
        folder = log_dir or os.path.join(os.getcwd(), "saved")
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, f"{type(self).__name__.lower()}_interrupt_cache")
        self.save(st, path)
        print(f"[{type(self).__name__}] interrupted — checkpoint saved to {path}", flush=True)
        return path

    def log_metrics(self, logger, metrics: Dict[str, Any], step: int, prefix: str = "train/"):
        if logger is None:
            return
        for k, v in metrics.items():
            key = k if "/" in k else prefix + k
            logger.record(key, float(v) if hasattr(v, "item") else v)
        logger.dump(step)
