"""Shared trainer plumbing (counterpart of ``visfly_tpu/algos/common.py``):
the differentiable-env requirement, deterministic evaluation rollouts and the
hooks a stateful policy overrides. Checkpoints and metric logs are not ported
yet (ROADMAP Queue A item 21, ``utils/checkpoint.py`` and
``utils/logger.py``) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: Queue A item 21, "
                               "utils/checkpoint.py and utils/logger.py)")


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
        if log_dir:
            raise _unported("metric logging to a directory")
        return None

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

    def save(self, st, path: str):
        raise _unported("saving a training state")

    def load(self, st, path: str):
        raise _unported("loading a training state")

    def save_interrupt_cache(self, st, log_dir: Optional[str] = None) -> str:
        raise _unported("the checkpoint on an interrupt")

    def log_metrics(self, logger, metrics: Dict[str, Any], step: int, prefix: str = "train/"):
        if logger is None:
            return
        for k, v in metrics.items():
            key = k if "/" in k else prefix + k
            logger.record(key, float(v) if hasattr(v, "item") else v)
        logger.dump(step)
