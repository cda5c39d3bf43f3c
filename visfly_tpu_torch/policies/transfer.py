"""Cross-algorithm policy warm-starting (counterpart of
``visfly_tpu/policies/transfer.py``).

The analytic-gradient trainers (BPTT, SHAC, APG, SAC) and PPO share the
multi-input extractor; their actors differ only in the heads (``Actor``:
extractor → ``latent`` MLP → ``head.mu`` / ``head.log_std``, tanh-squashed;
``ActorCriticPolicy``: extractor → ``heads.mlp_pi`` → ``heads.mu`` with a
state-independent ``heads.log_std``). So a policy pretrained with analytic
gradients can be fine-tuned with PPO where the reward is not differentiable.

The transplanted PPO policy emits ``clip(mean)`` where the Actor emitted
``tanh(mean)``; the mean itself is the Actor's. ``heads.mlp_vf`` and
``heads.value`` keep the policy's own initialisation.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import Tensor, nn

# (actor prefix, policy prefix) of the transplanted modules
_MAP = (("extractor", "extractor"), ("latent", "heads.mlp_pi"), ("head.mu", "heads.mu"))


def _state(x) -> Dict[str, Tensor]:
    return x.state_dict() if isinstance(x, nn.Module) else dict(x)


def _sub(sd: Dict[str, Tensor], prefix: str) -> Dict[str, Tensor]:
    return {k[len(prefix) + 1:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _tree_shapes_match(a: Dict[str, Tensor], b: Dict[str, Tensor], path: str) -> None:
    ka, kb = set(a), set(b)
    if ka != kb:
        raise ValueError(
            f"{path}: structure mismatch — actor has {sorted(ka - kb)} "
            f"extra, policy has {sorted(kb - ka)} extra. Build both with "
            "the same net_arch, and Actor latent_dim == PPO pi_layers.")
    for k in sorted(ka):
        if a[k].shape != b[k].shape:
            raise ValueError(
                f"{path}/{k}: shape {tuple(a[k].shape)} vs {tuple(b[k].shape)} — Actor "
                "latent_dim must equal PPO pi_layers (and net_arch must match).")


def actor_to_policy_params(actor_params, policy_params, log_std: Optional[float] = -0.7
                           ) -> Dict[str, Tensor]:
    """Transplant a trained ``Actor`` (BPTT/SHAC/APG/SAC) into an
    ``ActorCriticPolicy`` (PPO) state dict.

    Maps ``extractor`` → ``extractor``, ``latent`` → ``heads.mlp_pi`` and
    ``head.mu`` → ``heads.mu``; the value branch keeps the policy's values.
    ``log_std`` fills ``heads.log_std``, the PPO exploration std around the
    transplanted mean (default σ ≈ 0.5); ``None`` keeps the policy's own.

    Both arguments are modules or their state dicts (``trainer.actor``,
    ``trainer.policy``). Returns a new state dict of copies for
    ``policy.load_state_dict``; the inputs are not changed."""
    ap, pp = _state(actor_params), _state(policy_params)
    out = {k: v.detach().clone() for k, v in pp.items()}
    for src, dst in _MAP:
        a, p = _sub(ap, src), _sub(pp, dst)
        if not a:
            raise ValueError(f"actor params have no {src!r} module")
        if not p:
            raise ValueError(f"policy params have no {dst!r} module")
        _tree_shapes_match(a, p, dst)
        for k, v in a.items():
            out[f"{dst}.{k}"] = v.detach().clone().to(p[k].device)
    if log_std is not None:
        out["heads.log_std"] = torch.full_like(out["heads.log_std"], float(log_std))
    return out
