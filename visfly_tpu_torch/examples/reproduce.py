"""Reproduce the cheap rows of the README's validated-training table
(counterpart of ``examples/reproduce.py``).

Each row retrains one experiment of ``visfly_tpu/exps/`` from a pinned seed
with its YAML files' recipe, evaluates the trained policy deterministically
in the eval env, and holds the result to the README's claim: a row passes
when ``|s − claim| ≤ tol`` or ``s ≥ claim``. The claims are the JAX
package's; the rows run here on the CUDA card.

    python -m visfly_tpu_torch.examples.reproduce [--rows navigation2 landing2 ...] [--seed 42]

Exit code 0 iff every requested row reproduces within its tolerance.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..run import resolve
from ..utils.common import set_seed

ROWS = {
    # env, algorithm (variant YAML name), README claim, abs tolerance.
    # metric="success" reads eval/success_rate; metric="gates" replays one
    # 256-step deterministic episode and reads the per-agent gate counter
    # (racing is cyclic — it has no is_success, the README claim is laps).
    "navigation2": dict(algo="BPTT", claim=0.57, tol=0.12,
                        note="README: 57% eval success, 500k steps ~25 s"),
    "landing2": dict(algo="PPO", claim=1.00, tol=0.05,
                     note="README: 100% eval success (96/96), ~27 s"),
    "racing2": dict(algo="PPO", claim=4.0, tol=0.0, metric="gates",
                    note="README: 4/4 gates every agent, ~33 s"),
    "crossing": dict(algo="PPO_tuned", claim=0.875, tol=0.15,
                     note="README: 87.5% scene success, ~33 s updates"),
}


def passes(spec: dict, success: float) -> bool:
    """The row's pass rule: within the tolerance of the claim, or above it."""
    return abs(success - spec["claim"]) <= spec["tol"] or success >= spec["claim"]


@torch.no_grad()
def eval_gates(model, st, eval_env, steps: int = 256, stochastic: bool = False,
               gen: Optional[torch.Generator] = None) -> np.ndarray:
    """One ``steps``-step episode counting the gates each agent passed (the
    running max of ``RacingEnv``'s ``aux.past_targets``). ``stochastic=False``
    (the scored metric) replays the deterministic policy mean; True adds the
    training-time Gaussian, drawn from ``gen`` (default: seeded with 99 on the
    env's device). The reset draws from a generator seeded with 1234."""
    dev = eval_env.device
    env_state, obs = eval_env.reset(torch.Generator(device=dev).manual_seed(1234))
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(99)
    gates = np.zeros(eval_env.num_envs, np.int32)
    for _ in range(steps):
        mean, log_std, _ = model.policy(obs)
        if stochastic:
            mean = mean + torch.exp(log_std) * torch.randn(mean.shape, generator=gen,
                                                           device=mean.device)
        env_state, out = eval_env.step(env_state, torch.clamp(mean, -1.0, 1.0), is_test=True)
        obs = out.obs
        gates = np.maximum(gates, env_state.aux.past_targets.cpu().numpy())
    return gates


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_row(env_name: str, spec: dict, seed: int = 42, device="cuda",
            cut: Optional[Dict[str, int]] = None) -> dict:
    """Train the row's experiment and evaluate it → {"success", "train_s",
    "reward", ... , "n_updates", "model", "state"}. ``cut`` (tests and the
    smoke only) overrides ``total_timesteps`` and the agent counts
    (``num_agent_per_scene``, ``eval_num_agent_per_scene``)."""
    cut = dict(cut or {})
    set_seed(seed)
    # the env file with the algorithm file's env sections merged over it; the
    # trainer by the algorithm's base name (PPO_tuned → PPO)
    env_cls, alg_cls, env_config, alg_config = resolve(env_name, spec["algo"])
    learn_kwargs = dict(alg_config.get("learn", {}))
    if "total_timesteps" in cut:
        learn_kwargs["total_timesteps"] = cut["total_timesteps"]
    if "num_agent_per_scene" in cut:
        env_config["env"]["num_agent_per_scene"] = cut["num_agent_per_scene"]
    if "eval_num_agent_per_scene" in cut:
        env_config["eval_env"]["num_agent_per_scene"] = cut["eval_num_agent_per_scene"]

    env = env_cls(device=device, **env_config["env"])
    model = alg_cls(env=env, seed=seed, **alg_config.get("algorithm", {}))
    st = model.init()
    _sync(device)
    t0 = time.time()
    st = model.learn(state=st, **learn_kwargs)
    _sync(device)
    train_s = time.time() - t0
    per_update = getattr(model, "n_steps", None) or model.H  # PPO's rollout, BPTT's horizon
    n_updates = max(1, int(learn_kwargs["total_timesteps"]) // (per_update * env.num_envs))
    out = dict(train_s=train_s, n_updates=n_updates, model=model, state=st)

    eval_env = env_cls(device=device, **env_config["eval_env"])
    if spec.get("metric") == "gates":
        g_det = eval_gates(model, st, eval_env, stochastic=False)
        g_sto = eval_gates(model, st, eval_env, stochastic=True)
        out.update(success=float(g_det.min()), reward=float(np.mean(g_det)),
                   sto_min=float(g_sto.min()), sto_mean=float(np.mean(g_sto)))
        return out
    stats = model.evaluate(st, eval_env=eval_env)
    out.update(success=stats["eval/success_rate"], reward=stats["eval/ep_rew_mean"])
    return out


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", nargs="+", default=list(ROWS), choices=list(ROWS))
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    failures = []
    for name in args.rows:
        spec = ROWS[name]
        print(f"=== {name} / {spec['algo']} — {spec['note']} (the JAX package's claim)",
              flush=True)
        r = run_row(name, spec, args.seed, device=device)
        ok = passes(spec, r["success"])
        if spec.get("metric") == "gates":
            print(f"    min gates/agent {r['success']:.0f} "
                  f"(claimed {spec['claim']:.0f}, deterministic replay) "
                  f"mean {r['reward']:.2f}; stochastic-action episode "
                  f"min {r['sto_min']:.0f} mean {r['sto_mean']:.2f}; "
                  f"train {r['train_s']:.0f}s ({r['n_updates']} updates) "
                  f"→ {'OK' if ok else 'MISMATCH'}", flush=True)
        else:
            print(f"    eval success {r['success']:.1%} "
                  f"(claimed {spec['claim']:.1%} ± {spec['tol']:.0%}) "
                  f"train {r['train_s']:.0f}s ({r['n_updates']} updates) "
                  f"reward {r['reward']:.2f} "
                  f"→ {'OK' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            failures.append(name)
    if failures:
        print(f"FAILED rows: {failures}")
        return 1
    print("all rows reproduced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
