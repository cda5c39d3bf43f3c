"""Experiment CLI: train or evaluate from the repo's YAML configs
(counterpart of ``visfly_tpu/run.py``, with the same flags):

    python -m visfly_tpu_torch.run -t 1 -e cluttered_flight -a PPO_tuned [-c comment]
    python -m visfly_tpu_torch.run -t 0 -e cluttered_flight -a PPO_tuned -w PPO_1.pt

The configs are read in place from ``visfly_tpu/exps/env_cfgs/<env>.yaml``
and ``visfly_tpu/exps/alg_cfgs/<env>/<ALG>.yaml`` (``eval_env`` inherits
``env``; an algorithm file's ``env`` and ``eval_env`` sections override the
env file's). A variant name resolves to its base algorithm (``PPO_tuned`` →
``PPO``). Training saves the full training state under
``./saved/<env>/<ALG>[_<comment>]_<i>.pt``; ``-w`` (a path under
``./saved/<env>/``, or absolute) resumes from a checkpoint when training, and
is the checkpoint to evaluate with ``-t 0``, whose figures, videos and
frames go to ``./saved/<env>/test/``. Everything runs on the CUDA card;
``main(argv, device="cpu")`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional, Sequence

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from visfly_tpu_torch.algos import ALGO_ALIASES  # noqa: E402
from visfly_tpu_torch.envs import (ENV_ALIASES, LandingEnv, MultiNavigationEnv,  # noqa: E402
                                   NavigationEnv)
from visfly_tpu_torch.utils.common import deep_merge, load_yaml_config, set_seed  # noqa: E402

EXPS_DIR = os.path.join(REPO_ROOT, "visfly_tpu", "exps")

# experiment name → env class
EXPERIMENT_ENVS = {
    "cluttered_flight": NavigationEnv,
    "crossing": MultiNavigationEnv,
    "landing": LandingEnv,
    **ENV_ALIASES,
}


def parse_args(default_env: str = "cluttered_flight"):
    parser = argparse.ArgumentParser(description="Run visfly_tpu_torch experiments")
    parser.add_argument("--comment", "-c", type=str, default=None)
    parser.add_argument("--train", "-t", type=int, default=1)
    parser.add_argument("--algorithm", "-a", type=str, default="PPO")
    parser.add_argument("--env", "-e", type=str, default=default_env)
    parser.add_argument("--seed", "-s", type=int, default=42)
    parser.add_argument("--weight", "-w", type=str, default=None)
    parser.add_argument("--timesteps", "-n", type=int, default=None,
                        help="override learn.total_timesteps from the YAML")
    return parser


def resolve(env_name: str, algorithm: str):
    """(env class, trainer class, env config, algorithm config) of an
    experiment: the env file's ``env`` and ``eval_env`` with the algorithm
    file's sections of those names merged over them."""
    env_config = load_yaml_config(os.path.join(EXPS_DIR, "env_cfgs", f"{env_name}.yaml"))
    alg_config = load_yaml_config(os.path.join(EXPS_DIR, "alg_cfgs", env_name,
                                               f"{algorithm}.yaml"))
    for section in ("env", "eval_env"):
        if section in alg_config:
            env_config[section] = deep_merge(origin=env_config.get(section, {}),
                                             target=alg_config[section])
    alg_name = algorithm.lower()
    alg_cls = ALGO_ALIASES[alg_name if alg_name in ALGO_ALIASES else alg_name.split("_")[0]]
    return EXPERIMENT_ENVS[env_name], alg_cls, env_config, alg_config


def optimizer_steps(model, total_timesteps: int) -> Optional[int]:
    """The optimiser steps the learning-rate schedule sees in a run of
    ``total_timesteps`` (PPO: updates × epochs × minibatches, at most, since
    ``target_kl`` can stop an epoch early; BPTT, APG and SHAC's actor: one
    an update; SAC: gradient steps of the training env steps)."""
    n = model.env.num_envs
    name = type(model).__name__
    if name == "PPO":
        return max(1, total_timesteps // (model.n_steps * n)) * model.n_epochs * \
            model.n_minibatches
    if name in ("BPTT", "APG", "SHAC"):
        return max(1, total_timesteps // (model.H * n))
    if name == "SAC":
        n_steps = max(1, total_timesteps // n)
        trained = sum(1 for i in range(n_steps)
                      if i * n >= model.learning_starts and i % model.train_freq == 0)
        return trained * model.gradient_steps
    return None


def _schedule_note(model, alg_config: Dict, total_timesteps: int) -> Optional[str]:
    """One line where the file's schedule length differs from the run."""
    lr = alg_config.get("algorithm", {}).get("learning_rate")
    if not isinstance(lr, dict):
        return None
    total = (lr.get("kwargs") or {}).get("total_steps")
    steps = optimizer_steps(model, total_timesteps)
    if total is None or steps is None or int(total) == steps:
        return None
    return (f"[run] learning_rate schedule: total_steps {total} in the algorithm file, "
            f"but this run takes {steps} optimiser steps; the file's schedule is used as "
            "written")


def main(argv: Optional[Sequence[str]] = None, device="cuda",
         default_env: str = "cluttered_flight") -> Dict[str, Any]:
    """Train (``-t 1``) → {"checkpoint", "trainer", "state"}; evaluate
    (``-t 0``) → {"stats", "tester", "trainer", "state"}."""
    args = parse_args(default_env).parse_args(argv)
    set_seed(args.seed)
    save_folder = os.path.join(os.getcwd(), "saved", args.env)
    os.makedirs(save_folder, exist_ok=True)
    env_cls, alg_cls, env_config, alg_config = resolve(args.env, args.algorithm)

    if args.train:
        env = env_cls(device=device, **env_config["env"])
        model = alg_cls(env=env, seed=args.seed, comment=args.comment, save_path=save_folder,
                        **alg_config.get("algorithm", {}))
        state = model.init()
        if args.weight is not None:
            state = model.load(state, os.path.join(save_folder, args.weight))
        learn_kwargs = dict(alg_config.get("learn", {}))
        if args.timesteps is not None:
            learn_kwargs["total_timesteps"] = args.timesteps
        note = _schedule_note(model, alg_config, int(learn_kwargs.get("total_timesteps", 0)))
        if note:
            print(note, flush=True)
        state = model.learn(state=state, **learn_kwargs)
        from visfly_tpu_torch.utils.checkpoint import unique_path

        path = model.save(state, unique_path(save_folder, args.comment, type(model).__name__))
        print(f"model saved at {path}", flush=True)
        return {"checkpoint": path, "trainer": model, "state": state}

    if args.weight is None:
        raise ValueError("Testing requires --weight/-w.")
    eval_env = env_cls(device=device, **env_config["eval_env"])
    # train=False: the eval env stays as configured (no requires_grad flip by
    # the analytic-gradient trainers)
    model = alg_cls(env=eval_env, seed=args.seed, train=False, **alg_config.get("algorithm", {}))
    state = model.load(model.init(), os.path.join(save_folder, args.weight))

    from visfly_tpu_torch.utils.evaluate import TestBase

    name = os.path.basename(args.weight)
    tester = TestBase(model, eval_env, save_path=os.path.join(save_folder, "test"),
                      name=name[:-3] if name.endswith(".pt") else name)
    stats = tester.test(state=state, **alg_config.get("test", {}))
    return {"stats": stats, "tester": tester, "trainer": model, "state": state}


if __name__ == "__main__":
    main()
