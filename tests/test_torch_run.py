"""The port's runner (``visfly_tpu_torch/run.py``) against
``visfly_tpu/run.py``: the flags, the config every experiment under
``visfly_tpu/exps/`` resolves to (env, eval env and algorithm sections after
the algorithm file's env overrides; the env and trainer classes by name),
and one train → checkpoint → resume → evaluate round on the CPU.
"""
import glob
import os

import pytest
import torch

import visfly_tpu.run as jrun
from visfly_tpu.utils.common import deep_merge as jdeep_merge
from visfly_tpu.utils.common import load_yaml_config as jload
from visfly_tpu_torch import run

torch.set_num_threads(1)

PAIRS = sorted((os.path.basename(os.path.dirname(p)), os.path.splitext(os.path.basename(p))[0])
               for p in glob.glob(os.path.join(run.EXPS_DIR, "alg_cfgs", "*", "*.yaml")))


def jax_resolve(env_name, algorithm):
    """``visfly_tpu/run.py:63-85``, the part of ``main`` that builds the
    configs and picks the classes."""
    base_dir = os.path.join(os.path.dirname(os.path.abspath(jrun.__file__)), "exps")
    env_config = jload(os.path.join(base_dir, "env_cfgs", f"{env_name}.yaml"))
    alg_config = jload(os.path.join(base_dir, "alg_cfgs", env_name, f"{algorithm}.yaml"))
    for section in ("env", "eval_env"):
        if section in alg_config:
            env_config[section] = jdeep_merge(origin=env_config.get(section, {}),
                                              target=alg_config[section])
    alg_name = algorithm.lower()
    alg_cls = jrun.ALGO_ALIASES[alg_name if alg_name in jrun.ALGO_ALIASES
                                else alg_name.split("_")[0]]
    return jrun.EXPERIMENT_ENVS[env_name], alg_cls, env_config, alg_config


def test_every_pair_is_listed():
    assert len(PAIRS) >= 18 and ("cluttered_flight", "PPO_tuned") in PAIRS


@pytest.mark.parametrize("env_name,algorithm", PAIRS, ids=lambda x: x)
def test_experiment_resolves_as_in_jax(env_name, algorithm):
    env_cls, alg_cls, env_config, alg_config = run.resolve(env_name, algorithm)
    j_env, j_alg, j_env_config, j_alg_config = jax_resolve(env_name, algorithm)
    assert env_cls.__name__ == j_env.__name__ and alg_cls.__name__ == j_alg.__name__
    assert env_config == j_env_config and alg_config == j_alg_config
    assert set(run.EXPERIMENT_ENVS) == set(jrun.EXPERIMENT_ENVS)


def test_flags_match_jax():
    ours, theirs = run.parse_args(), jrun.parse_args()
    flags = lambda p: sorted((tuple(a.option_strings), a.dest, a.default, a.type)  # noqa: E731
                             for a in p._actions if a.dest != "help")
    assert flags(ours) == flags(theirs)


def test_train_resume_and_evaluate_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``-t 1`` trains one update and saves under ./saved/<env>/, ``-w``
    resumes it, ``-t 0 -w`` evaluates it in the eval env (16 agents, the
    env fields kept from the fresh init) and writes the figure."""
    monkeypatch.chdir(tmp_path)
    n = 64 * 48  # tracking's BPTT: 64 agents, H = 48, one update
    first = run.main(["-t", "1", "-e", "tracking", "-a", "BPTT", "-n", str(n), "-c", "cpu"],
                     device="cpu")
    path = first["checkpoint"]
    assert path == str(tmp_path / "saved" / "tracking" / "BPTT_cpu_1.pt") and os.path.isfile(path)
    assert first["state"].global_step == n and first["trainer"].optimizer.count == 1
    again = run.main(["-t", "1", "-e", "tracking", "-a", "BPTT", "-n", str(n), "-c", "cpu",
                      "-w", "BPTT_cpu_1.pt"], device="cpu")
    assert again["checkpoint"].endswith("BPTT_cpu_2.pt")
    assert again["state"].global_step == 2 * n and again["trainer"].optimizer.count == 2
    capsys.readouterr()
    out = run.main(["-t", "0", "-e", "tracking", "-a", "BPTT", "-w", "BPTT_cpu_1.pt"],
                   device="cpu")
    printed = capsys.readouterr().out
    assert "kept from the fresh init" in printed and "'env_state'" in printed
    tester = out["tester"]
    # the eval env as configured: the algorithm file's env override reaches it
    assert tester.env.num_envs == 16 and tester.env.requires_grad
    for (name, p), q in zip(out["trainer"].actor.named_parameters(),
                            first["trainer"].actor.parameters()):
        assert torch.equal(p, q), name
    assert 0 <= out["stats"]["success_rate"] <= 1
    assert os.path.isfile(tmp_path / "saved" / "tracking" / "test" / "BPTT_cpu_1_trajectories.png")
    with pytest.raises(ValueError, match="--weight"):
        run.main(["-t", "0", "-e", "tracking", "-a", "BPTT"], device="cpu")


def test_schedule_note(capsys):
    """racing2's PPO file writes its schedule for 732 updates × 10 epochs:
    the default run takes exactly that, a shorter one is told."""
    env_cls, alg_cls, env_config, alg_config = run.resolve("racing2", "PPO")
    model = alg_cls(env=env_cls(device="cpu", **env_config["env"]),
                    **alg_config["algorithm"])
    total = alg_config["learn"]["total_timesteps"]
    assert run.optimizer_steps(model, total) == 7320
    assert run._schedule_note(model, alg_config, total) is None
    note = run._schedule_note(model, alg_config, 256 * 64 * 3)
    assert "total_steps 7320" in note and "30 optimiser steps" in note
    env_cls, alg_cls, env_config, alg_config = run.resolve("hover", "SAC")
    env_config["env"]["num_agent_per_scene"] = 4
    sac = alg_cls(env=env_cls(device="cpu", **env_config["env"]), **alg_config["algorithm"])
    assert run.optimizer_steps(sac, 4 * 1252) == 2 * 32  # steps 1250 and 1251 train
    assert run._schedule_note(sac, alg_config, 4 * 1252) is None  # a constant rate
