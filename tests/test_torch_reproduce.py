"""The port's reproduction scripts (``visfly_tpu_torch/examples/reproduce.py``,
``train_imported_mesh.py``, ``mesh_assets.py``) against the JAX package's
(``examples/reproduce.py``, ``examples/mesh_assets.py``).

``examples/reproduce.py`` and ``examples/mesh_assets.py`` import no JAX at
module level, so they are loaded by path. ``run_row``'s config merge is
inline in the JAX script (``examples/reproduce.py:75-90``): it is rebuilt
here from ``visfly_tpu.utils.common``'s ``load_yaml_config`` and
``deep_merge``, and ``train_imported_mesh.py`` is not imported at all (it
points JAX's compilation cache into the repo at import).

Tolerances: the rows, the merged configs, the gates and the OBJ text equal;
the one-update runs finite, with a success rate in [0, 1] and gates a whole
number in [0, 4].
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

import jax

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
import visfly_tpu.run as jrun
from visfly_tpu.utils.common import deep_merge as jdeep_merge
from visfly_tpu.utils.common import load_yaml_config as jload
from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch import run
from visfly_tpu_torch.algos import PPO
from visfly_tpu_torch.examples import mesh_assets, reproduce, train_imported_mesh
from visfly_tpu_torch.interop import env_state_from_numpy, ppo_state_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JREPRO = _load_example("reproduce")
JMESH = _load_example("mesh_assets")


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_row_configs(env_name, spec):
    """``examples/reproduce.py:75-90``: the env file with the algorithm
    file's env sections merged over it, and the classes by name."""
    base = os.path.join(REPO, "visfly_tpu", "exps")
    env_config = jload(os.path.join(base, "env_cfgs", f"{env_name}.yaml"))
    alg_config = jload(os.path.join(base, "alg_cfgs", env_name, f"{spec['algo']}.yaml"))
    for section in ("env", "eval_env"):
        if section in alg_config:
            env_config[section] = jdeep_merge(origin=env_config.get(section, {}),
                                              target=alg_config[section])
    alg_cls = jrun.ALGO_ALIASES[spec["algo"].lower().split("_")[0]]
    return jrun.EXPERIMENT_ENVS[env_name], alg_cls, env_config, alg_config


def test_rows_equal_the_jax_scripts():
    assert reproduce.ROWS == JREPRO.ROWS
    assert list(reproduce.ROWS) == ["navigation2", "landing2", "racing2", "crossing"]


@pytest.mark.parametrize("name", list(JREPRO.ROWS))
def test_row_configs_merge_as_in_jax(name):
    spec = JREPRO.ROWS[name]
    env_cls, alg_cls, env_config, alg_config = run.resolve(name, spec["algo"])
    j_env, j_alg, j_env_config, j_alg_config = jax_row_configs(name, spec)
    assert env_cls.__name__ == j_env.__name__ and alg_cls.__name__ == j_alg.__name__
    assert env_config == j_env_config and alg_config == j_alg_config


@pytest.mark.parametrize("success,ok", [(0.45, True), (0.449, False), (0.9, True)])
def test_pass_rule(success, ok):
    """``|s − claim| ≤ tol or s ≥ claim``, as ``examples/reproduce.py:125``."""
    spec = reproduce.ROWS["navigation2"]
    assert reproduce.passes(spec, success) == ok
    assert reproduce.passes(reproduce.ROWS["racing2"], 4.0)
    assert not reproduce.passes(reproduce.ROWS["racing2"], 3.0)


@pytest.mark.parametrize("name,n_steps", [("navigation2", 32), ("racing2", 256)])
def test_run_row_one_update_on_the_cpu(name, n_steps):
    """One update at 8 agents, then the row's evaluation in a 4-agent eval env."""
    r = reproduce.run_row(name, reproduce.ROWS[name], seed=42, device="cpu",
                          cut=dict(total_timesteps=8 * n_steps, num_agent_per_scene=8,
                                   eval_num_agent_per_scene=4))
    assert r["n_updates"] == 1 and r["state"].global_step == 8 * n_steps
    assert r["model"].env.num_envs == 8
    assert math.isfinite(r["train_s"]) and math.isfinite(r["reward"])
    if name == "racing2":
        assert r["success"] == int(r["success"]) and 0 <= r["success"] <= 4
        assert 0 <= r["sto_min"] <= r["sto_mean"] <= 4
    else:
        assert 0.0 <= r["success"] <= 1.0


def test_eval_gates_match_jax():
    """The deterministic replay from the same reset state and parameters, 16
    steps at 4 agents: agents 0 and 2 start inside their first gate's radius
    (the first observation is the reset's in both), so some gates are passed."""
    spec = JREPRO.ROWS["racing2"]
    _, _, env_config, alg_config = jax_row_configs("racing2", spec)
    ev = dict(env_config["eval_env"], num_agent_per_scene=4)
    jenv = jrun.EXPERIMENT_ENVS["racing2"](**ev)
    jtr = jrun.ALGO_ALIASES["ppo"](env=jenv, seed=42, **alg_config["algorithm"])
    jst = jtr.init(jax.random.PRNGKey(0))
    tenv = tenvs.RacingEnv2(device="cpu", **ev)
    ttr = PPO(tenv, seed=42, **alg_config["algorithm"])
    tst = ppo_state_from_jax(to_numpy(jst), ttr)

    j0, jobs0 = jenv.reset(jax.random.PRNGKey(3))
    gate = np.asarray(jenv.targets)[np.asarray(j0.aux.next_target_i)]
    pos = np.asarray(j0.dyn.pos).copy()
    pos[[0, 2]] = gate[[0, 2]] + np.float32(0.05)
    j0 = j0._replace(dyn=j0.dyn._replace(pos=jax.numpy.asarray(pos)))
    t0 = env_state_from_numpy(to_numpy(j0))
    tobs0 = {k: torch.from_numpy(np.array(v)) for k, v in to_numpy(jobs0).items()}
    jenv.reset = lambda key=None, state=None: (j0, jobs0)
    tenv.reset = lambda gen=None: (t0, tobs0)

    g_jax = JREPRO.eval_gates(jtr, jst, jenv, steps=16)
    g_port = reproduce.eval_gates(ttr, tst, tenv, steps=16)
    np.testing.assert_array_equal(g_port, g_jax)
    assert g_port[0] >= 1 and g_port[2] >= 1


@pytest.mark.parametrize("n_pillars,seed", [(8, 0), (24, 0), (5, 3)])
def test_garage_obj_is_byte_equal(tmp_path, n_pillars, seed):
    ours = mesh_assets.make_garage_obj(str(tmp_path / "port" / "g.obj"), n_pillars, seed)
    theirs = JMESH.make_garage_obj(str(tmp_path / "jax" / "g.obj"), n_pillars, seed)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        text = a.read()
        assert text == b.read()
    assert text.count(b"\nf ") + text.startswith(b"f ") == 12 * (6 + n_pillars)


def test_train_imported_mesh_one_update_on_the_cpu(tmp_path):
    """The 24-pillar garage baked to a grid, one BPTT update at 96 agents,
    the checkpoint saved, ``TestBase`` on the 48-agent eval env cut to 4 steps."""
    out = train_imported_mesh.train(timesteps=96 * 32, device="cpu", save_dir=str(tmp_path),
                                    eval_steps=4)
    assert out["checkpoint"] == str(tmp_path / "BPTT_imported_mesh_1.pt")
    assert os.path.isfile(out["checkpoint"])
    assert os.path.isfile(tmp_path / "train_imported_garage.obj")
    tr, st = out["trainer"], out["state"]
    assert tr.optimizer.count == 1 and st.global_step == 96 * 32
    assert tr.env.scene.triangles.shape[1] == 12 * 30  # floor, ceiling, 4 walls, 24 pillars
    assert tr.env.scene_kwargs["backend"] == "grid"
    assert out["tester"].env.num_envs == 48
    stats = out["stats"]
    assert 0.0 <= stats["success_rate"] <= 1.0 and math.isfinite(stats["mean_return"])
    assert all(torch.isfinite(p).all() for p in tr.actor.parameters())
