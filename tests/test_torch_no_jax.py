"""The port imports neither JAX nor the JAX package, and ``chip_smoke.py``
refuses to run without a card or outside a checkout.

Each check runs in a fresh interpreter: this test process has JAX imported
already (conftest)."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import visfly_tpu_torch
names = [m.name for m in pkgutil.walk_packages(visfly_tpu_torch.__path__, "visfly_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import visfly_tpu_torch.policies, visfly_tpu_torch.algos
from visfly_tpu_torch.algos import ALGO_ALIASES
assert sorted(ALGO_ALIASES) == ["apg", "bptt", "ppo", "sac", "shac"]
for sub in ("policies.common", "policies.extractors", "policies.networks", "algos.bptt",
            "algos.common", "algos.lr_scheduler", "algos.ppo", "algos.shac", "algos.apg",
            "algos.sac", "algos.returns", "algos.buffers", "envs.multi", "envs.dynamic",
            "envs.racing", "envs.tracking", "envs.catch", "envs.controller", "scene.objects",
            "scene.templates", "render.noise", "run", "render.global_view", "utils.common",
            "utils.checkpoint", "utils.logger", "utils.figfashion", "utils.evaluate",
            "utils.profiling", "utils.debug", "utils.path_finder", "utils.sim2real",
            "utils.dataloader", "scene.decompose", "scene.habitat_dataset", "scene.png",
            "policies.torch_backbones", "policies.compact_backbones", "policies.world_model",
            "policies.autoencoder", "policies.transfer", "parallel", "parallel.mesh",
            "examples", "examples.reproduce", "examples.distill_vision",
            "examples.train_imported_mesh", "examples.mesh_assets", "examples.debug_obs",
            "examples.habitat_dataset_demo", "examples.vision_grad_probe",
            "examples.fps_test", "examples.tri_bench"):
    assert "visfly_tpu_torch." + sub in names, sub
import chip_smoke, chip_profile
banned = ("jax", "jaxlib", "flax", "optax", "visfly_tpu", "examples")
bad = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print(len(names), bad)
assert not bad, bad
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    # policies/, the trainers, the zoo, run.py, utils/, the scene ingest, parallel/,
    # examples/ (with the debugging and demo scripts and the two benchmarks)
    assert n_modules >= 84, proc.stdout


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=_clean_env(),
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py runs for real there")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and proc.stdout.strip() == "", proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and proc.stdout.strip() == "", proc.stdout
