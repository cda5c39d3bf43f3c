"""End-to-end training in an imported triangle-mesh scene (counterpart of
``examples/train_imported_mesh.py``).

A user's OBJ/GLB imports through the C++ SDF bake (``scene/mesh.py``,
``backend: "grid"``), collision queries run on the baked grid and the exact
triangles, and BPTT trains with analytic gradients through them:
``NavigationEnv2`` at 96 agents, ``BPTT(horizon=32, lr 1e-3, latent (128,
128))`` for 500k steps, the checkpoint saved, then ``TestBase`` evaluates
the policy on 48 agents for 256 steps. The default scene is the generated
24-pillar garage (``mesh_assets.make_garage_obj``).

    python -m visfly_tpu_torch.examples.train_imported_mesh [--obj path/to/scene.obj]
                                                            [--timesteps 500000]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

from ..algos import BPTT
from ..envs import NavigationEnv2
from ..utils.evaluate import TestBase
from .mesh_assets import make_garage_obj


def train(obj: Optional[str] = None, timesteps: int = 500_000, device="cuda",
          save_dir: Optional[str] = None, eval_steps: int = 256) -> dict:
    """Train, save and evaluate → {"train_s", "checkpoint", "stats",
    "trainer", "state", "tester"}. Files go under ``save_dir`` (default
    ``./saved/navigation2``): the generated OBJ when ``obj`` is None, the
    checkpoint and the evaluation's figure under ``test/``. ``eval_steps``
    cuts the evaluation (tests and the smoke only)."""
    save_dir = save_dir or os.path.join(os.getcwd(), "saved", "navigation2")
    obj = obj or make_garage_obj(os.path.join(save_dir, "train_imported_garage.obj"),
                                 n_pillars=24)
    kw = dict(
        num_agent_per_scene=96, visual=True, requires_grad=True,
        scene_kwargs={"path": obj, "backend": "grid", "sdf_spacing": 0.1, "margin": 0.5},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate",
                         "ctrl_delay": True},
        max_episode_steps=256, target=[14.0, 0.0, 1.0])
    env = NavigationEnv2(device=device, **kw)
    tr = BPTT(env, horizon=32, learning_rate=1e-3, policy_kwargs={"latent_dim": (128, 128)})
    st = tr.init(torch.Generator(device=env.device).manual_seed(0))
    t0 = time.time()
    st = tr.learn(timesteps, state=st, log_interval=100)
    if env.device.type == "cuda":
        torch.cuda.synchronize(env.device)
    train_s = time.time() - t0
    print(f"train wall {train_s:.0f}s", flush=True)
    path = tr.save(st, os.path.join(save_dir, "BPTT_imported_mesh_1"))

    ev = NavigationEnv2(device=device, **{**kw, "requires_grad": False,
                                          "num_agent_per_scene": 48})
    tester = TestBase(tr, ev, save_path=os.path.join(save_dir, "test"), name="imported_mesh")
    stats = tester.test(state=st, max_steps=eval_steps)
    return dict(train_s=train_s, checkpoint=path, stats=stats, trainer=tr, state=st,
                tester=tester)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--obj", default=None, help="mesh file (default: the "
                   "generated 24-pillar garage OBJ)")
    p.add_argument("--timesteps", type=int, default=500_000)
    args = p.parse_args(argv)
    return train(args.obj, args.timesteps, device)


if __name__ == "__main__":
    main()
