"""Throughput of env rollouts in the reference's configurations (counterpart
of ``examples/fps_test.py``):

1. physics-only (``HoverEnv``, dt 0.0025, ctrl_dt 0.02: 8 substeps);
2. physics + 64×64 depth (``NavigationEnv2`` in ``garage_simple_l_medium``);
3. (``--scenes S > 1``) the same over S scenes, ``agents // S`` a scene;
4. physics + depth + dynamic objects (``DynEnv`` with two moving spheres,
   which reach the analytic kernel as dynamic capsules);
5. (``--mesh``) physics + depth in an imported triangle-mesh scene: the
   garage OBJ decomposed into boxes through its SDF (spacing 0.1 m, margin
   0.5 m, at most 48 primitives).

Each env resets, runs one warm-up chunk of 50 steps and then chunks of 50
until ``--steps`` are done, with actions uniform in [-0.3, 0.3] from a
generator on the env's device seeded 1 and every observation summed into a
probe on the device, read once at the end. Agent steps a second are the
timed steps times the agents over the host clock around
``torch.cuda.synchronize()``.

    python -m visfly_tpu_torch.examples.fps_test [--agents 200] [--steps 500] [--scenes 1]
                                                 [--mesh]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List, Optional, Sequence, Tuple

import torch

from ..envs import DynEnv, HoverEnv, NavigationEnv2
from .mesh_assets import make_garage_obj

CHUNK = 50
DEPTH = [{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}]
DT = {"dt": 0.03, "ctrl_dt": 0.03}
OBJECTS = [
    {"name": "mover", "velocity": 1.5, "radius": 0.4,
     "path": {"class": "circle", "kwargs": {"radius": 2.0, "center": [1, 0, 1.5]}}},
    {"name": "patrol", "velocity": 2.0, "radius": 0.3,
     "path": {"class": "polygon", "kwargs": {"points": [[0, 0, 1], [4, 0, 1], [4, 4, 1]]}}},
]


def envs(args, device="cuda") -> List[Tuple[str, object]]:
    """The benchmark's envs as ``[(label, env)]``, in the order they run."""
    out = [("physics-only",
            HoverEnv(num_agent_per_scene=args.agents, visual=False, device=device,
                     dynamics_kwargs={"dt": 0.0025, "ctrl_dt": 0.02})),
           ("physics + 64×64 depth",
            NavigationEnv2(num_agent_per_scene=args.agents, visual=True, device=device,
                           scene_kwargs={"path": "garage_simple_l_medium"},
                           sensor_kwargs=DEPTH, dynamics_kwargs=DT))]
    if args.scenes > 1:
        out.append((f"physics + 64×64 depth, {args.scenes} batched scenes",
                    NavigationEnv2(num_agent_per_scene=max(1, args.agents // args.scenes),
                                   num_scene=args.scenes, visual=True, device=device,
                                   scene_kwargs={"path": "garage_simple_l_medium"},
                                   sensor_kwargs=DEPTH, dynamics_kwargs=DT)))
    # the depth benchmark's scene, so that the objects' cost is measured
    # against the same static geometry
    out.append(("physics + depth + dynamic objects",
                DynEnv(num_agent_per_scene=args.agents, visual=True, device=device,
                       scene_kwargs={"path": "garage_simple_l_medium", "obj_settings": OBJECTS},
                       sensor_kwargs=DEPTH,
                       random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                           {"position": {"mean": [1.0, 0.0, 1.5],
                                         "half": [0.5, 0.5, 0.3]}}]}},
                       dynamics_kwargs=DT)))
    if args.mesh:
        with tempfile.TemporaryDirectory(prefix="visfly_fps_") as tmp:
            obj = make_garage_obj(os.path.join(tmp, "visfly_garage_bench.obj"))
            out.append(("physics + 64×64 depth, imported OBJ scene",
                        NavigationEnv2(
                            num_agent_per_scene=args.agents, visual=True, device=device,
                            scene_kwargs={"path": obj, "sdf_spacing": 0.1, "margin": 0.5,
                                          "max_prims": 48},
                            sensor_kwargs=DEPTH,
                            random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                                {"position": {"mean": [8.0, 0.0, 1.5],
                                              "half": [4.0, 2.0, 1.0]}}]}},
                            dynamics_kwargs=DT)))
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(env, steps: int, label: str) -> float:
    """Agent steps a second of ``env`` over ``steps`` steps (whole chunks of
    50) after one warm-up chunk; prints them as the JAX script does."""
    device = torch.device(env.device)
    n = env.num_envs
    state, _ = env.reset(torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    probe = torch.zeros((), device=device)

    def chunk(state, probe):
        for _ in range(CHUNK):
            a = torch.rand((n, 4), generator=gen, device=device) * 0.6 - 0.3
            state, out = env.step(state, a)
            probe = probe + sum(v.float().sum() for v in out.obs.values())
        return state, probe

    with torch.no_grad():
        state, probe = chunk(state, probe)
        _sync(device)
        t0 = time.perf_counter()
        done = 0
        while done < steps:
            state, probe = chunk(state, probe)
            done += CHUNK
        _sync(device)
        fps = n * done / (time.perf_counter() - t0)
    if not torch.isfinite(probe):
        raise RuntimeError(f"{label}: the observations summed to {float(probe)}")
    print(f"{label}: {fps:,.0f} agent-steps/s ({n} agents)", flush=True)
    return fps


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Run the benchmark → {label: agent steps a second}."""
    p = argparse.ArgumentParser()
    p.add_argument("--agents", type=int, default=200)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--mesh", action="store_true",
                   help="also bench an imported triangle-mesh (OBJ) scene")
    p.add_argument("--scenes", type=int, default=1,
                   help="batch the depth benchmark over S differently-seeded scenes (agents "
                        "split across them): the reference's multi-scene SceneManager case")
    args = p.parse_args(argv)
    return {label: measure(env, args.steps, label) for label, env in envs(args, device)}


if __name__ == "__main__":
    main()
