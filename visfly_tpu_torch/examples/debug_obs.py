"""Observation visual check: render and save the depth, colour and semantic
frames of a few agents and the global debug view (counterpart of
``examples/debug_obs.py``).

A 4-agent ``NavigationEnv`` in a preset scene with three 64×64 cameras
(depth, colour, semantic) steps 40 times at a constant action; then each of
the first two agents' frames is printed as statistics and written as a PNG
(depth as a heat image, semantic ids spread over the grey levels), and the
top view of the scene with the agents' trajectories is rendered at 480×640.
The PNGs are encoded by the package itself (``scene/png.py``).

    python -m visfly_tpu_torch.examples.debug_obs [--scene garage_simple_l_medium]
                                                  [--out ./saved/debug_obs]
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..envs import NavigationEnv
from ..scene.png import encode_png
from ..utils.common import depth2rgb

SENSORS = ("depth", "color", "semantic")


def make_env(scene: str = "garage_simple_l_medium", n: int = 4, resolution=(64, 64),
             device="cuda") -> NavigationEnv:
    """The script's env: ``n`` agents, a depth, a colour and a semantic camera
    at ``resolution``."""
    return NavigationEnv(
        num_agent_per_scene=n, visual=True, device=device,
        scene_kwargs={"path": scene},
        sensor_kwargs=[{"sensor_type": s, "uuid": s, "resolution": list(resolution)}
                       for s in SENSORS],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03},
    )


def frames(env, state, agents: int = 2) -> Dict[str, np.ndarray]:
    """The raw sensor suite of the first ``agents`` agents at ``state`` (the
    env's task observation may expose a subset): depth (A, H, W) metres,
    colour (A, H, W, 3) uint8, semantic (A, H, W) ids."""
    with torch.no_grad():
        obs = env.sensor_observations(state)
    return {"depth": obs["depth"][:agents, 0].cpu().numpy(),
            "color": obs["color"][:agents].permute(0, 2, 3, 1).cpu().numpy(),
            "semantic": obs["semantic"][:agents, 0].cpu().numpy()}


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Run the check → {"frames", "view" (the global view, (480, 640, 3)),
    "files"}."""
    p = argparse.ArgumentParser()
    p.add_argument("--scene", default="garage_simple_l_medium")
    p.add_argument("--out", default=os.path.join("saved", "debug_obs"))
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    env = make_env(args.scene, device=device)
    state, _ = env.reset(torch.Generator(device=env.device).manual_seed(0))
    hist = [state.dyn.pos.cpu().numpy()]
    action = torch.full((env.num_agent, 4), 0.1, device=env.device)
    with torch.no_grad():
        for _ in range(40):
            state, _ = env.step(state, action)
            hist.append(state.dyn.pos.cpu().numpy())
    got = frames(env, state)

    files = []
    for agent in range(2):
        depth, color, sem = (got[k][agent] for k in SENSORS)
        print(f"agent {agent}: depth [{depth.min():.2f}, {depth.max():.2f}] m, "
              f"color mean {color.mean():.0f}, semantic ids {np.unique(sem)}", flush=True)
        for name, img in (("depth", depth2rgb(depth)), ("color", color),
                          ("semantic", (sem.astype(np.int64) * 23 % 255).astype(np.uint8))):
            files.append(os.path.join(args.out, f"a{agent}_{name}.png"))
            write_png(files[-1], img)

    view = env.render(state, traj_history=np.stack(hist), view="top", resolution=[480, 640],
                      trajectory=True, line_width=3.0)
    if view is not None:
        files.append(os.path.join(args.out, "global_top.png"))
        write_png(files[-1], view)
    print(f"frames written to {args.out}", flush=True)
    return {"frames": got, "view": view, "files": files, "env": env, "state": state}


if __name__ == "__main__":
    main()
