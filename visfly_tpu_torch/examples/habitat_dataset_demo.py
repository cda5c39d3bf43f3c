"""Habitat-format dataset workflow demo, without external assets
(counterpart of ``examples/habitat_dataset_demo.py``).

Writes a tiny dataset in the habitat schema (stage and object configs, four
scene instances, a ``*.scene_dataset_config.json``), then:

1. loads it as a 2-scene visual ``NavigationEnv``: each scene decomposed
   into boxes and cylinders for the analytic trace kernel;
2. swaps scene 0 for the loader's next file with ``reset_env_by_id`` (the
   packed rows keep their shape);
3. loads the dataset again with ``scene_kwargs={"backend": "grid"}``: the
   cameras trace the exact triangles with the triangle kernel.

    python -m visfly_tpu_torch.examples.habitat_dataset_demo [out_dir]
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ..envs import NavigationEnv


def write_cuboid_obj(path: str, cuboids) -> None:
    """Axis-aligned cuboids ((centre, half extents) pairs) as an OBJ."""
    v_lines, f_lines, base = [], [], 0
    for c, h in cuboids:
        c, h = np.asarray(c, float), np.asarray(h, float)
        for sx in (-1, 1):
            for sy in (-1, 1):
                for sz in (-1, 1):
                    p = c + h * np.array([sx, sy, sz])
                    v_lines.append(f"v {p[0]} {p[1]} {p[2]}")
        for a, b, cc, d in [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
                            (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]:
            f_lines.append(f"f {base + a + 1} {base + b + 1} {base + cc + 1}")
            f_lines.append(f"f {base + a + 1} {base + cc + 1} {base + d + 1}")
        base += 8
    with open(path, "w") as f:
        f.write("\n".join(v_lines + f_lines) + "\n")


def build_dataset(root: str) -> str:
    """The dataset under ``root`` → its scene-instance directory. A garage
    stage and a crate, three crates a scene at places drawn from numpy's
    generator of seed 0; authored in the habitat frame, y up: hab = (−std_y,
    std_z, −std_x)."""
    for d in ("configs/stages", "configs/objects", "configs/scenes", "meshes"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    t = 0.2
    write_cuboid_obj(os.path.join(root, "meshes/garage.obj"), [
        ([0.0, -t / 2, -4.0], [3 + t, t / 2, 4 + t]),  # floor
        ([-(3 + t / 2), 1.5, -4.0], [t / 2, 1.5, 4 + t]),
        ([+(3 + t / 2), 1.5, -4.0], [t / 2, 1.5, 4 + t]),
        ([0.0, 1.5, t / 2], [3 + t, 1.5, t / 2]),
        ([0.0, 1.5, -(8 + t / 2)], [3 + t, 1.5, t / 2]),
    ])
    write_cuboid_obj(os.path.join(root, "meshes/crate.obj"), [([0, 0, 0], [0.35, 0.35, 0.35])])

    def write(path, obj):
        with open(os.path.join(root, path), "w") as f:
            f.write(json.dumps(obj, indent=1))

    write("configs/stages/garage.stage_config.json", {"render_asset": "../../meshes/garage.obj"})
    write("configs/objects/crate.object_config.json", {"render_asset": "../../meshes/crate.obj"})
    rng = np.random.default_rng(0)
    for i in range(4):
        objs = [{"template_name": "crate",
                 "translation": [float(rng.uniform(-2, 2)),  # hab x = −std_y
                                 float(rng.uniform(0.4, 1.2)),  # hab y = std_z
                                 float(-rng.uniform(2.5, 7.0))],  # −std_x
                 "rotation": [1.0, 0.0, 0.0, 0.0]}
                for _ in range(3)]
        write(f"configs/scenes/garage_{i}.scene_instance.json",
              {"stage_instance": {"template_name": "garage"}, "object_instances": objs})
    write("demo.scene_dataset_config.json", {
        "stages": {"paths": {".json": ["configs/stages/*.json"]}},
        "objects": {"paths": {".json": ["configs/objects/*.json"]}},
        "scene_instances": {"paths": {".json": ["configs/scenes/*.json"]}}})
    return os.path.join(root, "configs/scenes")


def make_env(scenes: str, exact: bool = False, device="cuda") -> NavigationEnv:
    """The demo's envs: 2 scenes × 4 agents decomposed, or 2 agents in one
    scene at ``backend: "grid"`` (``exact``); 32×32 depth."""
    half = [0.0, 0.5, 0.3] if exact else [0.0, 1.0, 0.5]
    return NavigationEnv(
        num_agent_per_scene=2 if exact else 4, num_scene=1 if exact else 2, visual=True,
        device=device,
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": half}}]}},
        scene_kwargs={"path": scenes, **({"backend": "grid"} if exact else {})},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [32, 32]}],
        target=[7.0, 0.0, 1.0],
    )


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Run the demo → {"env", "state", "obs", "swapped" (the state after
    the swap), "same_shape", "changed", "env_exact", "obs_exact"}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    root = argv[0] if argv else tempfile.mkdtemp(prefix="habitat_demo")
    scenes = build_dataset(root)
    print(f"dataset at {root}", flush=True)

    env = make_env(scenes, device=device)
    state, obs = env.reset(torch.Generator(device=env.device).manual_seed(0))
    print(f"2-scene env up; depth {tuple(obs['depth'].shape)}, "
          f"range [{float(obs['depth'].min()):.2f}, {float(obs['depth'].max()):.2f}] m",
          flush=True)

    before = env.scene.params.clone()
    swapped = env.reset_env_by_id(state, 0)  # the loader's next scene
    after = env.scene.params
    # the pack's floors only grow: a swap of the same shape rewrites rows in place
    same_shape = before.shape == after.shape
    changed = (not same_shape) or not torch.allclose(before, after)
    print(f"reset_env_by_id(0): scene swapped in place (assets changed={changed}, "
          f"same shape={same_shape})", flush=True)

    env_exact = make_env(scenes, exact=True, device=device)
    _, obs_e = env_exact.reset(torch.Generator(device=env_exact.device).manual_seed(1))
    print(f"exact-triangle backend: {env_exact.scene.triangles.shape[1]} packed triangles; "
          f"centre depth {float(obs_e['depth'][0, 0, 16, 16]):.3f} m", flush=True)
    return {"env": env, "state": state, "obs": obs, "swapped": swapped,
            "same_shape": same_shape, "changed": changed, "env_exact": env_exact,
            "obs_exact": obs_e}


if __name__ == "__main__":
    main()
