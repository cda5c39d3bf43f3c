"""Evaluation harness: roll a trained policy to episode completion and record
trajectories, figures and videos (counterpart of
``visfly_tpu/utils/evaluate.py``).

The rollout runs the deterministic policy with ``is_test=True`` (no
auto-reset) under ``torch.no_grad()``, threading a recurrent policy's hidden
state through the trainer's carry hooks, until every agent is done, and
records each step's positions, velocities, rewards, dones, actions,
collision distances and clocks, and every image sensor's frames, on the
host. Figures need matplotlib; videos need imageio with a video backend or
cv2; where neither writes, the frames go to ``.npy`` files.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .common import depth2rgb
from .common import to_numpy as _np


def _write_video(path: str, imgs: np.ndarray, fps: int) -> str:
    """(T, H, W, 3) uint8 frames → an mp4 (imageio, else cv2), or the
    frames as ``.npy`` where neither can write one; returns the file."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None
    if imageio is not None:
        try:
            imageio.mimwrite(path, imgs, fps=fps)
            return path
        except ValueError:  # imageio without a video backend
            pass
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        h, w = imgs.shape[1:3]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        opened = writer.isOpened()
        if opened:
            for img in imgs:
                writer.write(np.ascontiguousarray(img[..., ::-1]))
        writer.release()
        if opened:
            return path
    npy = os.path.splitext(path)[0] + ".npy"
    np.save(npy, imgs)
    return npy


class TestBase:
    """``TestBase(model, env).test(state)``: ``model`` is a trainer of
    ``visfly_tpu_torch.algos`` whose ``state`` holds the policy; ``env``
    (default: the trainer's) is the env to evaluate in. After a rollout,
    ``last_state`` holds the env state it ended in and ``last_record`` its
    record; after ``test``, ``files`` holds the figure and videos it wrote."""

    __test__ = False  # not a pytest class

    def __init__(self, model, env=None, save_path: str = "./test_results", name: str = "test"):
        self.model = model
        self.env = env if env is not None else model.env
        self.save_path = save_path
        self.name = name
        self.last_state = None
        self.last_record: Dict[str, np.ndarray] = {}
        self.files: List[str] = []
        os.makedirs(save_path, exist_ok=True)

    @torch.no_grad()
    def rollout(self, state, max_steps: int = 1024, gen: Optional[torch.Generator] = None,
                render_every: int = 0, render_kwargs: Optional[dict] = None):
        """Step the deterministic policy until every agent is done →
        (record of stacked arrays, sensor frames by uuid, episode stats).
        ``gen`` seeds the env's reset (default: seeded with 0 on the env's
        device). ``render_every > 0`` adds a global-view frame with the
        trajectories every k steps, as ``sensor_frames["global"]``."""
        env = self.env
        if gen is None:
            gen = torch.Generator(device=env.device).manual_seed(0)
        env_state, obs = env.reset(gen)
        global_frames: List[np.ndarray] = []
        record: Dict[str, List] = {k: [] for k in ("position", "velocity", "reward", "done",
                                                    "action", "collision_dis", "t")}
        sensor_frames: Dict[str, List] = {}
        all_done = np.zeros(env.num_envs, bool)
        returns = np.zeros(env.num_envs)
        lengths = np.zeros(env.num_envs, np.int32)
        success = np.zeros(env.num_envs, bool)
        carry = self.model.init_predict_carry(obs)

        for i in range(max_steps):
            action, carry = self.model.predict_step(state, obs, carry)
            env_state, out = env.step(env_state, action, is_test=True)
            obs = out.obs
            carry = self.model.mask_predict_carry(carry, out.done)
            done_now = _np(out.done)
            active = ~all_done
            returns += _np(out.reward) * active
            lengths += active.astype(np.int32)
            success |= _np(out.info["is_success"]) & active

            record["position"].append(_np(env_state.dyn.pos))
            record["velocity"].append(_np(env_state.dyn.vel))
            record["reward"].append(_np(out.reward))
            record["done"].append(done_now)
            record["action"].append(_np(action))
            record["collision_dis"].append(_np(env_state.collision.dis))
            record["t"].append(_np(env_state.dyn.t))
            for k, v in obs.items():
                if v.dim() >= 3:  # image sensors
                    sensor_frames.setdefault(k, []).append(_np(v))
            if render_every and i % render_every == 0 and env.scene is not None:
                frame = env.render(env_state, traj_history=np.stack(record["position"]),
                                   trajectory=True, **(render_kwargs or {}))
                global_frames.append(frame)

            all_done |= done_now
            if all_done.all():
                break

        stats = {
            "episode_returns": returns,
            "episode_lengths": lengths,
            "success": success,
            "success_rate": float(success.mean()),
            "mean_return": float(returns.mean()),
            "mean_length": float(lengths.mean()),
        }
        arrays = {k: np.stack(v) for k, v in record.items()}
        self.last_state, self.last_record = env_state, arrays
        if global_frames:
            sensor_frames["global"] = [f[None] for f in global_frames]
        return arrays, sensor_frames, stats

    def draw(self, arrays: Dict[str, np.ndarray]) -> Optional[str]:
        """Per-env state figures (xy trajectory, altitude, speed, reward)
        where matplotlib imports → the PNG's path, else None."""
        try:
            import matplotlib
        except ImportError:
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from .figfashion import FigFon

        FigFon.set_fashion("IEEE")
        pos = arrays["position"]  # (T, N, 3)
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        axes[0, 0].plot(pos[:, :, 0], pos[:, :, 1], lw=0.8)
        axes[0, 0].set_title("xy trajectory")
        axes[0, 1].plot(pos[:, :, 2], lw=0.8)
        axes[0, 1].set_title("altitude")
        axes[1, 0].plot(np.linalg.norm(arrays["velocity"], axis=-1), lw=0.8)
        axes[1, 0].set_title("speed")
        axes[1, 1].plot(arrays["reward"], lw=0.8)
        axes[1, 1].set_title("reward")
        for ax in axes.flat:
            ax.grid(alpha=0.3)
        out = os.path.join(self.save_path, f"{self.name}_trajectories.png")
        fig.tight_layout()
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return out

    def save_video(self, sensor_frames: Dict[str, np.ndarray], fps: int = 30) -> List[str]:
        """One video per sensor, of the first agent's frames (depth and
        semantic as heat images; ``"global"`` frames as they are)."""
        paths = []
        for name, frames in sensor_frames.items():
            frames = np.stack(frames) if isinstance(frames, list) else frames
            # (T, N, C, H, W) sensors → first agent; (T, 1, H, W, 3) globals
            f0 = frames[:, 0]
            if f0.ndim == 4 and f0.shape[-1] == 3:  # global view, already HWC
                imgs = f0.astype(np.uint8)
            elif f0.shape[1] == 1:  # depth/semantic (T, 1, H, W)
                imgs = np.stack([depth2rgb(f[0]) for f in f0])
            else:
                imgs = np.transpose(f0, (0, 2, 3, 1)).astype(np.uint8)
            paths.append(_write_video(os.path.join(self.save_path, f"{self.name}_{name}.mp4"),
                                      imgs, fps))
        return paths

    def test(self, state=None, max_steps: int = 1024, is_render: bool = True, **_ignored):
        """Rollout, then the figure and the videos when ``is_render`` →
        the episode stats."""
        arrays, sensor_frames, stats = self.rollout(state, max_steps)
        fig = self.draw(arrays) if is_render else None
        videos = self.save_video(sensor_frames) if (is_render and sensor_frames) else []
        self.files = ([fig] if fig else []) + videos
        print(
            f"[eval] success={stats['success_rate']:.2%} "
            f"return={stats['mean_return']:.2f} length={stats['mean_length']:.1f}"
            + (f" fig={fig}" if fig else "")
            + (f" videos={videos}" if videos else ""),
            flush=True,
        )
        return stats
