"""What every configuration's plain reference shares: the frozen dynamics,
and the comparison of one sampled step or frame batch of the program with
the reference. The reference reads the program's outputs only to judge
them; from the program's state it takes the state before a step (the start
it follows), and a respawn's pose (the stage it skips, checked apart: inside
the spawn box, its clock and counters reset).
"""
from __future__ import annotations

import numpy as np
import torch

from .frozen import dynamics as fdyn
from .frozen.dynamics import dynamics as fdyn_mod

DEPTH_TOL = 1e-3  # m: a depth pixel further off than this is off
COLOR_TOL = 2  # levels: a colour pixel with a channel further off is off


class Reference:
    """Base of a configuration's reference: its dynamics and spawn box.
    Subclasses give ``render``, ``collision`` and ``transition``."""

    image_keys = ("depth",)  # the step's observation images it renders again
    terminal_keys = ()  # the terminal observation's images it renders again

    def __init__(self, config, device, dtype=torch.float32):
        self.config = config
        self.kw = config["env_kwargs"]
        self.device = torch.device(device)
        self.dtype = dtype
        dk = {k: v for k, v in self.kw.get("dynamics_kwargs", {}).items()
              if k not in ("seed", "device")}
        self.dyn_cfg = fdyn.DroneConfig(**dk)
        self.params = fdyn.make_drone_params(self.dyn_cfg, dtype=dtype, device=self.device)
        S, A = int(self.kw.get("num_scene", 1)), int(self.kw.get("num_agent_per_scene", 1))
        self.S, self.A, self.N = S, A, S * A
        spec = self.kw["random_kwargs"]["state_generator"]["kwargs"][0]["position"]
        mean, half = np.asarray(spec["mean"], np.float64), np.asarray(spec["half"], np.float64)
        self.spawn_lo = torch.as_tensor(mean - half, device=self.device)
        self.spawn_hi = torch.as_tensor(mean + half, device=self.device)
        self.max_steps = int(self.kw.get("max_episode_steps", 256))
        self.sensors = [dict(s) for s in self.kw.get("sensor_kwargs", [])]

    def cast(self, x):
        return x.to(self.device, self.dtype) if torch.is_floating_point(x) else x.to(self.device)

    def dynamics(self, dyn, action):
        """The frozen plain dynamics step from the program's state ``dyn``."""
        fields = [self.cast(x) if isinstance(x, torch.Tensor) else x for x in dyn]
        return fdyn_mod.step(self.dyn_cfg, self.params, fdyn.DynState(*fields),
                             self.cast(action))

    def velocity(self, dyn):
        return fdyn_mod.velocity(dyn)

    def direction(self, dyn):
        return fdyn_mod.direction(dyn)


def worst_share_off(prog, ref, tol):
    """The largest share, over cameras, of pixels (all channels of a pixel
    together) where ``prog`` and ``ref`` (n, C, H, W) differ by more than
    ``tol``; a non-finite pixel is off."""
    diff = (prog.double() - ref.double()).abs()
    off = (~(diff <= tol)).any(dim=1)
    return float(off.flatten(1).double().mean(1).max()) if off.numel() else 0.0


def rel_err(prog, ref):
    """max |prog − ref| / (1 + |ref|); inf where prog is not finite."""
    if prog.numel() == 0:
        return 0.0
    p, r = prog.double(), ref.double()
    e = (p - r).abs() / (1.0 + r.abs())
    e = torch.where(torch.isfinite(p), e, torch.full_like(e, float("inf")))
    return float(e.max())


def check_step(ref, sample):
    """The numbers of one sampled step of a rollout, program against
    reference. ``sample``: (state before, action, state after, output,
    cameras to render again)."""
    pre, action, post, out, cams = sample
    dyn = ref.dynamics(pre.dyn, action)
    col = ref.collision(dyn.pos)
    reward, done = ref.transition(pre, dyn, col)
    p_done = out.done.to(ref.device)
    live = ~p_done
    fields = ("pos", "q", "vel", "omega")
    state_err = max(rel_err(getattr(post.dyn, f).to(ref.device)[live], getattr(dyn, f)[live])
                    for f in fields)
    reset = p_done
    box = ((post.dyn.pos.to(ref.device).double() >= ref.spawn_lo - 1e-5)
           & (post.dyn.pos.to(ref.device).double() <= ref.spawn_hi + 1e-5)).all(-1)
    spawn_bad = int((reset & (~box | (post.step_count.to(ref.device) != 0))).sum())
    # the collision query's answer for the agents the step left in place
    # (a respawned agent's is its new pose's)
    point, dis = post.collision.point.to(ref.device), post.collision.dis.to(ref.device)
    collision_err = max(rel_err(dis[live], col[1][live]), rel_err(point[live], col[0][live]))
    nums = {"state_err": state_err,
            "collision_err": collision_err,
            "reward_err": rel_err(out.reward.to(ref.device), reward),
            "done_bad": int((p_done != done).sum()),
            "spawn_bad": spawn_bad}
    imgs = ref.render(post.dyn.pos.to(ref.device), post.dyn.q.to(ref.device), cams)
    depth_bad = 0.0
    for k in ref.image_keys:
        depth_bad = max(depth_bad, worst_share_off(out.obs[k][cams].to(ref.device), imgs[k],
                                                   DEPTH_TOL))
    if ref.terminal_keys:
        term = ref.render(dyn.pos, dyn.q, cams)
        for k in ref.terminal_keys:
            prog = out.info["terminal_observation"][k][cams].to(ref.device)
            depth_bad = max(depth_bad, worst_share_off(prog, term[k], DEPTH_TOL))
    nums["depth_bad"] = depth_bad
    return nums


def check_frames(ref, sample):
    """The numbers of one sampled frame batch: (poses (pos, q), images the
    program rendered, cameras to render again)."""
    (pos, q), imgs, cams = sample
    want = ref.render(pos.to(ref.device), q.to(ref.device), cams)
    nums = {}
    for k, v in want.items():
        tol = DEPTH_TOL if k == "depth" else (COLOR_TOL if k == "color" else 0)
        nums[f"{k}_bad"] = worst_share_off(imgs[k][cams].to(ref.device), v, tol)
    return nums


def merge(all_nums):
    """Per number, the worst over the sampled steps or batches."""
    out = {}
    for nums in all_nums:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    return out
