"""The one traffic generator: it reads a mix's parameters from
``traffic/<name>.json`` and drives the program's env with them.

``"entry": "step"`` is a closed loop, as a rollout collector or the
upstream FPS harness runs one: actions uniform in ``action_range`` from a
generator on the card seeded by the run's seed, ``env.step(state,
action)``, every observation consumed into a sum carried across steps,
auto-reset left to the env. ``"entry": "sensor_observations"`` renders
camera batches alone: a pool of ``pose_pool`` batches of seeded poses in
the scenes' free space (the env's own spawn rejection, then a yaw uniform
in [-pi, pi) and roll and pitch uniform in ``tilt``), drawn before the
window, then ``env.sensor_observations(state)`` on the next batch of the
pool, every image consumed.

Every seed gets the same sizes and the same amount of work; the seed
changes the actions, the spawns and the poses.
"""
from __future__ import annotations

import contextlib
import math

import torch


def span(name, on):
    """A host span the trace reads, or nothing when the run is not traced."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def consume(acc, tensors):
    """Fold every tensor into the carried sum, so that nothing is skipped."""
    for v in tensors:
        acc = acc + v.float().sum()
    return acc


def _quat_from_euler(roll, pitch, yaw):
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                        cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], -1)


class Traffic:
    """One run's load on one env, from the mix's parameters and the seed."""

    def __init__(self, env, params, seed):
        self.env, self.p, self.seed = env, params, int(seed)
        self.entry = params["entry"]
        if self.entry not in ("step", "sensor_observations"):
            raise ValueError(f"unknown traffic entry {self.entry!r}")
        dev = env.device
        self.env_gen = torch.Generator(device=dev).manual_seed(self.seed)
        self.act_gen = torch.Generator(device=dev).manual_seed(self.seed ^ 0x5BD1E995)
        self.acc = torch.zeros((), device=dev)
        self.state, obs = env.reset(self.env_gen)
        self.acc = consume(self.acc, obs.values())
        self.i = 0
        if self.entry == "sensor_observations":
            self.pool = self._pose_pool(int(params["pose_pool"]))

    def _pose_pool(self, n):
        env, st = self.env, self.state
        lo, hi = self.p["tilt"]
        all_ = torch.ones((env.num_agent,), dtype=torch.bool, device=env.device)
        pool = []
        for _ in range(n):
            st = env.reset_agents(st, all_)
            N = env.num_agent
            yaw = (torch.rand((N,), generator=self.act_gen, device=env.device) * 2 - 1) * math.pi
            tilt = torch.rand((2, N), generator=self.act_gen, device=env.device) * (hi - lo) + lo
            q = _quat_from_euler(tilt[0], tilt[1], yaw).to(st.dyn.q.dtype)
            pool.append(st._replace(dyn=st.dyn._replace(q=q)))
        return pool

    @property
    def agents(self):
        return self.env.num_agent

    def action(self):
        lo, hi = self.p["action_range"]
        n = self.env.num_agent
        return torch.rand((n, 4), generator=self.act_gen, device=self.env.device) * (hi - lo) + lo

    def step(self, traced=False, keep=False):
        """One unit of work: an env step or a frame batch. With ``keep``
        returns what the correctness check needs of it."""
        if self.entry == "step":
            with span("action", traced):
                a = self.action()
            pre = self.state
            with span("env.step", traced):
                self.state, out = self.env.step(pre, a)
            with span("consume", traced):
                self.acc = consume(self.acc, [*out.obs.values(), out.reward])
                if "terminal_observation" in out.info:
                    self.acc = consume(self.acc, out.info["terminal_observation"].values())
            self.i += 1
            return (pre, a, self.state, out) if keep else None
        st = self.pool[self.i % len(self.pool)]
        with span("sensor_observations", traced):
            imgs = self.env.sensor_observations(st)
        with span("consume", traced):
            self.acc = consume(self.acc, imgs.values())
        self.i += 1
        return ((st.dyn.pos, st.dyn.q), imgs) if keep else None
