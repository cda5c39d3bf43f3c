"""Per-reward-term BPTT gradient norms on ``cluttered_flight`` (counterpart of
``examples/_vision_grad_probe.py``).

For each reward term of ``NavigationEnv`` (``indiv_reward=True``), the norm of
d(−mean Σ_t d_t·term_t)/d(actor parameters) over an H-step differentiable
rollout of the depth-camera policy (d the discount, reset at done), with the
collision query detached (the reference's rule) and differentiable
(``grad_collision=True``); with the cosine of each collision term's gradient
against the task terms' (approach, view, vel, omega). One rollout serves
every term: the per-term losses are taken apart and differentiated one after
another on the same graph, which is what a rollout per term gives, since the
weights do not change the rollout.

    python -m visfly_tpu_torch.examples.vision_grad_probe [updates]
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Sequence

import torch

from ..algos import BPTT
from ..envs import NavigationEnv

H = 16
N = 16
TERMS = ["approach", "view", "upright", "vel", "omega", "col_dis", "col_closing", "success"]
POLICY = {"latent_dim": (128, 128),
          "net_arch": {"depth": {"cnn": 128}, "state": {"mlp": [128, 64]},
                       "target": {"mlp": [64]}}}


def make_trainer(grad_collision: bool, n: int = N, horizon: int = H, resolution=(64, 64),
                 device="cuda") -> BPTT:
    """The probe's BPTT over its differentiable depth env."""
    env = NavigationEnv(
        num_agent_per_scene=n, visual=True, requires_grad=True, device=device,
        indiv_reward=True, grad_collision=grad_collision,
        scene_kwargs={"path": "garage_simple_l_medium"},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth",
                        "resolution": list(resolution)}],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        max_episode_steps=256,
    )
    return BPTT(env, horizon=horizon, learning_rate=5e-4, policy_kwargs=POLICY)


def term_losses(tr: BPTT, st, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The H-step rollout from ``st`` → (len(TERMS),) losses, term k's
    −mean over agents of Σ_t d_t·term_k,t. The action noise of step i is
    ``noise[i]`` (H, N, 4) or drawn from ``st.gen``."""
    env = tr.env
    n, dev = env.num_envs, env.device
    env_state, obs = st.env_state, st.obs
    discount = torch.ones((n,), device=dev)
    loss = torch.zeros((len(TERMS), n), device=dev)
    for i in range(tr.H):
        eps = (env._rows_draw(torch.randn, st.gen, (env.action_size,), torch.float32)
               if noise is None else noise[i])
        action, _ = tr.actor(obs, st.gen, noise=eps)
        env_state, out = env.step(env_state, torch.clamp(action, -1.0, 1.0))
        terms = torch.stack([out.info[f"extra_{k}"] for k in TERMS])
        loss = loss - terms * discount
        done = out.done.to(discount.dtype)
        discount = discount * 0.99 * (1.0 - done) + done
        obs = out.obs
    return loss.mean(-1)


def grad_norms(tr: BPTT, st, noise: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Each term's gradient norm, the total's, and the cosines of the two
    collision terms against the task terms."""
    params = list(tr.actor.parameters())
    losses = term_losses(tr, st, noise)

    def flat_grad(loss):
        gs = torch.autograd.grad(loss, params, retain_graph=True, allow_unused=True)
        return torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for g, p in zip(gs, params)])

    grads = {name: flat_grad(losses[i]) for i, name in enumerate(TERMS)}
    grads["TOTAL"] = flat_grad(losses.sum())
    out = {name: float(torch.linalg.vector_norm(g)) for name, g in grads.items()}
    # direction conflict: does a collision term's gradient fight the task's?
    rest = grads["approach"] + grads["view"] + grads["vel"] + grads["omega"]
    rest_norm = float(torch.linalg.vector_norm(rest))
    for name in ("col_dis", "col_closing"):
        denom = out[name] * rest_norm
        out[f"cos({name},task)"] = (float(grads[name] @ rest) / denom if denom > 0
                                    else float("nan"))
    return out


def probe(grad_collision: bool, updates: int = 0, device="cuda", **size) -> Dict[str, float]:
    """The norms for a fresh policy from seed 0, or after ``updates`` BPTT
    updates of it (``size``: ``n``, ``horizon``, ``resolution``)."""
    tr = make_trainer(grad_collision, device=device, **size)
    st = tr.init(torch.Generator(device=tr.env.device).manual_seed(0))
    for _ in range(updates):  # optionally probe a partly trained policy
        st, _ = tr.update(st)
    return grad_norms(tr, st)


def main(argv: Optional[Sequence[str]] = None, device="cuda", **size) -> dict:
    """Both settings of ``grad_collision`` → {flag: norms}."""
    argv = list(sys.argv[1:] if argv is None else argv)
    ups = int(argv[0]) if argv else 0
    out = {}
    for flag in (False, True):
        t0 = time.time()
        out[flag] = probe(flag, ups, device, **size)
        print(f"grad_collision={flag} (after {ups} updates, {time.time() - t0:.0f}s):",
              flush=True)
        for k, v in out[flag].items():
            print(f"  {k:12s} |grad| = {v:.3e}", flush=True)
    return out


if __name__ == "__main__":
    main()
