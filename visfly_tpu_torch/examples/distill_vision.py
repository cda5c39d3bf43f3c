"""Privileged-teacher → vision-student distillation for navigation
(counterpart of ``examples/distill_vision.py``).

A state-based BPTT teacher, which sees the privileged ``collision_vector``,
supervises a depth-camera student that sees only what a real drone would
(DAgger):

 1. load the teacher from a checkpoint of the port (``BPTT.save``'s ``.pt``)
    or train one for 500k steps;
 2. roll out a mixture policy, each agent taking the teacher's action with
    probability ``beta`` (1 → 0 over the rounds: the student takes over), and
    label every visited depth observation with the teacher's action;
 3. regress the student (depth + state → action) on the aggregate set, one
    full-batch Adam step an epoch;
 4. evaluate the teacher and the pure student on the same visual env.

    python -m visfly_tpu_torch.examples.distill_vision [--teacher saved/navigation2/BPTT_tpu2m_1]
                                                       [--rounds 6] [--epochs 40]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ..algos import BPTT
from ..algos.common import AdamChain, TrainerMixin
from ..envs import NavigationEnv2
from ..policies import Actor

STUDENT_ARCH = {"depth": {"cnn": 128}, "state": {"mlp": [128, 64]}}
DYNAMICS = {"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"}


def teacher_obs(obs: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """What the privileged teacher sees (no camera)."""
    return {"state": obs["state"], "collision_vector": obs["collision_vector"]}


def student_obs(obs: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """What the deployable student sees (camera + proprioception only)."""
    return {"state": obs["state"], "depth": obs["depth"]}


def make_env(agents: int = 96, device="cuda", resolution: Sequence[int] = (64, 64)
             ) -> NavigationEnv2:
    """The visual env of the collection and both evaluations: one depth camera."""
    return NavigationEnv2(
        num_agent_per_scene=agents, visual=True, device=device,
        scene_kwargs={"path": "garage_simple_l_medium"},
        sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth",
                        "resolution": list(resolution)}],
        dynamics_kwargs=dict(DYNAMICS), max_episode_steps=256)


def make_teacher(agents: int = 96, device="cuda") -> BPTT:
    """The teacher's trainer, on a sensor-free twin of the env so that its
    actor is built on the teacher's observations (state + collision vector)."""
    env = NavigationEnv2(
        num_agent_per_scene=agents, visual=True, requires_grad=True, device=device,
        scene_kwargs={"path": "garage_simple_l_medium"},
        dynamics_kwargs=dict(DYNAMICS), max_episode_steps=256)
    return BPTT(env, horizon=32, policy_kwargs={"latent_dim": (128, 128)})


def make_student(env, obs: Dict[str, Tensor], generator: Optional[torch.Generator] = None
                 ) -> Actor:
    """The student actor on the student's observations; parameters drawn on
    the CPU from ``generator`` (default: seeded with 2)."""
    if generator is None:
        generator = torch.Generator().manual_seed(2)
    shapes = {k: tuple(v.shape[1:]) for k, v in student_obs(obs).items()}
    return Actor(shapes, action_dim=env.action_size, latent_dim=(128, 128),
                 net_arch=STUDENT_ARCH, generator=generator).to(env.device)


@torch.no_grad()
def collect(env, env_state, obs, teacher_actor, student, beta: float, steps: int,
            gen: Optional[torch.Generator] = None, uniforms: Optional[Tensor] = None):
    """Roll ``steps`` env steps under the mixture (each agent takes the
    teacher's action where its uniform draw is below ``beta``, else the
    student's), recording (student observation, teacher action) →
    (env_state, obs, s_obs {key: (steps, N, ...)}, t_act (steps, N, A)). The
    draws are ``uniforms`` (steps, N, 1) or come from ``gen``."""
    s_obs: List[Dict[str, Tensor]] = []
    t_act: List[Tensor] = []
    for i in range(steps):
        ta, _ = teacher_actor(teacher_obs(obs), deterministic=True)
        sa, _ = student(student_obs(obs), deterministic=True)
        u = (uniforms[i] if uniforms is not None else
             torch.rand((ta.shape[0], 1), generator=gen, device=ta.device))
        act = torch.where(u < beta, ta, sa)
        s_obs.append(student_obs(obs))
        t_act.append(ta)
        env_state, out = env.step(env_state, torch.clamp(act, -1.0, 1.0))
        obs = out.obs
    stacked = {k: torch.stack([o[k] for o in s_obs]) for k in s_obs[0]}
    return env_state, obs, stacked, torch.stack(t_act)


def flatten(s_obs: Dict[str, Tensor], t_act: Tensor) -> Tuple[Dict[str, Tensor], Tensor]:
    """(steps, N, ...) → (steps·N, ...), step-major."""
    return ({k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in s_obs.items()},
            t_act.reshape(-1, t_act.shape[-1]))


def aggregate(agg, new):
    """The aggregate set with a round's (s_obs, t_act) appended, on the device."""
    if agg is None:
        return new
    (a_obs, a_act), (n_obs, n_act) = agg, new
    return {k: torch.cat([a_obs[k], n_obs[k]]) for k in a_obs}, torch.cat([a_act, n_act])


def train_epoch(student, opt: AdamChain, s_obs: Dict[str, Tensor], t_act: Tensor) -> Tensor:
    """One full-batch regression step on the flattened aggregate set → the
    loss before the step. No minibatching: chunking would change the order
    of the sums."""
    opt.zero_grad()
    pred, _ = student(s_obs, deterministic=True)
    loss = torch.mean((pred - t_act) ** 2)
    loss.backward()
    opt.step()
    return loss.detach()


def evaluate_policy(env, act_fn: Callable[[Dict[str, Tensor]], Tensor], max_steps: int = 256
                    ) -> Dict[str, float]:
    """``TrainerMixin.evaluate`` of ``act_fn`` (clipped to [-1, 1]) on ``env``:
    the deterministic rollout without auto-reset → the episode stats and
    ``steps``, the env steps it took."""
    mixin = TrainerMixin()
    mixin.env = env
    steps = [0]

    def predict(st, obs):
        steps[0] += 1
        return torch.clamp(act_fn(obs), -1.0, 1.0)

    mixin.predict = predict
    stats = mixin.evaluate(None, max_steps=max_steps)
    stats["steps"] = steps[0]
    return stats


def distill(env, teacher_actor, rounds: int = 6, steps: int = 96, epochs: int = 40,
            lr: float = 3e-4, eval_steps: int = 256) -> dict:
    """Stages 2-4 with the teacher's actor → {"rounds": [{"beta", "dataset",
    "loss", "first_loss", "seconds"}, ...], "teacher": stats, "student": stats,
    "student_actor"}."""
    dev = env.device
    env_state, obs = env.reset(torch.Generator(device=dev).manual_seed(1))
    student = make_student(env, obs)
    opt = AdamChain(student.parameters(), lr)  # optax.adam's defaults, no clip
    gen = torch.Generator(device=dev).manual_seed(3)
    agg = None
    history = []
    t0 = time.time()
    for r in range(rounds):
        beta = 1.0 - r / max(rounds - 1, 1)  # 1 → 0: the student takes over
        t_round = time.time()
        env_state, obs, s_obs, t_act = collect(env, env_state, obs, teacher_actor, student,
                                               beta, steps, gen)
        agg = aggregate(agg, flatten(s_obs, t_act))
        losses = [train_epoch(student, opt, *agg) for _ in range(epochs)]
        loss = float(losses[-1]) if losses else float("nan")
        history.append(dict(beta=beta, dataset=int(agg[1].shape[0]), loss=loss,
                            first_loss=float(losses[0]) if losses else float("nan"),
                            seconds=time.time() - t_round))
        print(f"round {r}: beta={beta:.2f} dataset={agg[1].shape[0]} "
              f"loss={loss:.5f} t={time.time() - t0:.0f}s", flush=True)

    def teacher_act(o):
        return teacher_actor(teacher_obs(o), deterministic=True)[0]

    def student_act(o):
        return student(student_obs(o), deterministic=True)[0]

    t_stats = evaluate_policy(env, teacher_act, eval_steps)
    print("teacher (privileged):", {k: round(float(v), 4) for k, v in t_stats.items()},
          flush=True)
    s_stats = evaluate_policy(env, student_act, eval_steps)
    print("student (depth only):", {k: round(float(v), 4) for k, v in s_stats.items()},
          flush=True)
    return {"rounds": history, "teacher": t_stats, "student": s_stats, "student_actor": student}


def load_or_train_teacher(path: str, agents: int, device) -> Tuple[BPTT, object]:
    """The teacher from ``path`` (``.pt`` appended unless present) when it
    exists, else trained for 500k steps."""
    teacher = make_teacher(agents, device)
    t_st = teacher.init(torch.Generator(device=teacher.env.device).manual_seed(0))
    file = path if path.endswith(".pt") else path + ".pt"
    if os.path.exists(file):
        t_st = teacher.load(t_st, file)
        print(f"teacher loaded from {file}", flush=True)
    else:
        print("no teacher checkpoint — training one (500k steps)…", flush=True)
        t_st = teacher.learn(500_000, state=t_st, log_interval=50)
    return teacher, t_st


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """The command line → ``distill``'s result."""
    p = argparse.ArgumentParser()
    p.add_argument("--teacher", default=os.path.join(os.getcwd(), "saved", "navigation2",
                                                     "BPTT_tpu2m_1"))
    p.add_argument("--rounds", type=int, default=6,
                   help="DAgger rounds (student takes over linearly)")
    p.add_argument("--steps", type=int, default=96, help="env steps recorded per round")
    p.add_argument("--epochs", type=int, default=40, help="regression epochs per round")
    p.add_argument("--agents", type=int, default=96)
    p.add_argument("--lr", type=float, default=3e-4)
    args = p.parse_args(argv)

    env = make_env(args.agents, device)
    teacher, _ = load_or_train_teacher(args.teacher, args.agents, device)
    return distill(env, teacher.actor, args.rounds, args.steps, args.epochs, args.lr)


if __name__ == "__main__":
    main()
