#!/usr/bin/env python3
"""Where an env step's time goes on the card, for the paths ``chip_smoke.py``
drives: per part the host-clocked milliseconds of a call (synchronised, mean
of 50 after 5 warm-up calls), then one ``torch.profiler`` window of 8 steps
for the device's busy time per step. The profiler about doubles the host
time of a step, so the idle share is taken against the step time clocked
without it.

    python3 chip_profile.py [depth] [A] [B] [C]      # default: A C

Every line ends with the card's name and power limit.
"""
import subprocess
import sys
import time

import torch

import chip_smoke as cs
from visfly_tpu_torch.dynamics import dynamics as dyn_mod


def host_ms(fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile(name, env, card):
    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = env.reset(gen)
    n = env.num_agent
    act = lambda: torch.rand((n, 4), generator=gen, device=dev) * 0.6 - 0.3  # noqa: E731
    for _ in range(16):  # into the steady state: some agents reset every step
        state, _ = env.step(state, act())
    a = act()
    parts = {
        "env.step (whole, with auto-reset)": lambda: env.step(state, a),
        "env.step(is_test=True) (no auto-reset)": lambda: env.step(state, a, is_test=True),
        "_spawn (all agents)": lambda: env._spawn(gen),
        "_update_collision": lambda: env._update_collision(state.dyn, state.once_collided),
        "dynamics.step": lambda: dyn_mod.step(env.dyn_config, env.params, state.dyn, a,
                                              wind_const=env.wind_const),
    }
    if env.visual:
        parts["render_sensors (rays, kernels, shading)"] = lambda: env.sensor_observations(state)
    if env.needs_sensors_for_reward:
        images = env.sensor_observations(state)
        parts["update_aux_from_sensors (images given)"] = lambda: env.update_aux_from_sensors(
            state, images)
    step_ms = None
    for part, fn in parts.items():
        ms = host_ms(fn)
        step_ms = ms if step_ms is None else step_ms  # the first part is the whole step
        print(f"{name} | {part}: {ms:.3f} ms per call | {card}", flush=True)

    steps = 8
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = env.step(state, act())
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator row repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"{name} | profiler: {steps} steps in {wall:.1f} ms with the profiler on, device busy "
          f"{busy / steps:.3f} ms a step, idle share {1 - busy / steps / step_ms:.3f} of the "
          f"{step_ms:.3f} ms step | {card}", flush=True)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"{name} | profiler top: {e.key[:60]} x{e.count}: "
              f"{e.self_device_time_total / 1e3:.3f} ms | {card}", flush=True)


def main(argv):
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_profile.py needs one CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    make_env = {"depth": lambda: cs.bench_env(dev), "A": lambda: cs.landing_env(dev),
                "B": lambda: cs.bench_env(dev, cs.SUITE), "C": lambda: cs.hover_env(dev)}
    for name in argv or ["A", "C"]:
        profile(f"path {name}", make_env[name](), card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
