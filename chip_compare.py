#!/usr/bin/env python3
"""Compare the depth leg of two checkouts on one card, inside one call.

The depth leg is host-bound, and the host's clock spreads by tens of percent
between processes, so two versions are compared in alternating pairs:

    python3 chip_compare.py PARENT_DIR [CHANGE_DIR] [--pairs 10]

runs parent, change, change, parent, ... (one process each, 2 per pair and
side), each process driving ``chip_smoke.bench_env`` of its checkout for 1
warm-up chunk and 6 timed chunks of 32 steps, and prints every run, then per
side the median and range of the milliseconds a step took and the operators
a step dispatched (counted by ``torch.profiler``, free of the clock's noise).
``CHANGE_DIR`` defaults to the checkout this script lies in.

With ``--kernels`` each process measures instead the analytic trace kernel
(B1, B1-kid) as each checkout's render launches it: the card's milliseconds
in ``trace_analytic_kernel`` per render (``torch.profiler``, 20 renders after
3), of the depth leg's 64×64 depth camera, path A's colour camera and path
B's four-sensor suite (its semantic camera; the marches are not counted), all
at 256 agents. The kernel's device time, not CUDA events around a call, which
hold the wrapper's host time too.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

CHUNK, N_CHUNKS = 32, 6


def run(checkout):
    """One process's measurement of ``checkout`` → prints "ms_per_step ops_per_step"."""
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    env = cs.bench_env(dev)
    n = env.num_agent
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
    act_gen = torch.Generator(device=dev).manual_seed(1)

    def chunk(state):
        carried = torch.zeros((), device=dev)
        for _ in range(CHUNK):
            a = torch.rand((n, 4), generator=act_gen, device=dev) * 0.6 - 0.3
            state, out = env.step(state, a)
            carried = carried + out.reward.sum() + sum(
                v.float().sum() for v in out.obs.values()) * 1e-12
        return state, carried

    state, _ = chunk(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CHUNKS):
        state, carried = chunk(state)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (CHUNK * N_CHUNKS) * 1e3
    if not bool(torch.isfinite(carried)):
        raise RuntimeError("the rollout's carried sum is not finite")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(4):
            state, _ = env.step(state, torch.zeros((n, 4), device=dev))
    ops = sum(e.count for e in prof.key_averages()) / 4
    print(f"{ms:.3f} {ops:.1f}")


KERNEL_ENVS = ("depth", "A", "B")


def run_kernels(checkout):
    """One process's kernel measurement of ``checkout`` → prints the ms per
    render of each of KERNEL_ENVS."""
    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch

    import chip_smoke as cs
    from visfly_tpu_torch.render import render_sensors

    dev = torch.device("cuda", 0)
    envs = {"depth": cs.bench_env(dev), "A": cs.landing_env(dev), "B": cs.bench_env(dev, cs.SUITE)}
    out = []
    for name in KERNEL_ENVS:
        env = envs[name]
        state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
        for _ in range(3):
            render_sensors(env, state)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                render_sensors(env, state)
            torch.cuda.synchronize()
        us = sum(getattr(r, "device_time_total", 0) or getattr(r, "cuda_time_total", 0)
                 for r in prof.key_averages() if "trace_analytic_kernel" in r.key)
        if us <= 0:
            raise RuntimeError(f"{name}: the profiler saw no analytic kernel")
        out.append(us / 20 / 1e3)
    print(" ".join(f"{x:.5f}" for x in out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--run", action="store_true", help="measure PARENT in this process")
    ap.add_argument("--kernels", action="store_true",
                    help="the analytic kernel's device time a render, not the depth leg's step")
    args = ap.parse_args()
    if args.run:
        (run_kernels if args.kernels else run)(args.parent)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    sides = {"parent": args.parent, "change": args.change}
    results = {k: [] for k in sides}
    order = ["parent", "change", "change", "parent"]
    for i in range(args.pairs):
        side = order[i % 4]
        for s in (side, "change" if side == "parent" else "parent"):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), sides[s], "--run"]
                                 + (["--kernels"] if args.kernels else []),
                                 capture_output=True, text=True, check=True).stdout.split()
            if args.kernels:
                results[s].append([float(x) for x in out[-len(KERNEL_ENVS):]])
                print(f"pair {i + 1} | {s}: analytic kernel ms a render "
                      + ", ".join(f"{e} {x}" for e, x in zip(KERNEL_ENVS, out[-len(KERNEL_ENVS):]))
                      + f" | {card}", flush=True)
                continue
            results[s].append((float(out[-2]), float(out[-1])))
            print(f"pair {i + 1} | {s}: {out[-2]} ms a step, {out[-1]} operators a step | {card}",
                  flush=True)
    if args.kernels:
        for s, rows in results.items():
            print(f"{s}: analytic kernel ms a render, median (range) "
                  + ", ".join(f"{e} {statistics.median(col):.5f} ({min(col):.5f}-{max(col):.5f})"
                              for e, col in zip(KERNEL_ENVS, zip(*rows)))
                  + f", {len(rows)} runs | {card}", flush=True)
        return 0
    for s, rows in results.items():
        ms = [r[0] for r in rows]
        print(f"{s}: median {statistics.median(ms):.3f} ms a step (range {min(ms):.3f}-"
              f"{max(ms):.3f}, {len(ms)} runs), {statistics.median(r[1] for r in rows):.1f} "
              f"operators a step | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
