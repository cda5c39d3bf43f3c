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

With ``--kernels`` each process measures instead the kernels as each
checkout's render launches them: the card's milliseconds per render
(``torch.profiler``, 20 renders after 3) in ``trace_analytic_kernel`` (B1,
B1-kid) of the depth leg's 64×64 depth camera, path A's colour camera and
path B's four-sensor suite (its semantic camera; the marches are not
counted), and at 23,040 triangles of path D's garage in
``tri_trace_mx_kernel`` (B7b) of one 64×64 ``tri_variant: "mx"`` camera and
in ``tri_trace_kernel`` (B6) of one plain 64×64 camera, all at 256 agents.
The kernel's device time, not CUDA events around a call, which hold the
wrapper's host time too: the mean over the launches a trace holds, printed
beside each time, and taken only from a trace that holds at least 18 of the
20 (``traced_ms``).
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


# column -> the kernel it reads, by the profiler's name: the analytic kernel in
# the depth leg's render, path A's and path B's; at 23,040 triangles B7b in
# path D's render of one 64×64 mx sensor and B6 in its render of one plain one
KERNEL_ENVS = {"depth": "trace_analytic_kernel", "A": "trace_analytic_kernel",
               "B": "trace_analytic_kernel", "D_mx": "tri_trace_mx_kernel",
               "D_camsoup": "tri_trace_kernel"}


def kernel_envs(dev, mesh_dir):
    """The envs of KERNEL_ENVS, as each checkout's chip_smoke.py builds them."""
    import chip_smoke as cs

    obj = cs.write_obj(os.path.join(mesh_dir, "garage_3.obj"), *cs.garage_mesh(3))
    camsoup = cs.mesh_env(dev, {"path": obj, "backend": "grid"}, ["depth"])
    return {"depth": cs.bench_env(dev), "A": cs.landing_env(dev),
            "B": cs.bench_env(dev, cs.SUITE), "D_camsoup": camsoup,
            "D_mx": cs.mesh_env(dev, {"data": camsoup.scene}, ["depth_mx"], variants=True)}


def traced_ms(fn, kernel, name, reps=20):
    """The card's ms per launch of ``kernel`` over ``reps`` calls of ``fn``,
    one launch each, from a ``torch.profiler`` trace → (ms, launches the
    trace held). A trace can miss the first kernels it should hold, so eight
    small kernels go first in each. The mean is taken over the launches the
    trace holds, only if they are at least 90% of ``reps``; a trace with fewer
    is taken again, and the third such fails. A render launches more kernels
    than the one read here, so ``chip_smoke.device_ms``'s queued events, which
    count them all, do not serve; a trace after a short one can misread a
    short kernel (``chip_profile.py timing``)."""
    import torch

    pad = torch.zeros(1, device="cuda")
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                pad.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in prof.key_averages() if kernel in r.key]
        us = sum(getattr(r, "device_time_total", 0) or getattr(r, "cuda_time_total", 0)
                 for r in rows)
        n = sum(r.count for r in rows)
        if us > 0 and 0.9 * reps <= n <= reps:
            return us / n / 1e3, n
        print(f"{name}: the trace held {n} of {reps} launches of {kernel}; traced again",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"{name}: three traces held under 90% of {reps} launches of {kernel}")


def run_kernels(checkout):
    """One process's kernel measurement of ``checkout`` → prints the ms per
    render of each of KERNEL_ENVS, then the launches each trace held."""
    import tempfile

    checkout = os.path.abspath(checkout)
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch

    from visfly_tpu_torch.render import render_sensors

    dev = torch.device("cuda", 0)
    out = []
    with tempfile.TemporaryDirectory(prefix="visfly_garage_") as mesh_dir:
        envs = kernel_envs(dev, mesh_dir)
        for name, kernel in KERNEL_ENVS.items():
            env = envs[name]
            state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
            for _ in range(3):
                render_sensors(env, state)
            torch.cuda.synchronize()
            out.append(traced_ms(lambda: render_sensors(env, state), kernel, name))
    print(" ".join(f"{x[0]:.5f}" for x in out), " ".join(str(x[1]) for x in out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--run", action="store_true", help="measure PARENT in this process")
    ap.add_argument("--kernels", action="store_true",
                    help="the kernels' device time a render, not the depth leg's step")
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
                k = len(KERNEL_ENVS)
                ms, held = out[-2 * k:-k], out[-k:]
                results[s].append([float(x) for x in ms])
                print(f"pair {i + 1} | {s}: kernel ms a render (launches traced of 20) "
                      + ", ".join(f"{e} {x} ({n})" for e, x, n in zip(KERNEL_ENVS, ms, held))
                      + f" | {card}", flush=True)
                continue
            results[s].append((float(out[-2]), float(out[-1])))
            print(f"pair {i + 1} | {s}: {out[-2]} ms a step, {out[-1]} operators a step | {card}",
                  flush=True)
    if args.kernels:
        for s, rows in results.items():
            print(f"{s}: kernel ms a render, median (range) "
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
