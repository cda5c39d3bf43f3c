#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``visfly_tpu_torch``).

Drives the port's main path, the depth leg of ``bench.py``, on one CUDA
card: ``NavigationEnv`` with 256 agents in the procedural
``garage_simple_l_medium`` scene, 64×64 depth rendered every step, bodyrate
control at dt = ctrl_dt = 0.03, actions uniform in [-0.3, 0.3], stepped in
32-step chunks. Phases, one line each; any failure exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the package, from the sources in the
   checkout;
3. kernel vs plain PyTorch on the card at the main-path shapes (the reset
   agents' camera rays, 1 M random rays, a scene with dynamic capsules):
   max |Δt| ≤ 1e-3 m on rays that both hit, hit disagreeing on ≤ 1e-5 of
   rays; both timed with CUDA events (median of 20);
4. the slice: reset, 1 warm-up chunk, 6 timed chunks; every render must
   have launched the kernel, outputs finite, depth in [0, 20];
5. one step from the same state on the card and on the CPU plain path:
   depth within 1e-3 m on all but ≤ 1e-5 of pixels (silhouette pixels that
   see another object after last-ulp differences in the dynamics), state
   obs within 1e-4.

The line before the last is a JSON object with each kernel's route,
source, launches in phase 4, error and times; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py
"""
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_AGENTS = 256
RES = (64, 64)
CHUNK = 32
N_CHUNKS = 6
MAX_DEPTH = 20.0
T_TOL = 1e-3  # m; grazing rays amplify rounding in the slab divisions
HIT_TOL = 1e-5  # share of rays whose hit flag may differ (grazing rays)
OBS_TOL = 1e-4


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def bench_env(device):
    from visfly_tpu_torch.envs import NavigationEnv

    return NavigationEnv(
        num_agent_per_scene=N_AGENTS,
        visual=True,
        scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": 40},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": list(RES)}],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        max_episode_steps=256,
        device=device,
    )


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_trace(name, kscene, o, d):
    """Kernel vs plain version on the same card tensors → (max |Δt| on rays
    that both hit, share of rays whose hit differs)."""
    import torch

    from visfly_tpu_torch.render import trace_analytic, trace_analytic_reference

    t_k, hit_k = trace_analytic(kscene, o, d, MAX_DEPTH)
    t_p, hit_p = trace_analytic_reference(kscene, o, d, MAX_DEPTH)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(t_k).all()), f"{name}: non-finite kernel output")
    both = hit_k & hit_p
    err = float((t_k - t_p).abs()[both].max()) if bool(both.any()) else 0.0
    flip = float((hit_k != hit_p).float().mean())
    print(f"phase 3 | {name}: rays={o.shape[2] * o.shape[1]} hit={float(hit_k.float().mean()):.4f} "
          f"max|dt|={err:.3e} m hit_mismatch={flip:.3e}", flush=True)
    check(err <= T_TOL, f"{name}: max |dt| {err} > {T_TOL}")
    check(flip <= HIT_TOL, f"{name}: hit mismatch {flip} > {HIT_TOL}")
    return err


def main_path_rays(env, state):
    from visfly_tpu_torch.render import camera_rays_components

    spec = env.sensor_kwargs[0]
    n, hw = env.num_agent, RES[0] * RES[1]
    o_c, d_c, _ = camera_rays_components(spec, state.dyn.pos, state.dyn.q, env.cameras[0])
    o = o_c[:, :, None].expand(3, n, hw).reshape(3, 1, n * hw)
    return o, d_c.reshape(3, 1, n * hw).contiguous()


def to_device(x, device, gen):
    """EnvState → the same state on ``device`` with generator ``gen``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, torch.Generator):
        return gen
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_device(v, device, gen) for v in x))
    return x


def main():
    if not os.path.isdir(os.path.join(REPO, "visfly_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(visfly_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    # 1. environment
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs one CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"phase 1 | torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} | {torch.cuda.get_device_name(0)}", flush=True)
    print(card, flush=True)

    # 2. build every kernel from the checkout's sources
    from visfly_tpu_torch.build import build_all

    t0 = time.perf_counter()
    built = build_all()
    for name, (secs, log) in built.items():
        info = " ".join(line.strip() for line in log.splitlines() if "Used" in line)
        print(f"phase 2 | built {name} in {secs:.1f} s | {info}", flush=True)
    print(f"phase 2 | build total {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernel vs plain on the card at the main-path shapes
    from visfly_tpu_torch.render import (prepare_kernel_scene, trace_analytic,
                                         trace_analytic_reference)
    from visfly_tpu_torch.render import trace_kernel

    env = bench_env(dev)
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
    kscene = prepare_kernel_scene(env.scene)
    o, d = main_path_rays(env, state)
    errs = [compare_trace("camera rays of 256 reset agents", kscene, o, d)]
    g = torch.Generator(device=dev).manual_seed(1)
    r = 1 << 20
    o_rand = (torch.rand((3, 1, r), generator=g, device=dev)
              * torch.tensor([19.0, 11.0, 4.5], device=dev)[:, None, None]
              + torch.tensor([-1.5, -5.5, 0.25], device=dev)[:, None, None])
    d_rand = torch.randn((3, 1, r), generator=g, device=dev)
    d_rand = d_rand / torch.linalg.vector_norm(d_rand, dim=0, keepdim=True)
    errs.append(compare_trace("1M random rays", kscene, o_rand.contiguous(),
                              d_rand.contiguous()))
    objects = (state.dyn.pos[None], torch.full((1, N_AGENTS), 0.15, device=dev))
    errs.append(compare_trace("camera rays with 256 dynamic capsules",
                              prepare_kernel_scene(env.scene, objects), o, d))
    ms = cuda_ms(lambda: trace_analytic(kscene, o, d, MAX_DEPTH))
    plain_ms = cuda_ms(lambda: trace_analytic_reference(kscene, o, d, MAX_DEPTH))
    print(f"phase 3 | trace_analytic at ({3}, 1, {o.shape[2]}): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms (median of 20) | {card}", flush=True)

    # 4. the slice: reset, 1 warm-up chunk, 6 timed chunks
    gen = torch.Generator(device=dev).manual_seed(0)
    act_gen = torch.Generator(device=dev).manual_seed(1)
    trace_kernel.LAUNCHES = 0
    state, obs = env.reset(gen)
    renders = 1
    carried = torch.zeros((), device=dev)

    def chunk(state, carried):
        for _ in range(CHUNK):
            a = torch.rand((N_AGENTS, 4), generator=act_gen, device=dev) * 0.6 - 0.3
            state, out = env.step(state, a)
            obs_sum = sum(v.float().sum() for v in out.obs.values())
            carried = carried + out.reward.sum() + obs_sum * 1e-12
        return state, carried, out

    state, carried, out = chunk(state, carried)
    renders += CHUNK
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CHUNKS):
        state, carried, out = chunk(state, carried)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    renders += CHUNK * N_CHUNKS
    launches = trace_kernel.LAUNCHES
    check(launches == renders, f"kernel launches {launches} != renders {renders}")
    depth = out.obs["depth"]
    check(tuple(depth.shape) == (N_AGENTS, 1, *RES), f"depth shape {tuple(depth.shape)}")
    check(bool(torch.isfinite(carried)), "carried sum is not finite")
    check(bool(torch.isfinite(out.obs["state"]).all()), "state obs not finite")
    check(bool(((depth >= 0) & (depth <= MAX_DEPTH)).all()), "depth outside [0, 20]")
    sps = N_AGENTS * CHUNK * N_CHUNKS / dt
    print(f"phase 4 | {launches} kernel launches for {renders} renders | "
          f"{sps:.1f} env steps/s ({N_AGENTS} agents, {RES[0]}x{RES[1]} depth, "
          f"{N_CHUNKS}x{CHUNK} steps in {dt:.3f} s) | {card}", flush=True)

    # 5. one step from the same state, card vs CPU plain path
    env_cpu = bench_env("cpu")
    state_cpu = to_device(state, "cpu", torch.Generator().manual_seed(0))
    a = torch.rand((N_AGENTS, 4), generator=act_gen, device=dev) * 0.6 - 0.3
    _, out_gpu = env.step(state, a, is_test=True)
    _, out_cpu = env_cpu.step(state_cpu, a.cpu(), is_test=True)
    # the two devices' float32 dynamics differ in the last ulps, so a pixel on
    # a silhouette may see another object: such pixels count as mismatches
    # and may be at most HIT_TOL of the image
    diff = (out_gpu.obs["depth"].cpu() - out_cpu.obs["depth"]).abs()
    off = diff > T_TOL
    d_err = float(diff[~off].max())
    d_flip = float(off.float().mean())
    s_err = float((out_gpu.obs["state"].cpu() - out_cpu.obs["state"]).abs().max())
    print(f"phase 5 | card vs cpu: depth max|d|={d_err:.3e} m on all but "
          f"{int(off.sum())} of {diff.numel()} pixels (silhouette share {d_flip:.3e}, "
          f"largest {float(diff.max()):.3f} m) | state max|d|={s_err:.3e}", flush=True)
    check(d_flip <= HIT_TOL, f"depth card vs cpu off by > {T_TOL} m on {d_flip} of pixels")
    check(s_err <= OBS_TOL, f"state obs card vs cpu {s_err} > {OBS_TOL}")

    print(json.dumps({"kernels": [{
        "name": "trace_analytic",
        "route": "cuda",
        "source": "visfly_tpu_torch/csrc/trace_analytic.cu",
        "replaces": "visfly_tpu/render/pallas_trace.py:385",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
