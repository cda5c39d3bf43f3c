#!/usr/bin/env python3
"""Where an env step's time goes on the card, for the paths ``chip_smoke.py``
drives: per part the host-clocked milliseconds of a call (synchronised, mean
of 50 after 5 warm-up calls), then one ``torch.profiler`` window of 8 steps
for the device's busy time per step. The profiler about doubles the host
time of a step, so the idle share is taken against the step time clocked
without it.

    python3 chip_profile.py [depth] [A] [B] [C] [D0] [D2] [D3] [E] [F] [G] [K] [O] [sv]
                            [probe] [floor] [split] [march] [analytic] [mx] [timing]
                            [plane] [r4] [tile] [list] [sweep]
                            # default: A C

``D0``, ``D2`` and ``D3`` are path D, the imported garage mesh subdivided 0, 2
and 3 times (360, 5,760 and 23,040 triangles); they also clock the parts of
a mesh step: the cull prepass and the triangle kernel of each sensor, the
exact closest-point query and the spawn rejection on the baked grid.

``sv`` is no path: it reads how far float32 rounding moves t in each body of
the triangle kernel, against a float64 brute force on the same float32
geometry, with lists that hold the whole mesh: 8 cameras of 64×64 in the
garage at 5,760 and 23,040 triangles, the mesh and the cameras moved together
0, 20 and 40 m away from the coordinates' origin. Beside the port's bodies
(``sv_cam``, ``sv_tile``, ``mt``, and ``mx``, the per-camera test as a matrix
product on the tensor cores in split TF32) it reads the expanded coefficients
of the JAX package's per-camera pages, ``g0 = b×c + o×(b − c)``, which
multiply world coordinates before they subtract (``pages``: every triangle
against every ray of a camera, in plain PyTorch); the port's bodies subtract
the origin first.

``E`` and ``F`` are the BPTT paths (``HoverEnv``, 128 agents, H = 32; visual
``NavigationEnv2``, 64 agents, 64×64 depth, H = 8, in the primitive scene and
in the 23,040-triangle garage with ``tri_variant: "merged"``): where an
update's time goes, host-clocked and synchronised after each part (forward
rollout, backward pass, clip and Adam step; mean of 3 updates after 1
warm-up), then one ``torch.profiler`` window of one update for the device's
busy time.

``G`` is the default training run, PPO on ``cluttered_flight`` at 48 agents
(``chip_smoke.py`` path G): an update's rollout, GAE and epochs, host-clocked
and synchronised; a rollout step's parts (the env step with and without the
terminal observation, one render, the spawn rejection, the policy forward,
the episode window); then one ``torch.profiler`` window of 8 rollout steps.
``K`` is the swarm crossing run (path K: PPO_tuned on ``crossing``, 24
scenes × 3 agents) the same way, and besides: the drones' mesh hits of one
render and B1 alone on the static scene, each with its device-busy time
from its own profiler window, and the collision query with and without the
inter-drone override.

``O`` is path O, the habitat dataset ``chip_smoke.py`` writes, at both
backends (O1 decomposed into primitives, O2 exact and textured, 4 scenes ×
64 agents, 64×64 depth, colour and semantic): the seconds to load each
backend's four scenes, then a step's parts as for the other paths (on O2
with each sensor's prepass and kernel, ``tri_closest_point`` at ~47,600
triangles a scene, the grid's spawn test and the colour sensor's texture
gathers), and the device-busy share of 8 steps.

``probe`` and ``floor`` are the triangle kernel's two diagnostics at 23,040
triangles (the counterparts of ``examples/_tri_probe.py`` and
``examples/_tri_kernel_exp.py``), both on the list walk of ``csrc/tri_tile.cu``
that renders launch, each timed beside the cluster walk at k = 1 that took
them before. ``probe``: stages executed per tile (mean, p50, p90, max; the
list walk's count, summed over a tile's two blocks, beside the cluster walk's
tile-wide vote) and the blocks a tile sees, for the soup tier's walk of path
D's 48×48 and 64×64 rays at the default cap and with lists of the whole
mesh, with the sphere bound and with the exact box bound (``exact_aabb``).
``floor``: the merged per-camera kernel's time with its body and its staging
traffic knocked out, which splits it into launch and barrier floor, staging
and arithmetic, on each walk; the registers and blocks an SM of the list
walk's instances, and the SASS count of every instance's slot loop
(instructions a test, as ``list``), the render instances beside those of the
checkout at ``$VISFLY_PARENT`` where it is set (say a ``git archive`` of the
parent commit under ``build/``): the diagnostics' flags must add none.

``split`` is the evidence for the triangle kernel's split of a tile over a
cluster of k blocks, for every use of it on path D: B4 at 360 and 5,760
triangles, and at 23,040 the soup tier B5 (48×48 rays), the per-camera tier
B6 and its variants B7a (merged) and B7c (the worklist) on 64×64 rays. Per
use: the kernel's time at each k up to 8 beside the k the wrapper picks, the
stages executed per tile (mean, p90, max, summed over a tile's blocks; k = 1
is the B8a count), every k held to k = 1 to the bit (ids where the ray hits).
Besides: the registers and blocks an SM of each instantiation, what the
compiler made of the bodies (``cuobjdump -sass``: instructions, branches,
reciprocals), and the kernel's fused per-test products beside the unfused
plain version, each against a float64 brute force on 8 cameras with lists of
the whole mesh, the garage moved 0, 20 and 40 m from the origin.

``tile`` is the evidence for B4's tile kernel (``csrc/tri_tile.cu``): the
copies of ``TILE_COPIES`` (the package's, each of its design's first three
steps taken back: the whole tile a block, every slot of the walked stages,
the next stage's gather waited for before the tests; and other block
shapes), built side by side under ``build/profile/`` with each one's
registers and spills, and the package's with its tiles launched in index
order (the fourth step taken back); then in turns, forwards and backwards,
each one's device time on path D's three uses of B4 (360 triangles at 64×64
and 48×48, 5,760 at 64×64) and on ``chip_smoke.py``'s synthetic ragged
lists, its share of the bound (the tests on the tiles' real slots) and
whether it equals the cluster walk at k = 1, beside the cluster walk at
k = 1 and at the k it would pick.

``list`` is the evidence for the list walk on B7a and B7c (the merged and
worklist tiers, ``csrc/tri_tile.cu``): the copies of ``LIST_COPIES`` (the
package's; the block of 4 rays a thread, with the kSV body ``SV_SLOT`` and
without, the real slots, the slot loop's body and unrolling and the 16-byte
gather taken back or varied), built side by side with each one's
registers and spills, and each one's slot loop read from its SASS
(``cuobjdump -sass``: instructions a test on the common path, the accepted
path apart, written to ``list_sass/`` under ``$VISFLY_PROFILE_OUT``, by
default ``build/profile/``); then on path D's 64×64
rays at 23,040 triangles, for B7a and B7c at their defaults and on a ragged
set of each, in turns forwards and backwards, each copy's device time,
the package's with its tiles in index order, and the
cluster walk at k = 1 and its picked k in index order and at k = 2 longest
first, with each one's share of the bound and the issue floor of the
package's slot loop; last B6's own lists, with the count and longest-first
order the plan gives B7a's, on the list walk, the package's and the 4-ray
copies (routed so inside the command only), beside the cluster walk B6
takes, at 23,040 and 92,160
triangles (``tri_bench``'s level 4, 256 cameras).

``sweep`` is the evidence for the list walk's stage shares
(``tri_kernel.stage_parts``): B7a and B7c on path D's first 8, 16, 32, 64,
128 and 256 cameras and on path T3's grid (92,160 triangles, 8 cameras,
``cap = T``) at 1, 2, 4 and 8 shares a tile and at the wrapper's choice,
beside the cluster walk at its picked k, each equal to the cluster walk at
k = 1.

``march`` is the evidence for the march kernel's design (``csrc/trace_march.cu``)
on path B's camera rays (256 agents, 64×64): for each of its three modes, the
culled march B2 (with the frustum planes of the 64-wide cameras), the
over-relaxed un-culled march B3a and the packed warm-started march B3b, the
kernel's time against the plain version's result, its bound and share, the
SDF evaluations a ray and the rows an evaluation; the share of tiles whose
culled rows fit the compacted block; and from the plain version's per-ray
evaluation counts the issued-lane efficiency (the evaluations the rays need
over 32 × the warp's longest lane) of two ways to give a warp its rays:
32 × 1 strips of an image row and 8 × 4 patches (the kernel's), with the
kernel's time in both (B3a and B3b; B2's cull needs the image width that
the patches come from) and the registers and spills of each instantiation.

``mx`` is the evidence for the matrix-form kernel's design
(``tri_trace_mx_kernel`` of ``csrc/tri_trace.cu``, on the tensor cores): the
copies of ``MX_COPIES`` (block shapes of 128, 256 and 512 threads, the vote
on each ray's best, the least of its quad's, instead of each lane's own, and
two knock-outs: one product a row block, and the products with no gate: a
test that never passes), built side by side under
``build/profile/`` with each one's registers and spills from ``ptxas -v``;
then in turns, forwards and backwards, each copy's device time on path D's
64×64 rays at 23,040 triangles, its shares of the bound and of its design's
floor, the stages executed a tile, its result against the package's kernel,
and on rays through the midpoints of the mesh's flat shared edges the rays
that land past 1e-3 m of the plain version and of a float64 brute force.

``analytic`` is the evidence for the analytic kernel's launch bounds
(``csrc/trace_analytic.cu``, 256 threads of four rays a block): copies of
the source at 2, 3, 4 (the source's own) and 8 blocks an SM
(``kMinBlocks``), built side by side under ``build/profile/`` with each
instantiation's registers and spills from ``ptxas -v``; then in turns,
forwards and backwards, each copy's device time (``torch.profiler``) on the
main path's uses, each held equal to its plain version: B1 culled on path
B's camera rays, B1-kid culled on path A's and on path B's, and B1 culled on
1 M random rays (no shared origin: every term per ray), with the bound and
the share of it; beside them the package's kernel un-culled on path B's
rays.

``timing`` is the evidence for ``chip_smoke.py::device_ms``: B1-kid culled
at the 480×640 top view of ``cluttered_flight`` (path N's global view) and
B1 culled on path B's camera rays, each in three rounds of 20 launches.
Per round: every launch's duration from ``torch.profiler``'s kernel records,
with the host's time between the launches, and again with the 20 launches
queued behind a spin of the card, with the gaps between them; then
``device_ms`` beside the mean of the records.

``plane`` is the evidence for taking the signed-volume tiers' t again on the
winning triangle's plane (``tri_trace.py::_winner_plane_t``): on
``tri_bench``'s first 8 cameras at 23,040 and 92,160 triangles with lists
that hold the whole mesh, for each per-camera variant, the kernel's own t
and the function's against a float64 brute force, beside the float32 brute
force, with the worst ray's triangle (edges), t and the cosine of its
incidence.

``r4`` is the evidence for running path R with cuDNN's deterministic
algorithms: path R4 (the recurrent PPO_tuned on ``cluttered_flight``, one
update) in one process twice and on two gloo ranks, at 1 and 10 epochs,
with cuDNN's default and its deterministic algorithms: the loss and the
parameters (l2) of each against the first process's.

Every line ends with the card's name and power limit.
"""
import contextlib
import os
import re
import subprocess
import sys
import tempfile
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
    if hasattr(env.scene, "triangles"):
        from visfly_tpu_torch.render import default_tri_cap, tri_first_hit
        from visfly_tpu_torch.render.tri_kernel import count_name
        from visfly_tpu_torch.render.tri_trace import plan_tiles
        from visfly_tpu_torch.scene import point_is_collision, tri_closest_point

        tris = env.scene.triangles
        cap = default_tri_cap(tris.shape[1])
        for i, spec in enumerate(env.sensor_kwargs):
            o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, i)
            plan = plan_tiles(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w, cam_rays)
            res = "x".join(str(r) for r in spec["resolution"])
            parts[f"{res} cull prepass (plan_tiles)"] = (
                lambda o_c=o_c, d_c=d_c, img_w=img_w, cam_rays=cam_rays:
                plan_tiles(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w, cam_rays))
            use = count_name(plan.form, plan.lists.block)
            parts[f"{res} kernel ({use})"] = lambda plan=plan: tri_first_hit(
                tris, plan.lists, plan.origins_c, plan.dirs_c, cs.MAX_DEPTH, plan.form,
                plan.origin_tiles)
        parts["tri_closest_point"] = lambda: tri_closest_point(tris, env.scene_ids, state.dyn.pos)
        parts["point_is_collision on the grid (one try)"] = lambda: point_is_collision(
            env.scene, state.dyn.pos, env.scene_ids, 1.0)
    if isinstance(getattr(env.scene, "tri_uv", ()), torch.Tensor):
        from visfly_tpu_torch.render.sphere_trace import _texture_albedo
        from visfly_tpu_torch.render.tri_trace import tri_trace_diff

        o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, 1)
        t, _, _, gid = tri_trace_diff(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w, True, cam_rays)
        p3 = (o_c + d_c * t[None]).permute(1, 2, 0)
        parts["texture gathers (barycentrics, texcoords, atlas)"] = (
            lambda: _texture_albedo(env.scene, gid, p3))
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

    def window():
        nonlocal state
        for _ in range(steps):
            state, _ = env.step(state, act())

    report_busy(name, window, steps, "step", step_ms, card)


def report_busy(name, fn, units, unit, unit_ms, card):
    """One profiler window over ``fn()``, which runs ``units`` steps or
    updates: the device's busy time a unit from the kernel rows, the idle
    share against the unprofiled ``unit_ms``, and the six kernels that took
    most of the window."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernel rows only: an operator row repeats the time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    print(f"{name} | profiler: device busy {busy / units:.3f} ms per {unit} ({units} profiled), "
          f"idle share {1 - busy / units / unit_ms:.3f} of the {unit_ms:.3f} ms {unit} | {card}",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"{name} | profiler top: {e.key[:60]} x{e.count}: "
              f"{e.self_device_time_total / 1e3:.3f} ms | {card}", flush=True)


def profile_bptt(name, trainer, card, n_updates=3):
    """Where a BPTT update's time goes: forward rollout, backward pass, clip
    and Adam step, each synchronised and host-clocked; then the device's busy
    time over one update."""
    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    st = trainer.init(torch.Generator(device=trainer.env.device).manual_seed(0))
    st, _ = trainer.update(st)
    parts = {"forward rollout": 0.0, "backward pass": 0.0, "clip and Adam step": 0.0}
    for _ in range(n_updates):
        trainer.optimizer.zero_grad()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, (env_state, obs, hidden, _) = trainer._rollout_loss(st.env_state, st.obs, st.gen,
                                                                  st.hidden)
        parts["forward rollout"] += sync_ms(t0)
        t0 = time.perf_counter()
        loss.backward()
        parts["backward pass"] += sync_ms(t0)
        t0 = time.perf_counter()
        trainer.optimizer.step()
        parts["clip and Adam step"] += sync_ms(t0)
        st = st._replace(env_state=trainer.env.detach(env_state),
                         obs={k: v.detach() for k, v in obs.items()})
    update_ms = sum(parts.values()) / n_updates
    steps = trainer.H * trainer.env.num_envs
    print(f"{name} | update ({trainer.env.num_envs} agents, H={trainer.H}): {update_ms:.1f} ms, "
          f"{steps / update_ms * 1e3:.1f} agent steps/s | {card}", flush=True)
    for part, ms in parts.items():
        print(f"{name} | {part}: {ms / n_updates:.1f} ms an update, share "
              f"{ms / n_updates / update_ms:.3f} | {card}", flush=True)
    report_busy(name, lambda: trainer.update(st), 1, "update", update_ms, card)


def profile_ppo(name, trainer, card, extra=None):
    """Where a PPO update's time goes (paths G and K): rollout, GAE and
    epochs, each synchronised and host-clocked over one update after a
    warm-up; the parts of a rollout step (``extra(state)`` adds the env's
    own, {name: (callable, None | "" | kernel name)}: "" reads the device's
    busy time of one call, a kernel name that kernel's own time); then the
    device's busy time over a window of 8 rollout steps against the
    unprofiled step."""
    from visfly_tpu_torch.algos.ppo import push_episode_stats

    env = trainer.env
    st = trainer.init(torch.Generator(device=env.device).manual_seed(0))
    st, _ = trainer.update(st)
    parts = cs.timed_parts(trainer, ("_collect", "_advantages", "_train_flat"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = trainer.update(st)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    n_steps = trainer.n_steps
    print(f"{name} | update ({env.num_envs} agents x {n_steps} steps, {trainer.n_epochs} "
          f"epochs): {update_ms:.1f} ms | {card}", flush=True)
    for part, sec in parts.items():
        print(f"{name} | {part}: {sec * 1e3:.1f} ms an update, share "
              f"{sec * 1e3 / update_ms:.3f} | {card}", flush=True)
    step_ms = parts["_collect"] * 1e3 / n_steps
    state, obs = st.env_state, st.obs
    a = torch.zeros((env.num_envs, 4), device=env.device)
    _, out = env.step(state, a)

    def policy():
        with torch.no_grad():
            return trainer.policy(obs)

    def plain_step():
        env.terminal_obs_in_info = False
        try:
            return env.step(state, a)
        finally:
            env.terminal_obs_in_info = True

    steps = {
        "env.step (terminal observation, auto-reset)": lambda: env.step(state, a),
        "env.step without the terminal observation": plain_step,
        "render_sensors (one render)": lambda: env.sensor_observations(state),
        "_spawn (all agents)": lambda: env._spawn(state.gen),
        "policy forward (mean, log-std, value)": policy,
        "push_episode_stats": lambda: push_episode_stats(
            st.ep_stats, out.done, out.info["episode_return"], out.info["episode_length"],
            out.info["is_success"]),
    }
    device = {}
    for part, (fn, kernel) in (extra(state) if extra else {}).items():
        steps[part] = fn
        if kernel is not None:
            device[part] = kernel
    for part, fn in steps.items():
        ms = host_ms(fn, reps=20)
        print(f"{name} | {part}: {ms:.3f} ms per call | {card}", flush=True)
        if device.get(part) == "":  # many kernels: the busy time of a window
            report_busy(f"{name} {part}", fn, 1, "call", ms, card)
        elif part in device:  # one kernel: its own time over 20 launches
            dev_ms = cs.device_ms(fn)
            print(f"{name} | {part}: on the device {dev_ms:.4f} ms (20 calls queued behind a "
                  f"spin) | {card}", flush=True)
    print(f"{name} | rollout step (the update's rollout / {n_steps}): {step_ms:.3f} ms | {card}",
          flush=True)
    trainer.n_steps = 8
    report_busy(name, lambda: trainer._collect(st), 8, "rollout step", step_ms, card)
    trainer.n_steps = n_steps


def crossing_parts(env):
    """The parts of a path K step beyond path G's: the drones' mesh hits of
    one render (posed templates against every camera ray, plain PyTorch),
    B1 alone on the static scene, and the collision query with and without
    the inter-drone override."""
    from visfly_tpu_torch.envs.base import DroneGymEnv
    from visfly_tpu_torch.render import camera_rays_components, prepare_kernel_scene, trace_diff
    from visfly_tpu_torch.render.sphere_trace import _object_mesh_hits

    def parts(state):
        spec = env.sensor_kwargs[0]
        H, W = spec["resolution"]
        n, S = env.num_agent, env.num_scene
        R = n // S * H * W
        o_c, d_c, _ = camera_rays_components(spec, state.dyn.pos, state.dyn.q, env.cameras[0])
        o_full = o_c[:, :, None].expand(3, n, H * W).reshape(3, S, R)
        d_full = d_c.reshape(3, S, R).contiguous()
        objects = env.render_objects(state)
        kscene = prepare_kernel_scene(env.scene)
        o_pm, d_pm = o_full.permute(1, 2, 0), d_full.permute(1, 2, 0)
        M, K = objects[3].shape[1], objects[3].shape[2]
        # the function's least work: each ray against each drone's bounding
        # sphere (29 float32 operations, a root as 8) and each of its
        # triangles (Möller–Trumbore as chip_smoke.TRI_OPS["mt"] counts it,
        # all three parts), rays read once (origins and directions), t, hit,
        # normal and colour written once, the posed templates read once
        ops = S * R * M * (29 + K * sum(cs.TRI_OPS["mt"]))
        n_bytes = S * R * (6 * 4 + 4 + 1 + 6 * 4) + S * M * (K * 9 + 4 + 4 + 1 + 3) * 4
        bound = max(ops / cs.PEAK_FP32_PER_S, n_bytes / cs.PEAK_BYTES_PER_S) * 1e3
        print(f"path K | _object_mesh_hits bound: {bound:.4f} ms by "
              f"{'operations' if ops / cs.PEAK_FP32_PER_S > n_bytes / cs.PEAK_BYTES_PER_S else 'bytes'}"
              f" ({ops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.1f} MB) | {env.device}", flush=True)
        return {
            f"_object_mesh_hits ({M} drones x {K} triangles against {S} x {R} rays)":
                (lambda: _object_mesh_hits(objects, o_pm, d_pm, cs.MAX_DEPTH), ""),
            "B1 alone (trace_diff on the static scene)": (lambda: trace_diff(
                kscene, o_full, d_full, None, cs.TRACE_STEPS, cs.MAX_DEPTH, 1.0, R % 1024 == 0,
                True, 0, False, img_w=W), cs.KERNEL_NAMES["trace_analytic"]),
            "_update_collision with the inter-drone override": (
                lambda: env._update_collision(state.dyn, state.once_collided), None),
            "_update_collision without it (the base env's)": (
                lambda: DroneGymEnv._update_collision(env, state.dyn, state.once_collided), None),
        }

    return parts


def probe(env, card):
    """Stages executed per tile of the soup tier's walk (``stage_stats``, the
    list walk's count) beside the cluster walk's at k = 1, with the device
    time of each counting launch on the same lists."""
    from visfly_tpu_torch.render import default_tri_cap, stage_stats, tri_first_hit
    from visfly_tpu_torch.render.tri_trace import _exact_aabb_lists, block_lists, walk_order

    state, _ = env.reset(torch.Generator(device=env.device).manual_seed(0))
    tris = env.scene.triangles
    T = tris.shape[1]
    for sensor, spec in enumerate(env.sensor_kwargs):
        o_c, d_c, img_w, _ = cs.mesh_camera_rays(env, state, sensor)
        res = "x".join(str(r) for r in spec["resolution"])
        for cap in (default_tri_cap(T), T):
            for exact in (False, True):
                st = stage_stats(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w, exact_aabb=exact)
                ms = cs.cuda_ms(lambda: stage_stats(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w,
                                                    exact_aabb=exact), reps=5, warmup=1)
                lists = block_lists(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w, False)
                lists = walk_order(_exact_aabb_lists(tris, o_c, lists) if exact else lists)
                args = (tris, lists, o_c, d_c, cs.MAX_DEPTH, "mt", 1)
                one = tri_first_hit(*args, count_stages=True, split=1)
                cs.check(cs.same_result(one, (st["t"], st["hit"], one[2])),
                         "probe: the list walk differs from the cluster walk at k = 1")
                new = cs.device_ms(lambda: tri_first_hit(*args, count_stages=True))
                old = cs.device_ms(lambda: tri_first_hit(*args, count_stages=True, split=1))
                print(f"probe | T={T} {res}, {o_c.shape[2] // 1024} tiles, cap {cap}, "
                      f"{'exact box' if exact else 'sphere'} bound: stages executed a tile mean "
                      f"{st['mean']:.2f} p50 {st['p50']:.0f} p90 {st['p90']:.0f} max {st['max']} "
                      f"of {st['n_stage']} (summed over blocks of {st['block_rays']} rays; the "
                      f"cluster walk's tile-wide vote {float(one[3].float().mean()):.2f}); blocks "
                      f"seen mean {st['visible_mean']:.2f}; hit {st['hit_frac']:.4f}; prepass and "
                      f"kernel {ms:.3f} ms; on the device the list walk's count {new:.4f} ms, the "
                      f"cluster walk's at k = 1 {old:.4f} ms | {card}", flush=True)


KNOCKS = {(True, False): 0, (False, False): 1, (True, True): 2, (False, True): 3}


def floor(env, card):
    """The merged per-camera kernel with its body and its staging knocked
    out, on path D's 64×64 rays, on the list walk (``knockout_trace``) and
    on the cluster walk at k = 1; the list walk's instances' registers and
    blocks an SM, and every instance's slot loop in SASS, beside those of
    the checkout at ``$VISFLY_PARENT`` where it is set."""
    from visfly_tpu_torch import build as vb
    from visfly_tpu_torch.render import default_tri_cap, knockout_trace, tri_first_hit
    from visfly_tpu_torch.render.tri_kernel import tile_occupancy
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    libs = {"the package's": vb.build("tri_tile")}
    parent = os.environ.get("VISFLY_PARENT")
    if parent:
        libs["the parent's"] = source_copy("tri_tile", "parent", {},
                                           os.path.join(parent, "visfly_tpu_torch", "csrc"))
    for label, lib in libs.items():
        ptxas_report(lib, f"floor | {label}", card, only="tri_tile_kernel")
        sass_report(lib, f"floor | {label}", card, copy_rays({}))
    for (form, mode, count), what in (
            (("mt", "scalar", True), "kMT count (B8a on the soup)"),
            (("sv_cam", "scalar", True), "kSV count (B8a per camera)"),
            (("sv_cam", "merged", False), "kSV merged (B7a)")):
        occ = tile_occupancy(form, mode=mode, count_stages=count)
        print(f"floor | {what}: {occ['regs']} registers, {occ['blocks_per_sm']} blocks an SM | "
              f"{card}", flush=True)
    for knock in (1, 2, 3):
        occ = tile_occupancy("sv_cam", mode="merged", knock=knock)
        print(f"floor | kSV merged, knock-out bits {knock} (B8b): {occ['regs']} registers, "
              f"{occ['blocks_per_sm']} blocks an SM | {card}", flush=True)

    state, _ = env.reset(torch.Generator(device=env.device).manual_seed(0))
    tris = env.scene.triangles
    T = tris.shape[1]
    o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, 0)
    plan = plan_tiles(tris, o_c, d_c, cs.MAX_DEPTH, default_tri_cap(T), img_w, cam_rays,
                      variant="merged")
    args = (tris, plan.lists, plan.origins_c, plan.dirs_c, cs.MAX_DEPTH, plan.form,
            plan.origin_tiles)
    walks = {"the list walk": lambda body, pin: knockout_trace(
                 tris, o_c, d_c, body=body, pin_stage=pin, plan=plan),
             "the cluster walk at k = 1": lambda body, pin: tri_first_hit(
                 *args, mode="merged", body=body, pin_stage=pin, split=1)}
    for round_ in range(3):  # three rounds: a reading far from the others shows as such
        for walk, fn in (walks.items() if round_ % 2 == 0 else list(walks.items())[::-1]):
            ms = {}
            for body, pin in KNOCKS:
                ms[(body, pin)] = cs.device_ms(lambda: fn(body, pin))
                print(f"floor | round {round_}, {walk}, T={T} 64x64 at {o_c.shape[2]} rays, body "
                      f"{'on' if body else 'off'}, stage {'pinned' if pin else 'walked'}: "
                      f"{ms[(body, pin)]:.4f} ms on the device | {card}", flush=True)
            full, nobody, neither = ms[(True, False)], ms[(False, False)], ms[(False, True)]
            print(f"floor | round {round_}, {walk}: the kernel's {full:.4f} ms: launch, votes and "
                  f"barriers {neither:.4f} ms, staging the walked blocks {nobody - neither:.4f} "
                  f"ms, arithmetic {full - nobody:.4f} ms ({(full - nobody) / full:.3f}) | "
                  f"{card}", flush=True)


# the instantiations of tri_trace_kernel: (form, mode, knock-out bits)
INSTANTIATIONS = {"kMT (B5, B8a; B4 mt at a split)": ("mt", "scalar", 0),
                  "kSV (B6, B7c; B4 sv at a split)": ("sv_cam", "scalar", 0),
                  "kSV merged (B7a)": ("sv_cam", "merged", 0),
                  "kSV merged, body off (B8b)": ("sv_cam", "merged", 1),
                  "kSV merged, stage pinned (B8b)": ("sv_cam", "merged", 2),
                  "kSV merged, both (B8b)": ("sv_cam", "merged", 3)}


def build_report(card):
    """The ptxas register counts of the triangle library, and per
    instantiation of tri_trace_kernel: SASS instructions, branches,
    predicated instructions, reciprocals, and the float32 multiplies, adds
    and fused multiply-adds."""
    from visfly_tpu_torch.build import library_path, nvcc_path

    with open(os.path.join(os.path.dirname(library_path("tri_trace")), "build.log")) as f:
        regs = [ln.split("Used")[1].split(",")[0].strip() for ln in f if "Used" in ln]
    print(f"split | ptxas: {', '.join(regs)} | {card}", flush=True)
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library_path("tri_trace")],
                          capture_output=True, text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        if "tri_trace_kernel" not in name:
            continue
        ins = [ln.split("*/", 1)[1].strip() for ln in block.splitlines()
               if ln.strip().startswith("/*") and "*/" in ln and ";" in ln]
        ops = [x.split()[1] if x.startswith("@") else x.split()[0] for x in ins]
        n = {k: sum(o.startswith(k) for o in ops) for k in
             ("BRA", "BSSY", "MUFU.RCP", "FFMA", "FMUL", "FADD", "FSETP")}
        pred = sum(x.startswith("@") for x in ins)
        args = name.split("tri_trace_kernel")[1][:24]
        print(f"split | sass tri_trace_kernel{args}: {len(ins)} instructions, {pred} predicated, "
              + ", ".join(f"{k} {v}" for k, v in n.items()) + f" | {card}", flush=True)


def split_sweep(use, args, plan, stats, n_rays, card):
    """One kernel use at every k the wrapper could take, each held to k = 1
    (``chip_smoke.same_result``): the kernel's time, its share of the bound and
    the stages executed a tile, summed over its blocks."""
    from visfly_tpu_torch.render import tri_first_hit
    from visfly_tpu_torch.render import tri_kernel as tk

    lists, mode = plan.lists, plan.mode
    b_ms, b_by, _ = cs.tri_bound_ms(plan.form, stats, n_rays, lists, plan.form == "mt",
                                    8 if mode == "merged" else 9)
    chosen = tk.default_split(lists, plan.form, mode, plan.dirs_c.device)
    tiles, n_stage = lists.n_stage.numel(), lists.lb.shape[-1]
    if lists.start is not None:
        n_stage = max(1, n_stage // tiles)
    print(f"split | {use} at {n_rays} rays: {tiles} tiles of up to {lists.lb.shape[-1]} stages"
          f"{' (CSR)' if lists.start is not None else ''}, bound {b_ms:.4f} ms by {b_by}, the "
          f"wrapper picks k = {chosen} | {card}", flush=True)
    base = tri_first_hit(*args, mode=mode, split=1, count_stages=True)
    for k in range(1, min(tk.MAX_SPLIT, n_stage) + 1):
        out = tri_first_hit(*args, mode=mode, split=k, count_stages=True)
        cs.check(cs.same_result(out, base), f"{use}: k = {k} differs from k = 1")
        c = out[3].float()
        ms = cs.cuda_ms(lambda: tri_first_hit(*args, mode=mode, split=k))
        print(f"split | {use} k={k}{' (picked)' if k == chosen else ''}: kernel {ms:.4f} ms, "
              f"share of bound {b_ms / ms:.3f}; stages executed a tile, summed over its blocks: "
              f"mean {float(c.mean()):.2f} p90 {float(c.quantile(0.9)):.0f} max {int(c.max())} "
              f"(k = 1: mean {float(base[3].float().mean()):.2f}); equal to k = 1 | {card}",
              flush=True)


def split(envs, card):
    """The triangle kernel's split of a tile over a cluster of k blocks, for
    every use of it on path D (``envs``: subdivision level -> env); and the
    fused per-test products against the unfused plain version and a float64
    brute force."""
    from visfly_tpu_torch.render import (default_tri_cap, tri_first_hit, tri_first_hit_reference,
                                         tri_trace_brute)
    from visfly_tpu_torch.render import tri_kernel as tk
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    for name, (form, mode, knock) in INSTANTIATIONS.items():
        occ = tk.occupancy(form, mode, knock)
        print(f"split | {name}: {occ['regs']} registers, {occ['threads']} threads a block, "
              f"{occ['blocks_per_sm']} blocks an SM of {occ['sms']}; resident blocks by k "
              f"{occ['slots']} | {card}", flush=True)
    build_report(card)

    for level, env in envs.items():
        dev = env.device
        state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
        tris = env.scene.triangles
        T = tris.shape[1]
        cap = default_tri_cap(T)
        sensors = [(i, None) for i in range(len(env.sensor_kwargs))]
        if level == 3:  # B7a and B7c on the 64×64 rays
            sensors += [(0, "merged"), (0, "wl")]
        for sensor, variant in sensors:
            o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, sensor)
            plan = plan_tiles(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w, cam_rays,
                              variant=variant or "scalar")
            args = (tris, plan.lists, plan.origins_c, plan.dirs_c, cs.MAX_DEPTH, plan.form,
                    plan.origin_tiles)
            use = tk.count_name(plan.form, plan.lists.block, plan.mode,
                                plan.lists.start is not None)
            stats = {}
            tri_first_hit_reference(*args, stats=stats, mode=plan.mode)
            split_sweep(f"{use} T={T}", args, plan, stats, o_c.shape[2], card)

    # the fused kernel and its unfused plain version against a float64 brute
    # force, on 8 cameras with lists of the whole mesh
    env = envs[3]
    state, _ = env.reset(torch.Generator(device=env.device).manual_seed(0))
    tris = env.scene.triangles
    T = tris.shape[1]
    for sensor in (1, 0):  # B5 on the 48×48 rays, B6 on the 64×64 ones
        o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, sensor)
        r8 = 8 * (cam_rays or 48 * 48)
        o8, d8 = o_c[:, :, :r8].contiguous(), d_c[:, :, :r8].contiguous()
        for off in (0.0, 20.0, 40.0):
            shift = torch.tensor([off, off, 0.0], device=env.device)
            tr = (tris.reshape(1, T, 3, 3) + shift).reshape(1, T, 9).contiguous()
            oc = (o8 + shift[:, None, None]).contiguous()
            t64, hit64, _, _ = tri_trace_brute(tr.double(), oc.double().permute(1, 2, 0),
                                               d8.double().permute(1, 2, 0), cs.MAX_DEPTH,
                                               max_elems=1 << 22)
            p8 = plan_tiles(tr, oc, d8, cs.MAX_DEPTH, T, img_w, cam_rays)
            a8 = (tr, p8.lists, p8.origins_c, p8.dirs_c, cs.MAX_DEPTH, p8.form, p8.origin_tiles)
            unpack = p8.unpack or (lambda y: y)
            line = []
            for who, fn in (("kernel (fused)", tri_first_hit),
                            ("plain version (unfused)", tri_first_hit_reference)):
                t, hit = (unpack(x) for x in fn(*a8)[:2])
                e = (t.double() - t64).abs()[hit & hit64]
                line.append(f"{who} max|dt|={float(e.max()):.3e} m, mean {float(e.mean()):.3e} "
                            f"m, hit flags differ on {float((hit != hit64).double().mean()):.3e}")
            print(f"split | {tk.count_name(p8.form, p8.lists.block)} T={T} offset {off:.0f} m vs "
                  f"float64 brute force on 8 cameras, lists of the whole mesh: {'; '.join(line)} | "
                  f"{card}", flush=True)


def page_algebra_t(tris, cam_o, dirs, max_depth, slab=2048):
    """First hit by signed volumes with the expanded per-camera coefficients
    ``g0 = b×c + o×(b − c)``, ``g1``, ``g2`` alike, ``kt = (a − o)·g0``, every
    triangle against every ray: tris (T, 9), cam_o (cams, 3), dirs (cams, rays,
    3) → (t, hit) (cams, rays)."""
    a, b, c = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    cross = torch.linalg.cross
    best = torch.full(dirs.shape[:2], 1e9, device=dirs.device)
    for cam, o in enumerate(cam_o):
        ob = o.expand_as(a)
        g = [cross(p, q) + cross(ob, p - q) for p, q in ((b, c), (c, a), (a, b))]
        kt = ((a - o) * g[0]).sum(-1)
        d = dirs[cam][:, None, :]  # (rays, 1, 3)
        for k0 in range(0, tris.shape[0], slab):
            w0, w1, w2 = ((d * x[None, k0:k0 + slab]).sum(-1) for x in g)
            tk = kt[None, k0:k0 + slab] * (1.0 / (w0 + w1 + w2))
            ok = (w0 * w1 >= 0) & (w0 * w2 >= 0) & (w1 * w2 >= 0) & (tk > 1e-4)
            best[cam] = torch.minimum(best[cam], torch.where(ok, tk, 1e9).amin(1))
    t = torch.clamp(best, 0.0, max_depth)
    return t, t < max_depth


def sv_rounding(level, env, card):
    """max |Δt| of each body against the float64 brute force, and the share
    of rays past the smoke's limit, per offset of the mesh from the origin."""
    from visfly_tpu_torch.render import tri_trace_brute, tri_trace_tiled

    state, _ = env.reset(torch.Generator(device=env.device).manual_seed(0))
    o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, 0)
    cams = min(8, o_c.shape[2] // cam_rays)
    o_c, d_c = o_c[:, :, :cams * cam_rays], d_c[:, :, :cams * cam_rays].contiguous()
    tris = env.scene.triangles
    T = tris.shape[1]
    never, always = 1 << 30, 0  # thresholds of the block-list tiers
    bodies = {"sv_cam": (img_w, cam_rays, always, "scalar"),
              "mx": (img_w, cam_rays, always, "mx"),
              "sv_tile": (img_w, cam_rays, never, "scalar"), "mt": (None, None, never, "scalar")}
    for off in (0.0, 20.0, 40.0):
        shift = torch.tensor([off, off, 0.0], device=env.device)
        tr = (tris.reshape(1, T, 3, 3) + shift).reshape(1, T, 9).contiguous()
        oc = (o_c + shift[:, None, None]).contiguous()
        t64, hit64, _, _ = tri_trace_brute(tr.double(), oc.double().permute(1, 2, 0),
                                           d_c.double().permute(1, 2, 0), cs.MAX_DEPTH,
                                           max_elems=1 << 22)
        out = {body: tri_trace_tiled(tr, oc, d_c, cs.MAX_DEPTH, T, w, cam,
                                     soup_min_t=soup_min_t, variant=variant)[:2]
               for body, (w, cam, soup_min_t, variant) in bodies.items()}
        t_pg, hit_pg = page_algebra_t(tr[0], oc[:, 0, ::cam_rays].T,
                                      d_c[:, 0].T.reshape(cams, cam_rays, 3), cs.MAX_DEPTH)
        out["pages"] = (t_pg.reshape(1, -1), hit_pg.reshape(1, -1))
        for body, (t, hit) in out.items():
            both = hit & hit64
            err = (t.double() - t64).abs()[both]
            print(f"sv | T={T} offset {off:.0f} m, coordinates up to "
                  f"{float(tr.abs().max()):.1f} m, {body}: max|dt|={float(err.max()):.3e} m, "
                  f"mean {float(err.mean()):.3e} m, share of hits above {cs.T_TOL} m "
                  f"{float((err > cs.T_TOL).double().mean()):.3e}, hit flags differ on "
                  f"{float((hit != hit64).double().mean()):.3e} | {card}", flush=True)


def lane_efficiency(ev, H, W):
    """Issued-lane efficiency of two ray-to-lane mappings over camera images
    of H × W rays (``ev`` (S, R): evaluations each ray needs, images one
    after another): the evaluations needed over 32 × the sum of each warp's
    longest lane, for 32 × 1 strips of an image row and 8 × 4 patches."""
    e = ev.reshape(-1).double()
    strips = e.reshape(-1, 32).amax(1).sum()
    patches = (e.reshape(-1, H // 4, 4, W // 8, 8).permute(0, 1, 3, 2, 4)
               .reshape(-1, 32).amax(1).sum())
    return {k: float(e.sum()) / (32 * float(v)) for k, v in
            (("strips 32x1", strips), ("patches 8x4", patches))}


def march(env, card):
    """The march kernel's three modes on path B's camera rays: time, error
    against the plain version, bound, evaluations, the cull's fit share and
    the lane efficiency of two ray mappings."""
    from visfly_tpu_torch.render import cone_warm_start, prepare_kernel_scene, trace_march
    from visfly_tpu_torch.render import trace_kernel as tk
    from visfly_tpu_torch.build import build

    ptxas_report(build("trace_march"), "march", card)  # <PACKED, RELAXED, CULL>, mangled
    dev = torch.device("cuda", 0)
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
    ks = prepare_kernel_scene(env.scene)
    o, d = cs.camera_rays_of(env, state)
    H, W = cs.RES
    spec = env.sensor_kwargs[3]
    ti = cone_warm_start(env.scene, spec, spec["tile"], o[:, 0, ::H * W].T.contiguous(),
                         state.dyn.q, 1, None, cs.TRACE_STEPS, cs.MAX_DEPTH)
    n = o.shape[2]
    plan = tk.cull_rows(ks, o, d, cs.MAX_DEPTH, W)
    act_b, act_c = ks.boxes[..., 11] > 0.5, ks.capsules[..., 7] > 0.5
    rows_b = (plan.box_rows & act_b[:, None]).sum(-1).double()
    rows_c = (plan.cap_rows & act_c[:, None]).sum(-1).double()
    print(f"march | cull on {plan.fits.numel()} tiles: rows fit on "
          f"{float(plan.fits.double().mean()):.4f}; culled-in boxes "
          f"{float(plan.nb.double().mean()):.2f}, capsules {float(plan.nc.double().mean()):.2f}; "
          f"rows evaluated boxes {float(rows_b.mean()):.2f} of {int(act_b.sum())}, capsules "
          f"{float(rows_c.mean()):.2f} of {int(act_c.sum())} | {card}", flush=True)
    op, dp = cs.packed(o), cs.packed(d)
    half = max(8, cs.TRACE_STEPS // 2)
    modes = cs.kernel_modes(lambda _: ti, W)  # their plain versions
    # each mode as the main path calls it, and (patches=False) with its
    # warps on 32 x 1 strips: the culled march without the image width would
    # lose its frustum planes, so it has no such form
    calls = {
        ("trace_march", True): lambda: trace_march(ks, o, d, None, cs.TRACE_STEPS, cs.MAX_DEPTH,
                                                   img_w=W),
        ("trace_march_nocull", True): lambda: trace_march(
            ks, o, d, None, cs.TRACE_STEPS, cs.MAX_DEPTH, omega=1.5, cull=False, img_w=W),
        ("trace_march_nocull", False): lambda: trace_march(
            ks, o, d, None, cs.TRACE_STEPS, cs.MAX_DEPTH, omega=1.5, cull=False),
        ("trace_march_packed", True): lambda: trace_march(ks, op, dp, ti, half, cs.MAX_DEPTH,
                                                          packed=True, img_w=W),
        ("trace_march_packed", False): lambda: trace_march(ks, op, dp, ti, half, cs.MAX_DEPTH,
                                                           packed=True)}
    ref = {}
    for mode in ("trace_march", "trace_march_nocull", "trace_march_packed"):
        stats = {}
        t_p, hit_p = modes[mode][1](ks, o, d, stats=stats)
        b_ms, b_by = cs.bound_ms(mode, ks, n, stats, plan if mode == "trace_march" else None)
        ref[mode] = (t_p, hit_p, b_ms)
        eff = lane_efficiency(stats["ray_evals"], H, W)
        print(f"march | {mode}: {stats['sdf_evals'] / n:.2f} SDF evaluations a ray, bound "
              f"{b_ms:.4f} ms by {b_by}; lane efficiency "
              + ", ".join(f"{k} {v:.4f}" for k, v in eff.items()) + f" | {card}", flush=True)
    # in turns, forwards then backwards
    for order in (list(calls), list(calls)[::-1]):
        for mode, patches in order:
            call = calls[(mode, patches)]
            t_p, hit_p, b_ms = ref[mode]
            t_k, hit_k = call()
            torch.cuda.synchronize()
            both = hit_k & hit_p
            err = float((t_k - t_p).abs()[both].max())
            flip = float((hit_k != hit_p).double().mean())
            ms = cs.cuda_ms(call)
            print(f"march | {mode}, {'8x4 patches' if patches else '32x1 strips'}: kernel "
                  f"{ms:.4f} ms, {b_ms / ms:.4f} of the bound; vs plain max|dt| {err:.3e} m, "
                  f"hit flags differ on {flip:.3e} | {card}", flush=True)


# the copies of csrc/tri_trace.cu that chip_profile.py mx builds: label ->
# ({line of the source: its replacement}, whether the copy must give the
# package's result to the bit)
MX_COPIES = {
    "256 threads: 2 warpgroups x 512 rays, 2 blocks an SM (the package's)": ({}, True),
    "256 threads, 3 blocks an SM": ({"kMxMinBlocks = 2;": "kMxMinBlocks = 3;"}, True),
    "512 threads: 4 warpgroups x 256 rays, 1 block an SM": (
        {"kMxThreads = 256;": "kMxThreads = 512;", "kMxMinBlocks = 2;": "kMxMinBlocks = 1;"},
        True),
    "128 threads: 1 warpgroup x 1024 rays, 3 blocks an SM": (
        {"kMxThreads = 256;": "kMxThreads = 128;", "kMxMinBlocks = 2;": "kMxMinBlocks = 3;"},
        True),
    "256 threads, the quad's vote (each ray's best, the least of its quad's)": (
        {"    if (!__syncthreads_or(tile_lb[ci] < fminf(far, max_depth))) continue;\n":
         "    unsigned open = 0;\n"
         "#pragma unroll\n"
         "    for (int m = 0; m < kMxRows; ++m) {\n"
         "#pragma unroll\n"
         "      for (int h = 0; h < 2; ++h) {\n"
         "        const unsigned v = __ballot_sync(0xffffffffu, tile_lb[ci] < fminf(tb[m][h], "
         "max_depth));\n"
         "        open |= v & (v >> 1) & (v >> 2) & (v >> 3) & 0x11111111u;\n"
         "      }\n"
         "    }\n"
         "    if (!__syncthreads_or(open != 0)) continue;\n"}, True),
    # knock-outs, for where the time goes (results differ)
    "knock-out: one product a row block (d_hi.g_lo dropped)": (
        {"  wgmma_n96<false>(d, a, b_lo);\n  wgmma_n96<true>(d, a, b_hi);\n":
         "  wgmma_n96<false>(d, a, b_hi);\n"}, False),
    "knock-out: products, no gate": (
        {"least[4 * u + e] = fminf(fminf(w0 * w1, w0 * w2), w1 * w2);":
         "least[4 * u + e] = w0 + w1 - w2 - 1e30f;"}, False),
}


def source_copy(name, label, edits, csrc=None):
    """The library of ``csrc/<name>.cu`` with ``edits`` (text: replacement)
    applied, built under ``build/profile/`` with the package's flags; the
    package's own library where there is no edit and no other ``csrc``
    directory (another checkout's sources) is named."""
    from visfly_tpu_torch import build as vb

    if not edits and csrc is None:
        return vb.build(name)
    csrc = csrc or vb.CSRC
    with open(os.path.join(csrc, f"{name}.cu")) as f:
        src = f.read()
    for a, b in edits.items():
        cs.check(a in src, f"{name}.cu has no {a!r}")
        src = src.replace(a, b)
    out = os.path.join(os.path.dirname(vb.BUILD_ROOT), "profile",
                       f"{name}-{re.sub(r'[^a-z0-9]+', '-', label.lower())[:48]}")
    os.makedirs(out, exist_ok=True)
    cu, lib = os.path.join(out, f"{name}.cu"), os.path.join(out, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([vb.nvcc_path(), *vb.NVCC_FLAGS, "-I", csrc, "-o", lib, cu],
                          capture_output=True, text=True)
    cs.check(proc.returncode == 0, f"nvcc failed for {cu}:\n{proc.stdout}{proc.stderr}")
    with open(os.path.join(out, "build.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    return lib


@contextlib.contextmanager
def mx_library(lib):
    """``mode="mx"`` launches the matrix-form kernel of the library ``lib``
    inside the block: the wrapper's own checks and arguments, another build."""
    import ctypes

    from visfly_tpu_torch.render import tri_kernel as tk

    own = tk._launchers
    fn = ctypes.CDLL(lib).tri_trace_mx_launch
    fn.argtypes, fn.restype = own()[1].argtypes, own()[1].restype
    tk._launchers = lambda: (own()[0], fn, own()[2])
    try:
        yield
    finally:
        tk._launchers = own


def mx(env, card):
    """The matrix-form kernel's block shape, vote and canonical signs
    (MX_COPIES), on path D's 64×64 rays at 23,040 triangles: per copy its
    registers and spills, then in turns, forwards and backwards, its device
    time (``torch.profiler``), the stages executed a tile, its share of the
    bound and of its design's floor, whether it gives the package's result to
    the bit, and on rays through every shared edge's midpoint the rays whose
    t lies past 1e-3 m of the plain version's and of a float64 brute force's."""
    import concurrent.futures

    from visfly_tpu_torch.render import (default_tri_cap, tri_first_hit, tri_first_hit_reference,
                                         tri_trace_brute)
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    with concurrent.futures.ThreadPoolExecutor(len(MX_COPIES)) as pool:
        libs = dict(zip(MX_COPIES, pool.map(lambda kv: source_copy("tri_trace", kv[0], kv[1][0]),
                                            MX_COPIES.items())))
    for label, lib in libs.items():
        ptxas_report(lib, f"mx | {label}", card, only="tri_trace_mx_kernel")
    state, _ = env.reset(torch.Generator(device=env.device).manual_seed(0))
    tris = env.scene.triangles
    o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, 0)
    plan = plan_tiles(tris, o_c, d_c, cs.MAX_DEPTH, default_tri_cap(tris.shape[1]), img_w,
                      cam_rays, variant="mx")
    args = (tris, plan.lists, plan.origins_c, plan.dirs_c, cs.MAX_DEPTH, plan.form,
            plan.origin_tiles)
    stats = {}
    tri_first_hit_reference(*args, stats=stats, mode="mx")
    n_rays = o_c.shape[2]
    b_ms, b_by, _ = cs.tri_bound_ms("mx", stats, n_rays, plan.lists)
    old_ms = cs.tri_bound_ms(plan.form, stats, n_rays, plan.lists)[0]
    floor_ms = cs.mx_floor_ms(stats)[0]
    ref = tri_first_hit(*args, mode="mx", count_stages=True)
    print(f"mx | path D 64x64 at {n_rays} rays, 23040 triangles: bound {b_ms:.4f} ms by {b_by} "
          f"(old yardstick, the float32 body on the CUDA cores: {old_ms:.4f}), floor of the "
          f"design {floor_ms:.4f} ms; {stats['tests'] / n_rays:.1f} slots a ray staged | {card}",
          flush=True)
    # shared edges: rays through every shared edge's midpoint from 4 cameras,
    # the plain version against float64 once, each copy against the plain version
    T = tris.shape[1]
    per_cam = -(-(3 * T // 2) // 1024) * 1024
    o_w, d_w, n_edges, _ = cs.shared_edge_rays(tris, o_c[:, 0, ::cam_rays][:, :4], per_cam)
    lists_w = cs.whole_mesh_lists(T, o_w.shape[2] // 1024, plan.lists.block, o_w.device)
    w_args = (tris, lists_w, o_w, d_w, cs.MAX_DEPTH, "sv_cam", per_cam // 1024)
    plain_w = tri_first_hit_reference(*w_args, mode="mx")
    t64, hit64, _, _ = tri_trace_brute(tris.double(), o_w.double().permute(1, 2, 0),
                                       d_w.double().permute(1, 2, 0), cs.MAX_DEPTH,
                                       max_elems=1 << 24)

    def deep(out, ref_t, ref_hit):
        both = out[1] & ref_hit
        return int(((out[0].double() - ref_t).abs() > cs.T_TOL)[both].sum())

    print(f"mx | watertight: {n_edges} flat shared edges, {o_w.shape[2]} rays; the plain version "
          f"(torch.matmul, float32) against float64: {deep(plain_w, t64, hit64)} rays past "
          f"{cs.T_TOL} m | {card}", flush=True)
    for order in (list(libs), list(libs)[::-1]):
        for label in order:
            with mx_library(libs[label]):
                out = tri_first_hit(*args, mode="mx", count_stages=True)
                out_w = tri_first_hit(*w_args, mode="mx")
                torch.cuda.synchronize()
                ms, held = cs.device_ms(lambda: tri_first_hit(*args, mode="mx"),
                                        "tri_trace_mx_kernel")
            equal = all(torch.equal(a, b) for a, b in zip(out[:3], ref[:3]))
            print(f"mx | {label}: kernel {ms:.4f} ms on the device ({held} of 20 launches "
                  f"traced), {b_ms / ms:.4f} of the bound, "
                  f"{floor_ms / ms:.4f} of the floor; stages executed a tile mean "
                  f"{float(out[3].float().mean()):.2f}; equal to the package's kernel {equal}; "
                  f"watertight: rays past {cs.T_TOL} m of the plain version "
                  f"{deep(out_w, plain_w[0].double(), plain_w[1])}, of float64 "
                  f"{deep(out_w, t64, hit64)} | {card}", flush=True)
            cs.check(equal or not MX_COPIES[label][1],
                     f"{label}: differs from the package's kernel")


# the edits of csrc/tri_tile.cu that take back the steps of the list walk's
# design (chip_profile.py tile and list)
EVERY_SLOT = {"const int n_real = max(0, min(cnt[tile_idx], n_own * chunk));":
              "const int n_real = n_own * chunk;"}
GATHER_WAITED = {
    "             PIN ? m_pin : min(chunk, n_real - (ci + P) * chunk), bs, vec, soup, T);\n":
    "             PIN ? m_pin : min(chunk, n_real - (ci + P) * chunk), bs, vec, soup, T);\n"
    "    asm volatile(\"cp.async.wait_group 0;\\n\" ::: \"memory\");\n"}
SLOT_UNROLL = "#pragma unroll 8\n    for (int j = 0; j < m; ++j) {"
SV2_BOUND = {"__launch_bounds__(kThreads)": "__launch_bounds__(kThreads, FORM == kSV ? 5 : 1)"}
FOUR_RAYS = {"constexpr int kRays = 2;": "constexpr int kRays = 4;"}
THREADS_128 = {"constexpr int kThreads = 256;": "constexpr int kThreads = 128;"}
# the kSV body with the sign tests as one predicate chain and the accepted
# path taken once a slot, where any of the thread's tests passed the gate
# (design step 4): the same arithmetic and gate as test_slot<kSV>, to the bit
SV_SLOT = {
    "// No bound on the blocks an SM": """\
// One staged triangle (r0, r1, r2) of the kSV body against the thread's RAYS
// rays: test_slot<kSV>'s arithmetic and gate, with the three sign tests as one
// predicate chain and the accepted path once a slot.
template <int RAYS>
__device__ __forceinline__ void sv_slot(float4 r0, float4 r1, float4 r2,
                                        const float (&dx)[RAYS], const float (&dy)[RAYS],
                                        const float (&dz)[RAYS], int pos, float (&tbest)[RAYS],
                                        int (&pbest)[RAYS]) {
  float w0[RAYS], w1[RAYS], w2[RAYS];
  bool pass[RAYS];
  bool any = false;
#pragma unroll
  for (int k = 0; k < RAYS; ++k) {
    w0[k] = dot3(dx[k], dy[k], dz[k], r0.x, r0.y, r0.z);
    w1[k] = dot3(dx[k], dy[k], dz[k], r0.w, r1.x, r1.y);
    w2[k] = dot3(dx[k], dy[k], dz[k], r1.z, r1.w, r2.x);
    pass[k] = (w0[k] * w1[k] >= 0.0f) & (w0[k] * w2[k] >= 0.0f) & (w1[k] * w2[k] >= 0.0f);
    any = any | pass[k];
  }
  if (__builtin_expect(any, 0)) {
#pragma unroll
    for (int k = 0; k < RAYS; ++k) {
      if (!pass[k]) continue;
      const float wsum = w0[k] + w1[k] + w2[k];
      const float tk = r2.y * (1.0f / wsum);
      if (tk > 1e-4f && tk < tbest[k]) {
        tbest[k] = tk;
        pbest[k] = pos;
      }
    }
  }
}

// No bound on the blocks an SM""",
    """#pragma unroll
      for (int k = 0; k < kRays; ++k)
        test_slot<FORM>(r0, r1, r2, dx[k], dy[k], dz[k], ox[k], oy[k], oz[k], pos0 + j,
                        tbest[k], pbest[k]);""": """      if (FORM == kSV) {
        sv_slot<kRays>(r0, r1, r2, dx, dy, dz, pos0 + j, tbest, pbest);
      } else {
#pragma unroll
        for (int k = 0; k < kRays; ++k)
          test_slot<FORM>(r0, r1, r2, dx[k], dy[k], dz[k], ox[k], oy[k], oz[k], pos0 + j,
                          tbest[k], pbest[k]);
      }"""}


def unrolled(n):
    return {SLOT_UNROLL: SLOT_UNROLL.replace("unroll 8", f"unroll {n}")}


def copy_rays(edits):
    """Rays a thread of a copy of ``csrc/tri_tile.cu`` with ``edits``."""
    return 4 if FOUR_RAYS.keys() <= edits.keys() else 2


# the copies of csrc/tri_tile.cu that chip_profile.py tile builds: label ->
# {line of the source: its replacement}; each takes one step of B4's design
# back, or gives its blocks another shape (a block is the copy's kThreads
# threads of kRays rays each; the 4-ray shapes take the kSV body sv_slot,
# which served them best)
TILE_COPIES = {
    "the design: 256 threads x 2 rays, 2 blocks a tile (the package's)": {},
    "step 1 back: 256 threads x 4 rays, the whole tile a block": {**FOUR_RAYS, **SV_SLOT},
    "step 2 back: every slot of the walked stages": EVERY_SLOT,
    "step 3 back: the next stage's gather waited for before the tests": GATHER_WAITED,
    "256 threads x 2 rays, at most 51 registers (kSV: 5 blocks an SM)": SV2_BOUND,
    "the slot loop unrolled by 4": unrolled(4),
    "the slot loop not unrolled": unrolled(1),
    "128 threads x 4 rays, 2 blocks a tile": {**THREADS_128, **FOUR_RAYS, **SV_SLOT},
    "128 threads x 2 rays, 4 blocks a tile": THREADS_128,
    "128 threads x 4 rays, at most 64 registers (8 blocks an SM)": {
        **THREADS_128, **FOUR_RAYS, **SV_SLOT,
        "__launch_bounds__(kThreads)": "__launch_bounds__(kThreads, 8)"},
}
# the copies chip_profile.py list builds (B7a, B7c): label -> edits, each
# taking one step of the design back (the order, step 1, is the wrapper's:
# taken away by launching the package's in index order) or varying it
LIST_COPIES = {
    "the design: 256 threads x 2 rays, 2 blocks a tile (the package's)": {},
    "step 2 back: 256 threads x 4 rays, the whole tile a block, sv_slot": {**FOUR_RAYS,
                                                                          **SV_SLOT},
    "256 threads x 4 rays, test_slot's body": FOUR_RAYS,
    "step 3 back: every slot of the walked stages": EVERY_SLOT,
    "sv_slot at 2 rays a thread": SV_SLOT,
    "step 4 back: the slot loop not unrolled": unrolled(1),
    "the slot loop unrolled by 2": unrolled(2),
    "the slot loop unrolled by 4": unrolled(4),
    "step 5 back: one float a copy": {
        "const bool vec = bs % 4 == 0 && T % bs == 0 && (uintptr_t)tris % 16 == 0;":
        "const bool vec = false;"},
    "step 5 back: the next stage's gather waited for before the tests": GATHER_WAITED,
    "at most 51 registers (kSV: 5 blocks an SM)": SV2_BOUND,
}


@contextlib.contextmanager
def tile_library(lib):
    """The tile tiers launch the kernel of the library ``lib`` inside the
    block: the wrapper's own checks and arguments, another build."""
    import ctypes

    from visfly_tpu_torch.render import tri_kernel as tk

    own = tk._tile_launchers
    fn = ctypes.CDLL(lib).tri_tile_launch
    fn.argtypes, fn.restype = own()[0].argtypes, own()[0].restype
    tk._tile_launchers = lambda: (fn, own()[1])
    try:
        yield
    finally:
        tk._tile_launchers = own


def tile(envs, card):
    """B4's tile kernel, step by step (``TILE_COPIES``, and the package's
    with its tiles launched in index order, step 4 back), on path D's three
    uses of it and on the synthetic ragged lists of ``chip_smoke.py``: per
    copy its registers and spills, then in turns, forwards and backwards, its
    device time, its share of the bound and whether it equals the cluster walk
    at k = 1 (t and hit to the bit, ids where the ray hits), beside the
    cluster walk at k = 1 and at the k it would pick."""
    import concurrent.futures

    from visfly_tpu_torch.render import default_tri_cap, tri_first_hit, tri_first_hit_reference
    from visfly_tpu_torch.render import tri_kernel as tk
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    with concurrent.futures.ThreadPoolExecutor(len(TILE_COPIES)) as pool:
        libs = dict(zip(TILE_COPIES, pool.map(lambda kv: source_copy("tri_tile", kv[0], kv[1]),
                                              TILE_COPIES.items())))
    for label, lib in libs.items():
        ptxas_report(lib, f"tile | {label}", card, only="tri_tile_kernel")
    uses = []
    for level, env in envs.items():
        state, _ = env.reset(torch.Generator(device=env.device).manual_seed(0))
        tris = env.scene.triangles
        T = tris.shape[1]
        for sensor in range(len(env.sensor_kwargs)):
            o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, sensor)
            plan = plan_tiles(tris, o_c, d_c, cs.MAX_DEPTH, default_tri_cap(T), img_w, cam_rays)
            if not tk.tile_route(plan.form, plan.lists):
                continue
            h, w = env.sensor_kwargs[sensor]["resolution"]
            args = (tris, plan.lists, plan.origins_c, plan.dirs_c, cs.MAX_DEPTH, plan.form,
                    plan.origin_tiles)
            uses.append((f"{plan.form} T={T} {h}x{w}", args,
                         cs.kept_lists(plan.lists, plan.lists.count)))
            if level == 0 and plan.form == "sv_tile":
                ragged = cs.ragged_lists(plan.lists)
                uses.append((f"{plan.form} T={T} {h}x{w} ragged lists {list(cs.RAGGED_COUNTS)}",
                             (tris, ragged, *args[2:]), ragged))
    first = next(iter(libs))
    for use, args, kept in uses:
        tris, lists, o_c, _, _, form, _ = args
        n_rays = o_c.shape[2]
        stats = {}
        tri_first_hit_reference(tris, kept, *args[2:], stats=stats)
        b_ms, b_by, _ = cs.tri_bound_ms(form, stats, n_rays, kept, form == "mt")
        k = tk.default_split(lists, form, "scalar", o_c.device)
        one = tri_first_hit(*args, split=1)
        c = tk.real_counts(lists, tris.shape[1]).float() / lists.chunk
        print(f"tile | {use} at {n_rays} rays: {c.numel()} tiles, real slots a tile in stages "
              f"mean {float(c.mean()):.2f} p90 {float(c.quantile(0.9)):.2f} max "
              f"{float(c.max()):.2f} of {lists.lb.shape[-1]}; {stats['real_tests'] / n_rays:.1f} "
              f"tests a ray; bound {b_ms:.4f} ms by {b_by} | {card}", flush=True)
        runs = [(label, lib, args) for label, lib in libs.items()]
        runs.append(("step 4 back: the package's, tiles in index order", libs[first],
                     (tris, lists._replace(order=None), *args[2:])))
        for turn in (runs, runs[::-1]):
            for kk in (1, k):
                ms = cs.device_ms(lambda: tri_first_hit(*args, split=kk))
                print(f"tile | {use} the cluster walk at k = {kk}: {ms:.4f} ms on the device, "
                      f"{b_ms / ms:.3f} of the bound | {card}", flush=True)
            for label, lib, a in turn:
                with tile_library(lib):
                    out = tri_first_hit(*a)
                    ms = cs.device_ms(lambda: tri_first_hit(*a))
                print(f"tile | {use} {label}: {ms:.4f} ms on the device, {b_ms / ms:.3f} of the "
                      f"bound; equal to the cluster walk at k = 1 {cs.same_result(out, one)} | "
                      f"{card}", flush=True)


def sass_listing(lib, kernel):
    """[(offset, instruction)] of the function of the built library ``lib``
    whose mangled name holds ``kernel`` (``cuobjdump -sass``)."""
    from visfly_tpu_torch.build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split()[0]
        if kernel in name:
            out[name] = [(int(m.group(1), 16), m.group(2).strip()) for m in
                         re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;/]+);", block)]
    cs.check(bool(out), f"no function {kernel} in {lib}")
    return out


def slot_loop(listing):
    """The slot loop of a list walk's SASS: the innermost loop (a backward
    branch with no other inside it) with the most fused multiply-adds →
    (its instructions, the spans a forward branch inside it skips that hold
    the reciprocal or a call: the accepted path, walked only where a test
    passed the gate)."""
    def target(ins):
        m = re.search(r"\bBRA(?:\.\S+)?\s+`?\(?(0x[0-9a-f]+)", ins)
        return int(m.group(1), 16) if m else None

    loops = [(target(ins), off) for off, ins in listing
             if target(ins) is not None and target(ins) <= off]
    inner = [(a, b) for a, b in loops if not any(a <= c < d <= b and (c, d) != (a, b)
                                                 for c, d in loops)]
    body = max(([x for x in listing if a <= x[0] <= b] for a, b in inner),
               key=lambda xs: sum("FFMA" in ins for _, ins in xs))
    end = body[-1][0]
    rare = set()
    for off, ins in body:
        to = target(ins)
        if to is not None and off < to <= end:
            span = [x for x in body if off < x[0] < to]
            if any("MUFU" in i or "CALL" in i for _, i in span):
                rare.update(x[0] for x in span)
    return body, rare


def sass_report(lib, label, card, rays, dump_dir=None):
    """Per instantiation of the list walk in ``lib`` (``rays`` a thread):
    its slot loop's instructions on the common path (the accepted path
    apart), the slots an iteration serves (three shared-memory loads a staged
    triangle) and the tests (slots x rays) → {(form, merged, stage shares,
    count, body, pin): instructions a test} (the flags a source without the
    diagnostics lacks take their render values). Instances with the body
    knocked out have no slot loop. With ``dump_dir`` the loop's SASS is
    written there, a file an instantiation."""
    per_test = {}
    for name, listing in sass_listing(lib, "tri_tile_kernel").items():
        m = re.search(r"tri_tile_kernelILi(\d)E((?:Lb\dE)+)", name)
        flags = [int(x) for x in re.findall(r"Lb(\d)E", m.group(2))]
        form, merged, split, count, test, pin = (int(m.group(1)), *flags,
                                                 *(0, 1, 0)[len(flags) - 2:])
        if not test:
            continue
        body, rare = slot_loop(listing)
        common = [ins for off, ins in body if off not in rare]
        ops = [ins.split()[1] if ins.startswith("@") else ins.split()[0] for ins in common]
        lds = sum(o.startswith("LDS") for o in ops)
        slots = lds / 3
        tests = slots * rays
        n = len(common) / tests if tests else float("nan")
        per_test[(form, merged, split, count, test, pin)] = n
        mix = {k: sum(o.startswith(k) for o in ops)
               for k in ("FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "PLOP3", "LDS", "ISETP", "IADD",
                         "BRA", "BSSY", "MUFU")}
        what = (f"form {'kSV' if form else 'kMT'}, {'merged' if merged else 'scalar'}, {rays} rays"
                f"{', stage shares' if split else ''}{', count' if count else ''}"
                f"{', stage pinned' if pin else ''}")
        print(f"{label} | sass slot loop ({what}): {len(body)} instructions, {len(rare)} of them "
              f"the accepted path; {len(common)} on the common path for {slots:g} slots x {rays} "
              f"rays = {tests:g} tests: {n:.2f} instructions a test; "
              + ", ".join(f"{k} {v}" for k, v in mix.items() if v) + f" | {card}", flush=True)
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            with open(os.path.join(dump_dir, f"{form}{merged}{split}{count}{test}{pin}.sass"),
                      "w") as f:
                f.writelines(f"{off:06x}{' *' if off in rare else '  '} {ins}\n"
                             for off, ins in body)
    return per_test


@contextlib.contextmanager
def b6_on_the_list_walk():
    """B6's calls (the scalar per-camera tier over block lists) go to the
    list walk inside the block, with its scalar output; no render is
    routed so."""
    from visfly_tpu_torch.render import tri_kernel as tk

    own = tk.list_route

    def route(form, lists, mode="scalar", count_stages=False, knockout=False, split=None):
        b6 = (form == "sv_cam" and mode == "scalar" and lists.start is None
              and not count_stages and not knockout and split is None)
        return b6 or own(form, lists, mode, count_stages, knockout, split)

    tk.list_route = route
    try:
        yield
    finally:
        tk.list_route = own


def list_uses(env, dev):
    """(label, args, mode) of B7a and B7c on path D's 64×64 rays at 23,040
    triangles (default cap and budget) and on a ragged set of each
    (``chip_smoke.py``'s block lists cut to 0-45 blocks a tile, the worklist
    at a budget for every stage)."""
    from visfly_tpu_torch.render import default_tri_cap
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
    tris = env.scene.triangles
    T = tris.shape[1]
    o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, 0)
    cap = default_tri_cap(T)
    uses = []
    for variant, budget, cut in (("merged", None, False), ("wl", None, False),
                                 ("merged", None, True), ("wl", 10 ** 6, False)):
        plan = plan_tiles(tris, o_c, d_c, cs.MAX_DEPTH, cap, img_w, cam_rays, variant=variant,
                          work_budget=budget)
        lists = cs.ragged_blocks(plan.lists) if cut else plan.lists
        name = {"merged": "B7a merged", "wl": "B7c worklist"}[variant]
        name += (" ragged block lists" if cut else " budget for every stage" if budget
                 else "")
        uses.append((f"{name} T={T} 64x64", (tris, lists, plan.origins_c, plan.dirs_c,
                                              cs.MAX_DEPTH, plan.form, plan.origin_tiles),
                     plan.mode))
    return uses


def list_walk(env, card):
    """B7a's and B7c's list walk, step by step (``LIST_COPIES``; the order
    taken away; the cluster walk at k = 2 in the lists' order), with the SASS
    count of the slot loop and the issue floor it sets; then B6's lists on
    the list walk beside the cluster walk B6 takes (recorded, not routed), at
    23,040 and 92,160 triangles."""
    import concurrent.futures

    from visfly_tpu_torch.examples import tri_bench
    from visfly_tpu_torch.render import (default_tri_cap, pack_triangles, tri_first_hit,
                                         tri_first_hit_reference)
    from visfly_tpu_torch.render import tri_kernel as tk
    from visfly_tpu_torch.render.tri_trace import plan_tiles, walk_order

    dev = env.device
    with concurrent.futures.ThreadPoolExecutor(len(LIST_COPIES)) as pool:
        libs = dict(zip(LIST_COPIES, pool.map(lambda kv: source_copy("tri_tile", kv[0], kv[1]),
                                              LIST_COPIES.items())))
    first = next(iter(libs))
    floors = {}
    for label, lib in libs.items():
        ptxas_report(lib, f"list | {label}", card, only="tri_tile_kernel")
        out = os.environ.get("VISFLY_PROFILE_OUT", os.path.join(cs.REPO, "build", "profile"))
        dump = os.path.join(out, "list_sass", re.sub(r"[^a-z0-9]+", "-", label.lower())[:40])
        floors[label] = sass_report(lib, f"list | {label}", card, copy_rays(LIST_COPIES[label]),
                                    dump)
    for use, args, mode in list_uses(env, dev):
        tris, lists, o_c, _, _, form, _ = args
        n_rays = o_c.shape[2]
        stats = {}
        tri_first_hit_reference(*args, stats=stats, mode=mode)
        b_ms, b_by, _ = cs.tri_bound_ms(form, stats, n_rays, lists,
                                        out_bytes=8 if mode == "merged" else 9)
        k = tk.default_split(lists, form, mode, dev)
        index = (tris, lists._replace(order=None), *args[2:])
        one = tri_first_hit(*index, mode=mode, split=1)
        c = tk.real_counts(lists, tris.shape[1]).float() / lists.chunk
        rays = tk.TILE_BLOCK_RAYS // 256
        n_test = floors[first][(1, int(mode == "merged"), 0, 0, 1, 0)]
        floor_ms = stats["real_tests"] * n_test / (cs.PEAK_FP32_PER_S / 2) * 1e3
        print(f"list | {use} at {n_rays} rays: {c.numel()} tiles, real slots a tile in stages "
              f"mean {float(c.mean()):.2f} p90 {float(c.quantile(0.9)):.2f} max "
              f"{float(c.max()):.2f}; {stats['real_tests'] / n_rays:.1f} tests a ray; bound "
              f"{b_ms:.4f} ms by {b_by}; the issue floor of the package's slot loop "
              f"({n_test:.2f} instructions a test at {rays} rays a thread) {floor_ms:.4f} ms, "
              f"{b_ms / floor_ms:.3f} of the bound's time | {card}", flush=True)
        runs = [(label, lib, args) for label, lib in libs.items()]
        runs.append(("step 1 back: the package's, tiles in index order", libs[first], index))
        walks = [("the cluster walk in index order", index, kk) for kk in sorted({1, k})]
        walks += [("the cluster walk longest first (shape c)", args, kk) for kk in sorted({2, k})]
        for turn in (runs, runs[::-1]):
            for name, a, kk in walks:
                ms = cs.device_ms(lambda: tri_first_hit(*a, mode=mode, split=kk))
                print(f"list | {use} {name} at k = {kk}{' (picked)' if kk == k else ''}: "
                      f"{ms:.4f} ms on the device, {b_ms / ms:.3f} of the bound | {card}",
                      flush=True)
            for label, lib, a in turn:
                with tile_library(lib):
                    out = tri_first_hit(*a, mode=mode)
                    ms = cs.device_ms(lambda: tri_first_hit(*a, mode=mode))
                print(f"list | {use} {label}: {ms:.4f} ms on the device, {b_ms / ms:.3f} of the "
                      f"bound; equal to the cluster walk at k = 1 {cs.same_result(out, one)} | "
                      f"{card}", flush=True)

    # B6's lists on the list walk, beside the cluster walk B6 takes
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
    tris3 = env.scene.triangles
    o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, 0)
    tris4 = torch.as_tensor(pack_triangles(*tri_bench.load_garage(4))[None], device=dev)
    o4, d4 = tri_bench.batch_rays(256, cs.RES[1], dev)
    for tris, o, d, w, cam in ((tris3, o_c, d_c, img_w, cam_rays),
                               (tris4, o4, d4, cs.RES[1], cs.RES[0] * cs.RES[1])):
        T = tris.shape[1]
        plan = plan_tiles(tris, o, d, cs.MAX_DEPTH, default_tri_cap(T), w, cam)
        args = (tris, plan.lists, plan.origins_c, plan.dirs_c, cs.MAX_DEPTH, plan.form,
                plan.origin_tiles)
        stats = {}
        tri_first_hit_reference(*args, stats=stats)
        n_rays = o.shape[2]
        b_ms, b_by, _ = cs.tri_bound_ms(plan.form, stats, n_rays, plan.lists)
        k = tk.default_split(plan.lists, plan.form, "scalar", dev)
        one = tri_first_hit(*args, split=1)
        walked = (tris, walk_order(plan.lists), *args[2:])  # with the count and order B7a gets
        for turn in range(2):
            ms = cs.device_ms(lambda: tri_first_hit(*args))
            print(f"list | B6 T={T} at {n_rays} rays ({stats['real_tests'] / n_rays:.1f} tests a "
                  f"ray), its route, the cluster walk at k = {k}: {ms:.4f} ms on the device, "
                  f"{b_ms / ms:.3f} of the bound ({b_ms:.4f} ms by {b_by}) | {card}", flush=True)
            shapes = [(label, lib) for label, lib in libs.items() if "x 4 rays" in label]
            shapes.insert(0, (first, libs[first]))
            for label, lib in (shapes if turn == 0 else shapes[::-1]):
                with b6_on_the_list_walk(), tile_library(lib):
                    out = tri_first_hit(*walked)
                    ms = cs.device_ms(lambda: tri_first_hit(*walked))
                print(f"list | B6 T={T} on the list walk, {label} (not routed): "
                      f"{ms:.4f} ms on the device, {b_ms / ms:.3f} of the bound; equal to the "
                      f"cluster walk at k = 1 {cs.same_result(out, one)} | {card}", flush=True)


@contextlib.contextmanager
def stage_shares(parts):
    """The list walk takes ``parts`` stage shares a tile inside the block
    (None: the wrapper's own choice, :func:`tri_kernel.stage_parts`)."""
    from visfly_tpu_torch.render import tri_kernel as tk

    own = tk.stage_parts
    if parts is not None:
        tk.stage_parts = lambda n_blocks, resident: parts
    try:
        yield
    finally:
        tk.stage_parts = own


def grid_sweep(env, card):
    """B7a and B7c on few tiles: path D's first 8 to 256 cameras at 23,040
    triangles (default cap and budget), and ``tri_bench``'s level 4 on 8
    cameras at ``cap = T`` (path T3): the list walk at 1, 2, 4 and 8 stage
    shares a tile and at the wrapper's choice, beside the cluster walk at its
    picked k, each held to the cluster walk at k = 1."""
    from visfly_tpu_torch.examples import tri_bench
    from visfly_tpu_torch.render import default_tri_cap, pack_triangles, tri_first_hit
    from visfly_tpu_torch.render import tri_kernel as tk
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    dev = env.device
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
    tris3 = env.scene.triangles
    o_c, d_c, img_w, cam_rays = cs.mesh_camera_rays(env, state, 0)
    cases = [(f"T=23040 {n} cameras", tris3, o_c[:, :, :n * cam_rays].contiguous(),
              d_c[:, :, :n * cam_rays].contiguous(), default_tri_cap(tris3.shape[1]))
             for n in (8, 16, 32, 64, 128, 256)]
    tris4 = torch.as_tensor(pack_triangles(*tri_bench.load_garage(4))[None], device=dev)
    o4, d4 = tri_bench.batch_rays(8, cs.RES[1], dev)
    cases.append(("T=92160 8 cameras, cap = T (path T3)", tris4, o4, d4, tris4.shape[1]))
    for case, tris, o, d, cap in cases:
        for variant in ("merged", "wl"):
            plan = plan_tiles(tris, o, d, cs.MAX_DEPTH, cap, cs.RES[1], cs.RES[0] * cs.RES[1],
                              variant=variant)
            args = (tris, plan.lists, plan.origins_c, plan.dirs_c, cs.MAX_DEPTH, plan.form,
                    plan.origin_tiles)
            mode = plan.mode
            one = tri_first_hit(*args, mode=mode, split=1)
            k = tk.default_split(plan.lists, plan.form, mode, dev)
            index = (tris, plan.lists._replace(order=None), *args[2:])
            n_blocks = plan.lists.n_stage.numel() * (tk.TILE // tk.TILE_BLOCK_RAYS)
            resident = tk._resident(dev, plan.form, mode)
            times = {}
            for parts in (None, 1, 2, 4, 8):
                with stage_shares(parts):
                    out = tri_first_hit(*args, mode=mode)
                    times[parts] = cs.device_ms(lambda: tri_first_hit(*args, mode=mode))
                cs.check(cs.same_result(out, one), f"{case} {variant}: {parts} stage shares "
                                                   "differ from the cluster walk at k = 1")
            old = cs.device_ms(lambda: tri_first_hit(*index, mode=mode, split=k))
            print(f"list | sweep {variant} {case}: {n_blocks} blocks of the list walk, {resident} "
                  f"resident, the wrapper's stage shares "
                  f"{tk.stage_parts(n_blocks, resident)}: {times[None]:.4f} ms on the device; at 1 / "
                  f"2 / 4 / 8 stage shares {times[1]:.4f} / {times[2]:.4f} / {times[4]:.4f} / "
                  f"{times[8]:.4f}; the cluster walk in index order at its k = {k} {old:.4f}; each "
                  f"equal to the cluster walk at k = 1 | {card}", flush=True)


ANALYTIC_MIN_BLOCKS = (2, 3, 4, 8)  # blocks an SM of the copies chip_profile.py analytic builds


def analytic_copy(min_blocks):
    """The library of ``csrc/trace_analytic.cu`` with ``kMinBlocks`` set to
    ``min_blocks`` (:func:`source_copy`)."""
    from visfly_tpu_torch import build as vb

    with open(os.path.join(vb.CSRC, "trace_analytic.cu")) as f:
        line = re.search(r"constexpr int kMinBlocks = (\d+);", f.read())
    cs.check(line is not None, "trace_analytic.cu has no kMinBlocks constant")
    edits = ({} if int(line.group(1)) == min_blocks
             else {line.group(0): f"constexpr int kMinBlocks = {min_blocks};"})
    return source_copy("trace_analytic", f"kMinBlocks {min_blocks}", edits)


@contextlib.contextmanager
def analytic_library(lib):
    """``trace_analytic`` launches the kernel of the library ``lib`` inside
    the block: the wrapper's own checks and arguments, another build."""
    import ctypes

    from visfly_tpu_torch.render import trace_kernel as tk

    own = tk._launcher
    fn = ctypes.CDLL(lib).trace_analytic_launch
    fn.argtypes, fn.restype = own("trace_analytic").argtypes, own("trace_analytic").restype
    tk._launcher = lambda name: fn if name == "trace_analytic" else own(name)
    try:
        yield
    finally:
        tk._launcher = own


def ptxas_report(lib, label, card, only=""):
    """Registers and spill bytes of each kernel instantiation of a library
    (named by its function and template flags, mangled), or of those whose
    mangled name holds ``only``."""
    for name, regs, stores, _ in cs.ptxas_entries(lib):
        if only not in name:
            continue
        m = re.search(r"\d+([a-z_]+_kernel)(I\w*?EE)?", name)
        which = m.group(1) + (m.group(2) or "") if m else name
        print(f"{label} | ptxas {which}: {regs} registers, {stores} bytes spilled | {card}",
              flush=True)


def analytic(env_b, env_a, card):
    """The analytic kernel at each of ANALYTIC_MIN_BLOCKS on the main path's
    uses: device time, equality with the plain version, bound and share."""
    import concurrent.futures

    from visfly_tpu_torch.render import (prepare_kernel_scene, trace_analytic,
                                         trace_analytic_reference)
    from visfly_tpu_torch.render import trace_kernel as tk

    with concurrent.futures.ThreadPoolExecutor(len(ANALYTIC_MIN_BLOCKS)) as pool:
        built = pool.map(analytic_copy, ANALYTIC_MIN_BLOCKS)
        libs = {f"256 threads x 4 rays, {n} blocks an SM": lib
                for n, lib in zip(ANALYTIC_MIN_BLOCKS, built)}
    for label, lib in libs.items():
        ptxas_report(lib, f"analytic | {label}", card)
    dev = torch.device("cuda", 0)
    W = cs.RES[1]
    rays = {}
    for name, env in (("path B", env_b), ("path A", env_a)):
        state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
        rays[name] = (prepare_kernel_scene(env.scene), *cs.camera_rays_of(env, state), W)
    g = torch.Generator(device=dev).manual_seed(1)
    n = 1 << 20
    o_r = (torch.rand((3, 1, n), generator=g, device=dev)
           * torch.tensor([19.0, 11.0, 4.5], device=dev)[:, None, None]
           + torch.tensor([-1.5, -5.5, 0.25], device=dev)[:, None, None]).contiguous()
    d_r = torch.randn((3, 1, n), generator=g, device=dev)
    d_r = (d_r / torch.linalg.vector_norm(d_r, dim=0, keepdim=True)).contiguous()
    rays["1M random rays"] = (rays["path B"][0], o_r, d_r, None)
    uses = [("trace_analytic", "path B"), ("trace_analytic_kid", "path A"),
            ("trace_analytic_kid", "path B"), ("trace_analytic", "1M random rays")]
    ref = {}
    for mode, where in uses:
        ks, o, d, img_w = rays[where]
        kid = mode.endswith("kid")
        plan = tk.cull_rows(ks, o, d, cs.MAX_DEPTH, img_w)
        ref[mode, where] = trace_analytic_reference(ks, o, d, cs.MAX_DEPTH, want_kid=kid,
                                                    cull=True, img_w=img_w)
        b_ms, b_by = cs.bound_ms(mode, ks, o.shape[2], plan=plan, o=o)
        old_ms, _ = cs.bound_ms(mode, ks, o.shape[2], o=o, old=True)
        one = cs.one_origin_tiles(o)
        print(f"analytic | {mode} on {where}: bound {b_ms:.4f} ms by {b_by} (old yardstick "
              f"{old_ms:.4f}); one origin on {float(one.double().mean()):.4f} of the tiles; a "
              f"ray tests {float(plan.box_in.sum(-1).double().mean()):.2f} box and "
              f"{float(plan.cap_in.sum(-1).double().mean()):.2f} capsule rows | {card}",
              flush=True)
        ref[mode, where] = (ref[mode, where], b_ms)
    for order in (list(libs), list(libs)[::-1]):
        for label in order:
            for mode, where in uses:
                ks, o, d, img_w = rays[where]
                call = lambda: trace_analytic(  # noqa: E731
                    ks, o, d, cs.MAX_DEPTH, want_kid=mode.endswith("kid"), cull=True,
                    img_w=img_w)
                with analytic_library(libs[label]):
                    out = call()
                    torch.cuda.synchronize()
                    ms, held = cs.device_ms(call, "trace_analytic_kernel")
                (plain, b_ms) = ref[mode, where]
                equal = all(torch.equal(a, b) for a, b in zip(out, plain))
                print(f"analytic | {label} | {mode} on {where}: kernel {ms:.4f} ms on the device "
                      f"({held} of 20 launches traced), "
                      f"{b_ms / ms:.4f} of the bound, equal to the plain version {equal} | "
                      f"{card}", flush=True)
                cs.check(equal, f"{label}: {mode} on {where} differs from its plain version")
    ks, o, d, _ = rays["path B"]
    ms, held = cs.device_ms(lambda: trace_analytic(ks, o, d, cs.MAX_DEPTH),
                            "trace_analytic_kernel")
    print(f"analytic | the package's kernel, trace_analytic on path B without the cull: "
          f"{ms:.4f} ms on the device ({held} of 20 launches traced) | {card}", flush=True)


def timing(env_b, card):
    """Per-launch kernel records against ``chip_smoke.py::device_ms``."""
    import numpy as np

    import visfly_tpu_torch.render.global_view as gv
    from visfly_tpu_torch.envs import NavigationEnv
    from visfly_tpu_torch.render import camera_rays_components, prepare_kernel_scene

    dev = torch.device("cuda", 0)
    env = NavigationEnv(device=dev, **cs.CLUTTERED_FLIGHT)
    state, _ = env.reset(torch.Generator(device=dev).manual_seed(0))
    eye, look = gv._camera_pose("top", env.bbox.cpu().numpy(),
                                state.dyn.pos.mean(0).cpu().numpy())
    q = gv._look_at_quat(eye.astype("float64"), look.astype("float64"))
    spec = {"sensor_type": "color", "resolution": [480, 640], "hfov": 90.0, "tile": 1}
    o_c, d_c, _ = camera_rays_components(
        spec, torch.tensor(eye, dtype=torch.float32, device=dev)[None],
        torch.tensor(q, dtype=torch.float32, device=dev)[None])
    n = 480 * 640
    o_v = o_c[:, :, None].expand(3, 1, n).contiguous()
    d_v = d_c.reshape(3, 1, n).contiguous()
    state_b, _ = env_b.reset(torch.Generator(device=dev).manual_seed(0))
    uses = {
        "B1-kid, the 480x640 global view": (
            "trace_analytic_kid", prepare_kernel_scene(gv.scene_zero(env.scene)), o_v, d_v, 640),
        "B1, path B's camera rays": (
            "trace_analytic", prepare_kernel_scene(env_b.scene),
            *cs.camera_rays_of(env_b, state_b), cs.RES[1])}
    for use, (mode, ks, o, d, img_w) in uses.items():
        kernel = cs.kernel_modes(None, img_w)[mode][0]
        call = lambda: kernel(ks, o, d)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        for round_ in range(3):
            for queued in (False, True):
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    if queued:
                        torch.cuda._sleep(20_000_000)
                    for _ in range(20):
                        call()
                    torch.cuda.synchronize()
                ev = sorted((e for e in prof.events() if cs.KERNEL_NAMES[mode] in e.name
                             and e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
                dur = np.array([e.time_range.elapsed_us() for e in ev])
                gaps = np.array([b.time_range.start - a.time_range.end
                                 for a, b in zip(ev, ev[1:])])
                how = (f"queued, gaps {gaps.min():.2f}-{gaps.max():.2f} us" if queued and
                       len(gaps) else "host between launches")
                stats = (f"{dur.mean():.2f} us (min {dur.min():.2f}, max {dur.max():.2f})"
                         if len(dur) else "none")
                print(f"timing | {use} round {round_} ({how}): {len(ev)} of 20 launches "
                      f"recorded, {stats} | {card}", flush=True)
            print(f"timing | {use} round {round_}: device_ms {cs.device_ms(call) * 1e3:.2f} us"
                  f" | {card}", flush=True)


def plane(card, dev=None, levels=(3, 4), cams=8):
    """``plane``: the kernels' t and the function's against float64."""
    from visfly_tpu_torch.examples import tri_bench
    from visfly_tpu_torch.render import pack_triangles, tri_first_hit, tri_trace_brute
    from visfly_tpu_torch.render.tri_trace import VARIANTS, plan_tiles, tri_trace_tiled

    dev = dev or torch.device("cuda", 0)
    res = cs.RES[1]
    o, d = tri_bench.batch_rays(cams, res, dev)
    op, dp = o.permute(1, 2, 0), d.permute(1, 2, 0)
    for level in levels:
        tris = torch.as_tensor(pack_triangles(*tri_bench.load_garage(level))[None], device=dev)
        T = tris.shape[1]
        b32 = tri_trace_brute(tris, op, dp, cs.MAX_DEPTH)
        b64 = tri_trace_brute(tris.double(), op.double(), dp.double(), cs.MAX_DEPTH)
        both = b32[1] & b64[1]
        print(f"plane | T={T}: float32 brute force vs float64 max|dt| "
              f"{float((b32[0].double() - b64[0]).abs()[both].max()):.3e} m, hit mismatches "
              f"{int((b32[1] != b64[1]).sum())} of {o.shape[2]} | {card}", flush=True)

        def off(t, hit, gid):
            err = torch.where(hit & b64[1], (t.double() - b64[0]).abs(), 0.0)
            i = int(err.reshape(-1).argmax())
            row = tris[0, int(gid.reshape(-1)[i])].double().view(3, 3)
            edges = ", ".join(f"{float((row[(k + 1) % 3] - row[k]).norm()):.4f}" for k in range(3))
            n = torch.linalg.cross(row[1] - row[0], row[2] - row[0])
            cos = float((n / n.norm() * dp[0, i].double()).sum().abs())
            return (f"{float(err.max()):.3e} m (rays past 1e-3 m: {int((err > 1e-3).sum())}; worst "
                    f"at t {float(b64[0].reshape(-1)[i]):.3f} m, edges {edges} m, |cos| {cos:.3f})")

        for variant in VARIANTS:
            plan = plan_tiles(tris, o, d, cs.MAX_DEPTH, T, res, res * res, variant=variant)
            t, hit, gid = tri_first_hit(tris, plan.lists, plan.origins_c, plan.dirs_c,
                                        cs.MAX_DEPTH, plan.form, plan.origin_tiles, plan.mode)
            t, hit, gid = ((plan.unpack or (lambda y: y))(x) for x in (t, hit, gid))
            t_f, hit_f, _, gid_f = tri_trace_tiled(tris, o, d, cs.MAX_DEPTH, T, res, res * res,
                                                   variant=variant)
            print(f"plane | T={T} {variant}: the kernel's t vs float64 {off(t, hit, gid)}; "
                  f"tri_trace_tiled's {off(t_f, hit_f, gid_f)}; hit mismatches "
                  f"{int((hit_f != b64[1]).sum())} | {card}", flush=True)


def r4_leg(mesh, seed, epochs, deterministic):
    """Path R4 with ``epochs`` and the given cuDNN algorithms → loss and
    parameters (``run_ranks`` imports it by name)."""
    torch.backends.cudnn.deterministic = deterministic
    cs.PPO_TUNED["n_epochs"] = epochs
    out = cs._r_leg(mesh, "R4", seed)
    return {"loss": out["loss"], "params": out["params"]}


def r4(card):
    """``r4``: one process twice and two gloo ranks, against the first."""
    from visfly_tpu_torch.parallel import run_ranks

    dev = torch.device("cuda", 0)
    epochs0, det0 = cs.PPO_TUNED["n_epochs"], torch.backends.cudnn.deterministic
    for epochs in (1, 10):
        for det in (False, True):
            first = r4_leg(cs._one_rank(dev), 373, epochs, det)
            again = r4_leg(cs._one_rank(dev), 373, epochs, det)
            ranks = run_ranks(r4_leg, 2, 373, epochs, det, backend="gloo", device=dev,
                              timeout=600)

            def diff(x):
                loss = abs(x["loss"] - first["loss"]) / abs(first["loss"])
                l2 = float(torch.linalg.vector_norm(x["params"] - first["params"])
                           / torch.linalg.vector_norm(first["params"]))
                return f"loss {loss:.3e}, parameters l2 {l2:.3e}"

            print(f"r4 | {epochs} epochs, cuDNN {'deterministic' if det else 'default'}: loss "
                  f"{first['loss']:.6e}; the same process again: {diff(again)}; gloo x 2 rank 0: "
                  f"{diff(ranks[0])}, rank 1: {diff(ranks[1])} | {card}", flush=True)
    cs.PPO_TUNED["n_epochs"], torch.backends.cudnn.deterministic = epochs0, det0


def main(argv):
    if not torch.cuda.is_available():
        print("CUDA is not available: chip_profile.py needs one CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    mesh_dir = tempfile.TemporaryDirectory(prefix="visfly_garage_")

    def garage_env(level):
        obj = cs.write_obj(os.path.join(mesh_dir.name, f"garage_{level}.obj"),
                           *cs.garage_mesh(level))
        return cs.mesh_env(dev, {"path": obj, "backend": "grid"}, cs.PATH_D[level][1])

    make_env = {"depth": lambda: cs.bench_env(dev), "A": lambda: cs.landing_env(dev),
                "B": lambda: cs.bench_env(dev, cs.SUITE), "C": lambda: cs.hover_env(dev),
                "D0": lambda: garage_env(0), "D2": lambda: garage_env(2),
                "D3": lambda: garage_env(3)}
    from visfly_tpu_torch.algos import BPTT

    for name in argv or ["A", "C"]:
        if name == "sv":
            for level in (2, 3):
                sv_rounding(level, garage_env(level), card)
        elif name == "probe":
            probe(garage_env(3), card)
        elif name == "floor":
            floor(garage_env(3), card)
        elif name == "split":
            split({level: garage_env(level) for level in (0, 2, 3)}, card)
        elif name == "mx":
            mx(garage_env(3), card)
        elif name == "tile":
            tile({level: garage_env(level) for level in (0, 2)}, card)
        elif name == "list":
            list_walk(garage_env(3), card)
        elif name == "sweep":
            grid_sweep(garage_env(3), card)
        elif name == "march":
            march(make_env["B"](), card)
        elif name == "analytic":
            analytic(make_env["B"](), make_env["A"](), card)
        elif name == "timing":
            timing(make_env["B"](), card)
        elif name == "plane":
            plane(card)
        elif name == "r4":
            r4(card)
        elif name == "G":
            from visfly_tpu_torch.algos import PPO
            from visfly_tpu_torch.envs import NavigationEnv

            profile_ppo("path G", PPO(NavigationEnv(device=dev, **cs.CLUTTERED_FLIGHT),
                                      **cs.PPO_TUNED), card)
        elif name == "K":
            from visfly_tpu_torch.algos import PPO
            from visfly_tpu_torch.envs import MultiNavigationEnv

            env = MultiNavigationEnv(device=dev, **cs.CROSSING)
            profile_ppo("path K", PPO(env, **cs.PPO_TUNED_CROSSING), card, crossing_parts(env))
        elif name == "O":
            work = tempfile.TemporaryDirectory(prefix="visfly_path_o_")
            config, _ = cs.write_o_dataset(work.name)
            for label, grid in (("O1 (decomposed)", False), ("O2 (exact, textured)", True)):
                t0 = time.perf_counter()
                env = cs.o_env(dev, config, grid)
                print(f"path {label} | load of {cs.O_SCENES} scenes: "
                      f"{time.perf_counter() - t0:.2f} s on the host | {card}", flush=True)
                profile(f"path {label}", env, card)
                del env
            work.cleanup()
        elif name == "E":
            profile_bptt("path E", BPTT(cs.hover_grad_env(dev), horizon=32), card)
        elif name == "F":
            for scene, env in (
                    ("primitive scene", cs.visual_grad_env(
                        dev, {"path": "garage_simple_l_medium", "trace_steps": cs.TRACE_STEPS},
                        {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]})),
                    ("mesh, 23040 triangles, merged", cs.visual_grad_env(
                        dev, {"data": garage_env(3).scene},
                        {"mean": [8.0, 0.0, 1.75], "half": [7.0, 3.0, 0.5]}, "merged"))):
                profile_bptt(f"path F ({scene})", BPTT(env, horizon=8,
                                                        policy_kwargs=cs.VISUAL_POLICY), card)
        else:
            profile(f"path {name}", make_env[name](), card)
    mesh_dir.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
