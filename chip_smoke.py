#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``visfly_tpu_torch``).

Drives the port's paths on one CUDA card, through ``Env(...)``,
``env.reset(gen)`` and ``env.step(state, action)``, with actions uniform in
[-0.3, 0.3] and every observation consumed:

- the depth leg of ``bench.py``: ``NavigationEnv``, 256 agents in the
  procedural ``garage_simple_l_medium`` scene, 64×64 depth every step,
  bodyrate control at dt = ctrl_dt = 0.03, 32-step chunks;
- path A, the colour landing: ``LandingEnv``, 256 agents in
  ``garage_landing``, one 64×64 down-facing colour camera rendered twice a
  step (before the reward and after the auto-reset);
- path B, the sensor suite: the depth leg's env with four 64×64 sensors
  (semantic; march depth; un-culled over-relaxed march depth; march depth
  warm-started by an 8×8 cone prepass);
- path C, the physics leg of ``bench.py``: ``HoverEnv``, 200 agents, no
  scene, 8 substeps a control step, 125-step chunks;
- path D, imported meshes: ``NavigationEnv``, 256 agents in a garage OBJ of
  30 boxes (the floor, ceiling, walls and 24 pillars; 360 triangles) loaded
  with ``backend: "grid"``, 64×64 depth from the exact triangles, spawn
  rejection on the baked grid and exact closest-point collisions; once per
  mesh size: 360 triangles (per-triangle lists; with a second 48×48 sensor,
  whose tiles span cameras and take the Möller–Trumbore body), 5,760
  (subdivided twice: cluster lists) and 23,040 (three times: block lists into
  the soup, per-camera signed volumes for the 64×64 sensor and
  Möller–Trumbore for the 48×48 one); and once more at 23,040 triangles with
  three 64×64 depth sensors that differ in ``tri_variant`` only (``merged``,
  ``mx``, ``wl``: the variants of the per-camera tier);
- path E, the gradient leg of ``bench.py``: ``HoverEnv``, 128 agents,
  ``requires_grad=True``, ``BPTT(env, horizon=32)`` with the default actor,
  one warm-up update and 2 timed ones. It uses no kernel;
- path F, visual BPTT: ``NavigationEnv2``, 64 agents, one 64×64 depth sensor,
  ``BPTT(env, horizon=8)`` with a CNN on the depth image, one warm-up and 2
  timed updates, in ``garage_simple_l_medium`` (the analytic kernel forward,
  the implicit-function rule backward) and in the 23,040-triangle garage with
  ``tri_variant: "merged"`` (the merged per-camera kernel forward, the planar
  rule backward). No kernel runs backward;
- path U, the XLA render route (``render_backend: "xla"``, plain PyTorch, no
  kernel): U1 the depth leg's env in its three modes (analytic, the default;
  march with ``render_dtype: "float32"``; march at the default bfloat16),
  each one warm-up and one timed chunk of 32 steps beside the kernel route
  (the depth leg, B1, in the same call), with a render's time, the device's
  busy time in it (``torch.profiler``) and its peak memory; U2 path F's visual BPTT on the XLA
  route in analytic mode, one warm-up and 1 timed update, beside path F's
  kernel route;
- path G, the system's default training run (``python -m visfly_tpu.run -e
  cluttered_flight -a PPO_tuned``): ``NavigationEnv`` with
  ``env_cfgs/cluttered_flight.yaml`` (48 agents, 64×64 depth) and ``PPO`` with
  ``alg_cfgs/cluttered_flight/PPO_tuned.yaml`` (256 steps, 10 epochs of one
  minibatch of 12,288), 1 timed update with no warm-up (the env and its
  kernel are warm from the paths before, and the rollout is 97% of the
  update); the analytic kernel
  renders twice a step (the terminal observation, then the observation after
  the auto-reset);
- paths H and I: ``SHAC`` and ``APG`` with ``alg_cfgs/navigation2/`` on
  ``NavigationEnv2`` (96 agents, the garage for collisions, no camera,
  ``requires_grad``), H = 32, one warm-up and 1 timed update; path J:
  ``SAC`` with ``alg_cfgs/navigation2/SAC.yaml`` (64 agents, buffer 500,000,
  batch 512, 32 gradient steps), collecting until ``learning_starts`` and then
  4 training env steps. These three use no kernel;
- path K, the swarm crossing run (``python -m visfly_tpu.run -e crossing -a
  PPO_tuned``): ``MultiNavigationEnv`` with ``env_cfgs/crossing.yaml`` (24
  scenes × 3 agents, 64×64 depth) and ``PPO`` with
  ``alg_cfgs/crossing/PPO_tuned.yaml`` (256 steps, 5 epochs of one minibatch
  of 18,432), 1 timed update with no warm-up, as path G; the analytic kernel
  renders the
  static scene twice a step and the other drones of each scene compose after
  it as posed quadrotor templates (plain PyTorch);
- path L, dynamic objects: ``DynEnv``, 256 agents in
  ``garage_simple_l_medium``, 64×64 depth and 64×64 colour, with circle and
  polygon objects that enter the analytic kernel's scene as dynamic capsules,
  and again with a drone and a human template beside them, when every object
  composes after the kernel; 2 chunks of 32 steps each;
- path M, the rest of the zoo: ``racing2`` with ``PPO`` (``RacingEnv2``, 64
  agents, its YAML files' recipe; 1 warm-up and 1 timed update),
  ``tracking`` with ``BPTT`` (``TrackEnv``, 64 agents, H = 48; 1 and 1), a
  ``CatchEnv`` rollout of 32 steps, and path C's ``HoverEnv`` with a string
  wind of two fields and ``drag_random`` 0.3 (1 and 1 chunk of 125). No kernel;
- path N, the experiment layer at path G's width: path G's state after its
  timed updates saved, continued one update through ``learn(log_dir=...)``
  (its ``progress.csv`` carries ``train/loss`` and ``time/fps``), and resumed
  in a fresh trainer of another seed, one update held to the continuation;
  ``python -m visfly_tpu_torch.run -t 1 -e cluttered_flight -a PPO_tuned -n
  12288 -c smoke`` in a temporary directory (one update, B1 exactly 1 + 2 ×
  256 launches) and ``-t 0 -w`` on its checkpoint (the 4-agent eval env,
  ``max_steps`` 512, B1 twice a step and once at each of its two resets,
  the trainer's init and the rollout's); the global view
  of the evaluation's last state at 480×640 (``view="top"`` with the
  trajectory, ``view="near"`` with the velocity, collision and axes
  overlays; B1-kid once a frame, its per-tile cull without frustum planes)
  and the crossing env's (24 scenes, scene 0 rendered);
- path O, the scenes users bring: a habitat-format dataset written by the
  smoke in a temporary directory (a GLB stage, ``garage_mesh(3)``: 23,040
  triangles with per-face texcoords and a 1,024×1,024 PNG; four templates of
  768 triangles: two GLBs with red/blue checker PNGs, a GLB of a flat
  ``baseColorFactor``, an OBJ with an MTL ``Kd``; six scene instances of 32
  placements each, translated, turned and scaled uniformly or not, 47,616
  triangles a scene; the dataset config), loaded by ``NavigationEnv`` with
  ``scene_kwargs={"path": <config>}``: 4 scenes × 64 agents, 64×64 depth,
  colour and semantic, dt = ctrl_dt = 0.03, bodyrate; O1 the default
  backend (each scene decomposed, ``max_prims`` 64: B1 once, B1-kid twice a
  render), O2 ``backend: "grid"`` (exact textured triangles with
  per-instance ids: the triangle kernel three times a render); each one
  warm-up chunk and one timed chunk of 32 steps, ``reset_env_by_id(state,
  2)`` after its 10th step and ``reset_scenes`` after its 20th (timed apart:
  the rotation wraps the loader's six files), then ``approaching_point`` for
  every agent and the 480×640 global view of scene 0 with the approaching
  lines; on O2's scene 0 besides: 4 agents with a 64×64 colour camera and
  shadow rays, 4 with a ``render_backend: "grid"`` depth sensor, and 4 in
  ``garage_simple_l_medium`` baked into a grid by ``bake_scenes``;
- path P, the policies users add, over B1 depth in ``garage_simple_l_medium``
  at dt = ctrl_dt = 0.03: P1 path F's env (64 agents, 64×64 depth) with
  ``BPTT(env, horizon=8)`` through a resnet18 backbone (``{"depth":
  {"backbone": "resnet18", "out": 128}, "state": {"mlp": [128, 64]}}``,
  latent (64, 64)) whose weights are a torchvision-layout state dict drawn
  from a seed (random BatchNorm statistics) folded in by ``apply_pretrained``,
  one warm-up and 2 timed updates; and the other eight backbones (resnet34,
  50, 101, mobilenet_s/l, efficientnet_s/m/l, each loaded the same way) on
  256 × 1 × 64 × 64 depth; P2 the depth leg's env with a world model
  (``create_world_model``, deter 128, stoch 32, ``initialize_latent``), one
  warm-up and one timed chunk of 32 steps with and without it, and one
  ``PPO_tuned`` update of path G's env and recipe, cut to 32 steps, with the
  latents attached and ``LatentCombineExtractor``'s keys plus depth; P3 ``collect_depth_frames``
  on the depth leg's env (4,096 frames) and ``train_autoencoder`` (latent 64,
  batch 128, 200 steps); P4 P1's trained actor transplanted into a PPO policy
  of the same ``net_arch`` (``actor_to_policy_params``) and one PPO update of
  32 steps on P1's env; P5 data parallel in separate processes
  (``parallel.run_ranks``, spawned, a ``file://`` store): path E's BPTT update
  (``HoverEnv``, 128 agents, H = 32) and P1's env with path F's CNN (64
  agents, H = 8) on two gloo ranks on the one card and on a world-size-1
  NCCL group, each against one process from the same state and draws;
- path Q, the published results through the port's example scripts
  (``visfly_tpu_torch/examples/``): Q1 ``reproduce.run_row("navigation2")``
  in full at seed 42 (``NavigationEnv2`` at 96 agents, BPTT at H = 32, 162
  updates for 500,000 steps, then ``evaluate`` on the 48-agent eval env;
  no camera, no kernel), in a process of its own started before path E and
  joined after path P; Q2 ``distill_vision --teacher`` on Q1's checkpoint at
  the script's defaults (96 agents, 64×64 depth through B1, 6 DAgger rounds
  of 96 steps, 40 full-batch Adam epochs a round, the teacher and the student
  evaluated on the same visual env); Q3 the ``landing2`` and ``racing2`` rows
  through the same ``run_row`` cut to one update (racing2 with both gate
  replays); Q4 ``train_imported_mesh`` on the 24-pillar garage OBJ cut to
  one update and a 32-step ``TestBase`` evaluation (no camera);
- path R, scale-out for the other trainers (``parallel.run_ranks``), at the
  full width of the repo's YAML files, each leg on two gloo ranks on the one
  card and on a world-size-1 NCCL group against one process from the same
  seed: R1 ``SHAC`` with ``alg_cfgs/cluttered_flight/SHAC.yaml`` on path G's
  env (48 agents, 64×64 depth through B1, H = 32, the CNN), one update; R2
  ``APG`` with ``alg_cfgs/navigation2/APG.yaml`` on paths H-J's env (96
  agents), two updates; R3 ``SAC`` with ``alg_cfgs/navigation2/SAC.yaml``
  (64 agents, ring 500,000, batch 512, 32 gradient steps), two collecting
  env steps (``learning_starts`` cut to 128), a training step cut to one
  gradient step (the one checked), then two training steps of 32, each
  rank's ring bytes beside the one process's; R4 the recurrent policy
  (``PPO_tuned.yaml`` with ``recurrent: true``) on path G's env, ``n_steps``
  cut to 32, one update;
- path S, the debugging and demo scripts, each once through its ``main`` at
  its defaults, files in a temporary directory: S1 ``debug_obs`` (4 agents,
  depth, colour and semantic at 64×64, 40 steps, the PNGs and the 480×640
  top view), S2 ``habitat_dataset_demo`` (the dataset written, 2 decomposed
  scenes × 4 agents at 32×32 depth, a swap, the grid reload of 2 agents),
  S3 ``vision_grad_probe`` (16 agents, H = 16, 64×64 depth, both
  ``grad_collision`` settings);
- path T, the two benchmark scripts through their ``main``: T1 ``fps_test``
  with ``--steps 100 --scenes 4 --mesh`` (200 agents; physics-only hover,
  64×64 depth in one scene and in four, ``DynEnv`` with two moving spheres,
  the garage OBJ decomposed for B1; one warm-up chunk of 50 steps); T2
  ``tri_bench`` at its defaults (the 24-pillar garage subdivided to 5,760,
  23,040 and 92,160 triangles, 256 cameras at 64×64, 20 iterations) with
  ``--check``, then the per-camera kernel on its level-4 plan against its
  plain version with its time and bound; T3 ``tri_bench`` at 92,160
  triangles on 8 cameras with ``--cap 92160 --check``, for the default
  body, ``--variant merged``, ``mx`` and ``wl`` and ``--cluster 64`` and
  ``256``, 3 iterations each.

Phases, one line each; any failure exits non-zero:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: every CUDA kernel of the package and the C++ mesh baker, from the
   sources in the checkout, the compilers side by side;
3. every kernel mode vs its plain PyTorch version on the card at the
   main-path shapes (the reset agents' camera rays of paths A and B, 1 M
   random rays, a scene with 256 dynamic capsules), the culled march and
   the culled analytic modes with the 64-wide cameras' frustum planes on
   camera rays: max |Δt| ≤ 1e-3 m on rays that both hit, hit and
   winning-id disagreeing on ≤ 1e-5 of rays (and whether every output is
   equal); the culled analytic modes also against the un-culled plain
   version and without the frustum planes, the un-culled ones also on
   ragged ray counts, with the share of one-origin tiles and the rows a ray
   tests; the culled march's per-tile row counts equal to the plain cull's
   on every tile of path B's cameras (with and without the dynamic
   capsules); each kernel and plain version timed with CUDA events around
   the call (median of 20; 3 for the plain march), each trace kernel's own
   time on the card beside it (``torch.profiler``, 20 calls);
   then the implicit-function-theorem gradient through the kernel forward
   against the same rule on the plain forward, within 1e-4 relative; the
   triangle kernel in each of its four uses on path D's camera rays at
   1,048,576 (64×64) and 589,824 (48×48) rays against its plain version (same
   limits, ids compared on hits), against the brute force on 8 cameras with
   lists that hold the whole mesh (ids compared where the two winners are
   not tied), its gradient, and its time apart from the prepass's; B4's tile
   kernel (``csrc/tri_tile.cu``) at 360 triangles (both bodies) and 5,760
   against the cluster walk it replaced at k = 1 and at the k that walk would
   pick (t and hit to the bit, ids where the ray hits), the plain version on
   the lists with the slots past each tile's count emptied equal to it on
   the full lists, and the device time of the three (``device_ms``) beside
   the bound, the tile kernel no slower than the faster walk; at 360
   triangles besides on a synthetic ragged list set cut from each sensor's
   lists (tiles of 0, 64, 65, 256 and 1 real slots in turn) against its plain
   version (same limits), the same lists with the counts derived from the
   ids, and the cluster walk as above; at 23,040
   triangles the soup (B5) and per-camera (B6) tiers at the split k the
   wrapper picks (a tile's stages over a cluster of k blocks) against k = 1
   (same limits), the time at both, the stages executed a tile summed over
   its blocks and the blocks an SM of the occupancy query; the three
   variants of the per-camera tier at 23,040 triangles against their plain
   versions, against ``"scalar"`` and against the brute force (same limits;
   the worklist at its default budget held to "no nearer hit"); the merged (B7a)
   and worklist (B7c) tiers through the list walk (``csrc/tri_tile.cu``)
   against the cluster walk they replaced at k = 1 and at the k it would
   pick, in index order as before and in the lists' longest-first order (t
   and hit to the bit, ids where the ray hits), with the device time of each
   beside the bound, on path D's lists, on synthetic ragged ones (block
   lists cut to 0-45 blocks a tile, the worklist at a budget for every
   stage) and on path D's first 8 cameras (32 tiles: the walk splits each
   tile's stages over 8 blocks), those also against their plain versions;
   the matrix
   form on the tensor cores besides against its TF32 split's model, on rays
   through the midpoints of the mesh's flat shared edges (hit flags equal to
   the plain version's, no ray past 1e-3 m of it) and on the mesh twice over
   (every id equal to the plain version's), with its device time, its SASS
   (TF32 tensor instructions), registers and the floor of its design; the
   two diagnostics on the list walk (B8a, B8b: template flags of B7a's
   kernel): the stages executed per tile over the soup's 48×48 lists and the
   per-camera lists against the plain count at 512 rays a block, exactly,
   t and hit against the cluster walk at k = 1 to the bit; the four
   knock-out combinations against their plain results and the cluster walk
   at k = 1; each walk's device time, and the split of the merged kernel's
   time that the list walk's knock-outs give;
4. each path: reset, 1 warm-up chunk, timed chunks; every render must have
   launched exactly its kernel mode, outputs finite and in range; the two
   diagnostics through their library functions; paths E and F: loss and
   gradient norm finite, gradient norm > 0, the carried state detached after
   an update, launches equal to the renders; paths G-J: the same, and every
   trained parameter moved and every tensor of the state on the card; path G's
   and path K's analytic launches exactly 2 × 256 an update; path L's analytic
   and id kernels once a render each; path M launches nothing; path U's XLA
   route launches nothing (the depth leg, B1, is the kernel route beside it), U2's
   loss finite, norm > 0 and every trained parameter moved;
5. one step from the same state on the card and on the CPU plain path, for
   the depth leg and path D at 360 triangles (depth within 1e-3 m on all but
   ≤ 1e-5 of pixels) and for path A (colour equal on all but ≤ 1e-4 of
   pixels, pad centre within 1e-3); state obs within 1e-4; one BPTT rollout
   of path E at 8 agents, H = 4, from the same parameters, state and noise on
   the card and on the CPU: loss within 1e-5, every parameter's gradient
   within 1e-4 of its largest entry; one PPO update of path G's env and recipe
   at 8 agents, 4 steps, 2 epochs of 2 minibatches, from the same parameters,
   state, noise and permutations on the card and on the CPU: loss within
   1e-5, the first minibatch's gradient within 1e-4 of each parameter's
   largest gradient entry, every parameter after the update within 1e-4 in
   the l2 norm (its elementwise difference printed beside it); two agents of
   path K's swarm 1.2 m apart in ``box15_wall_empty``, agent 0 facing agent 1,
   rendered on the card and on the CPU (depth within 1e-3 m on all but ≤ 1e-5
   of pixels, a silhouette wider than tall on both); one step of path L's two
   envs at 32 agents from the same state (depth as above, colour equal on all
   but ≤ 1e-4); sensor noise drawn from the env's CUDA generator (replayed
   from its state): Gaussian depth noise's mean within 1e-3 m and standard
   deviation within 5% of the model's on the depth leg's camera, Redwood
   depth noise unbiased within 1% on flat pixels, salt and pepper within 5%
   of the model's shares on path A's camera, and every model on constant
   images within tests/test_scene_render.py's limits; path U1's float32
   modes rendered from the same state at 2 agents on the card and on the CPU
   (depth as above), its bfloat16 march card vs CPU (p99 |Δ| ≤ 3 cm, hits
   differing on ≤ 2 pixels a 1,024, and each device's p99 against a float32
   256-step trace of the same rays within 1 cm of the other's; the p99 at
   256 agents printed beside the JAX docstring's 3 cm, which neither package
   holds in this scene), and the analytic route against B1 on the depth
   leg's 1,048,576 rays (|Δt| ≤ 1e-3 m where both hit, on all but ≤ 1e-5 of
   rays, the hit flags' differences counted among them); path N's resume
   against the continuation (loss within 1e-5, every parameter within 1e-4
   relative in the l2 norm, generator states and ``AdamChain.count`` equal,
   whether the whole state is bitwise equal printed with its largest
   elementwise difference), the load's report of the env fields it kept, and
   each global view against the same render from CPU copies (colour equal on
   all but ≤ 1e-4 of pixels) with B1-kid at the view's rays against its plain
   version (phase 3's limits) and timed, beside path A's; path O: the scenes
   the loader's order gives at the build, the swap and the rotation, the swap
   keeping scenes 0, 1 and 3's rows (O1) or grids, triangles and texture
   tables (O2) bit for bit and moving only scene 2's agents, each kernel
   exactly once a render of each sensor that uses it, the approaching points
   card vs CPU within 1e-3 m, one step at 2 agents a scene card vs CPU
   (depth, colour and semantic as above), on O2 both checker colours on the
   textured objects and the id of every instance seen on 16 or more pixels
   in the semantic image with the stage's id 1, B1, B1-kid and the triangle
   kernel at path O's rays against their plain versions (phase 3's limits)
   and timed, with the tier the triangle kernel took; the shadowed colour no
   brighter than the unshadowed anywhere and darker somewhere, card vs CPU on
   one camera; the grid renders card vs CPU; no kernel in a grid render;
   path P: B1 exactly once a render on P1-P5 (1 + 8 a P1 update, 1 + 2 a
   step of P2's PPO and P4's, 1 + 16 collecting P3's frames, on each rank of
   P5's visual leg); path Q: Q1 meets ``reproduce.py``'s own bar for the
   row (eval success ≥ 0.57 − 0.12), after exactly 162 updates, every
   trained parameter moved and the state on the card, with no launch; Q2 B1
   exactly 1 + 6 × 96 + (1 + n) for each evaluation of n steps, the last
   round's regression loss below the first round's, the student's success
   at least the teacher's − 0.15; Q3 a finite loss, every trained parameter
   moved, success in [0, 1] (landing2) and gates in [0, 4] (racing2), no
   launch; Q4 the same, a checkpoint written, no launch; P1 every trained
   parameter moved, the actor's forward
   and its first gradient (8 agents, H = 4, same parameters, state and noise;
   every parameter's gradient non-zero) card vs CPU within 1e-4 relative, each of the nine backbones card vs CPU
   on 8 images within atol 2e-4 + rtol 1e-3; P2 the latents card vs CPU
   after one deterministic posterior step within 1e-4, the done agents'
   latents zeroed before their update (bitwise, replayed from the env's
   generator), ``decode`` of the state's shape, the PPO update as path G's;
   P3 the MSE of the last 20 steps below the first 20's, one Adam step card
   vs CPU with deterministic cuDNN (loss within 1e-5, parameters 1e-4 in the
   l2 norm); P4 the policy's mean equal to the actor's pre-tanh mean bitwise,
   ``mlp_vf`` and ``value`` moved; P5 each rank's loss within 1e-5 relative
   of one process's, parameters within 1e-4 in the l2 norm and equal on
   every rank, positions within 1e-5; path R the same (the loss within 1e-5
   relative plus 1e-6, as tests/test_torch_parallel.py holds PPO's metrics:
   R4's PPO loss is a difference of terms of order 1; R3 after its first
   training step, of one gradient step: Adam and the bootstrapped targets
   grow the rounding of the sharded sums at every gradient step, so after
   the 64 more the loss and parameters are printed beside one process's and
   the ranks held equal), B1 exactly once a
   render on each rank (R1 1 + 32, R4 1 + 2 × 32, none on R2 and R3), every
   tensor of each state on the card, each rank's ring on R3 at most 51% of
   the one process's; path S: S1 B1 1 + 40 + 1 and B1-kid 2 × (1 + 40 + 1)
   + 1 (the view), seven files written; S2 B1 once (the reset), the
   triangle kernel once (the grid reload), the swap changing a scene of the
   same shape; S3 B1 2 × (1 + 16), every norm finite, the total's positive,
   the detached query's ``col_dis`` gradient zero; path T: T1 B1 exactly
   1 + 50 + 100 on each of the four visual envs (one render at the reset
   and one a step) and nothing on the physics-only one, five finite rates
   above 0; T2 ``tri_trace_tile_sv`` at level 2 and ``tri_trace_camsoup``
   at levels 3 and 4, each 2 × (1 + 20) + 1 launches a level (the frame
   batch and the kernel alone once a call, the check once), on 8 cameras
   at the default cap the rays of the tiles within the cap within
   ``agree``'s limits of the brute force (the rest, where a tile dropped
   its farthest blocks and a ray may see what lies behind them, printed), the
   kernel at 92,160 triangles against its plain version with ``agree``'s
   limits; T3 each run within ``agree``'s limits of the brute force (ids
   where not tied), the two block sizes also of the default one, and
   exactly 2 × (1 + 3) + 1 launches of its own kernel each.

The line before the last is a JSON object with each kernel's route, source,
launches in phase 4, error, times and bound; the last line is
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py
"""
import contextlib
import csv
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

REPO = os.path.dirname(os.path.abspath(__file__))
N_AGENTS = 256
RES = (64, 64)
CHUNK = 32
MAX_DEPTH = 20.0
TRACE_STEPS = 40
T_TOL = 1e-3  # m; grazing rays amplify rounding in the slab divisions
HIT_TOL = 1e-5  # share of rays whose hit flag or id may differ (grazing rays)
# the synthetic B4 lists' real slots, tile by tile in turn: an empty tile, a
# count on a stage boundary, one a slot past it, a tile at the 360-triangle
# mesh's cap, one triangle
RAGGED_COUNTS = (0, 64, 65, 256, 1)
# the synthetic B7a lists' blocks, tile by tile in turn (at most the tile's own)
RAGGED_BLOCKS = (0, 45, 1, 12, 3, 30, 7, 45, 2, 20)
OBS_TOL = 1e-4
GRAD_TOL = 1e-4  # relative
COLOR_TOL = 1e-4  # share of pixels: a silhouette pixel flips a whole uint8 triple
# the card's peaks the bounds are held against (H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12  # dense, on the tensor cores
# float32 operations of one row, a division or square root counted as the
# 8-instruction sequence it compiles to, a minimum or maximum as 1, everything
# else as 1 but comparisons, selects and sign or magnitude modifiers. A
# capsule's distance needs its axis ba and 1/(ba·ba + 1e-9) (17 operations):
# row constants, "cap_row", which a kernel forms once a row a tile, not at
# every evaluation ("cap_sdf": the other 32). The closed-form first hit splits
# the same way, and further at the ray's origin: "*_origin" are the terms of
# the origin alone, which a tile whose rays share one origin needs once a row
# (box: rotated origin 9, slab numerators 6; sphere: rotated origin 9, cs 7;
# capsule: the inside test 32, oa, ba·oa, |oa|², Cq, |oa|² − r², o − b and its
# cc 31), "*_ray" the rest, per ray (box: rotated direction 6, three slabs
# of two divisions, a minimum and a maximum 54, entry and exit 4, clamp 1;
# sphere: rotated direction 6, b 5, discriminant 2, its root 9, tin and tout
# 2; capsule: ba·d and oa·d 10, the cylinder's quadratic, root and division
# 29, two end spheres 13 and 18), each with the minimum over rows (1); a
# box's h + r (3) is a row constant. "box_hit" and "cap_hit" are the old
# yardstick, every term of every active row per ray.
OPS = {"box_hit": 100, "cap_hit": 185, "box_sdf": 41, "cap_sdf": 32, "cap_row": 17,
       "box_row": 3, "box_origin": 15, "box_ray": 66, "sphere_origin": 16, "sphere_ray": 25,
       "cap_origin": 63, "cap_ray": 71}
# float32 arithmetic of one ray-triangle test, in three parts: what every
# test against a triangle needs to reach its first gate, what a test past that
# gate needs to reach its division, and what only a test that divides needs.
# Signed volumes: three dot products and the three sign products (18), then
# the sum, one division (counted as 8) and one product (11); the sign test is
# the gate of the division. Moeller-Trumbore: a cross and a dot product up to
# |det| (14); then a difference, a cross product, two dot products and the
# two products of the sign test of u and v (24); then one division, three
# products, a dot product and a sum (17).
# Comparisons and selects are left out, as are a stage's empty slots.
# The matrix form (B7b, "mx") computes the same function with its products on
# the tensor cores in TF32, each factor split in two and three of the four
# products kept, the counterpart of the TPU kernel's Precision.HIGHEST: on a
# real triangle three passes of the three volumes' 9 multiply-adds (54 TF32
# flops a test, TRI_TC_FLOPS) at the TF32 tensor rate, and on the CUDA cores
# the three sign products of the gate (3) and the sum, division and product of
# those that divide (11). The bound is the larger of the two pipes' times (and
# the bytes); "sv_cam" on the CUDA cores, the yardstick before the kernel moved
# to the tensor cores, is printed beside it.
TRI_OPS = {"sv_tile": (18, 0, 11), "sv_cam": (18, 0, 11), "mt": (14, 24, 17), "mx": (3, 0, 11)}
TRI_TC_FLOPS = {"mx": 54}
# The floor of the matrix form's own design: every staged slot, padding
# included, on the tensor cores as products of depth 8 + 8 over three columns
# (96 TF32 flops a test), the gate as in the bound.
MX_TC_FLOPS = 96
# path D: subdivision level -> (triangles, the sensors' (uuid, resolution), the
# kernel use each sensor must launch once per render)
MESH_SENSORS = {"depth": (64, 64), "depth48": (48, 48)}
# path D with the variants of the per-camera tier, at 23,040 triangles: sensor
# -> (tri_variant, the kernel use it must launch once per render)
VARIANT_SENSORS = {"depth": ("merged", "tri_trace_camsoup_merged"),
                   "depth_mx": ("mx", "tri_trace_camsoup_mx"),
                   "depth_wl": ("wl", "tri_trace_worklist")}
# path F's policy (tests/test_pallas_kernel.py's visual BPTT, at 64 agents)
VISUAL_POLICY = {"net_arch": {"depth": {"cnn": 32}, "state": {"mlp": [32]},
                              "collision_vector": {"mlp": [16]}},
                 "latent_dim": (32,)}
# path G, the system's default training run (``python -m visfly_tpu.run -e
# cluttered_flight -a PPO_tuned``): the env section of
# visfly_tpu/exps/env_cfgs/cluttered_flight.yaml and the algorithm section of
# visfly_tpu/exps/alg_cfgs/cluttered_flight/PPO_tuned.yaml, written out here
# because the card's machine has no YAML reader (tests/test_torch_ppo.py holds
# them equal to the files)
CLUTTERED_FLIGHT = {
    "num_agent_per_scene": 48,
    "random_kwargs": {"state_generator": {"class": "Uniform", "kwargs": [
        {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 2.0, 1.0]}}]}},
    "visual": True,
    "max_episode_steps": 256,
    "scene_kwargs": {"path": "garage_simple_l_medium", "trace_steps": 32},
    "dynamics_kwargs": {"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate",
                        "ctrl_delay": True},
    "sensor_kwargs": [{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}],
}
PPO_TUNED = {
    "learning_rate": 3.0e-4, "n_steps": 256, "batch_size": 25600, "n_epochs": 10,
    "gamma": 0.99, "gae_lambda": 0.95, "clip_range": 0.2, "ent_coef": 0.003, "vf_coef": 0.5,
    "max_grad_norm": 0.5, "weight_decay": 1.0e-5,
    "policy_kwargs": {"pi_layers": [64, 64], "vf_layers": [64, 64], "net_arch": {
        "depth": {"cnn": 128}, "state": {"mlp": [128, 64]}, "target": {"mlp": [128, 64]}}},
}
# path K, the swarm crossing run (``python -m visfly_tpu.run -e crossing -a
# PPO_tuned``): the env section of visfly_tpu/exps/env_cfgs/crossing.yaml and
# the algorithm section of visfly_tpu/exps/alg_cfgs/crossing/PPO_tuned.yaml
# (tests/test_torch_multi.py holds them equal to the files)
CROSSING = {
    "num_agent_per_scene": 3,
    "num_scene": 24,
    "random_kwargs": {"state_generator": {"class": "Uniform", "kwargs": [
        {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 2.0, 1.0]}}]}},
    "visual": True,
    "max_episode_steps": 256,
    "scene_kwargs": {"path": "garage_crossing", "trace_steps": 32},
    "dynamics_kwargs": {"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate",
                        "ctrl_delay": True},
    "sensor_kwargs": [{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}],
}
PPO_TUNED_CROSSING = {
    "learning_rate": 3.0e-4, "n_steps": 256, "batch_size": 18432, "n_epochs": 5,
    "gamma": 0.99, "gae_lambda": 0.95, "clip_range": 0.2, "ent_coef": 0.003, "vf_coef": 0.5,
    "max_grad_norm": 0.5, "weight_decay": 1.0e-5,
    "policy_kwargs": {"pi_layers": [64, 64], "vf_layers": [64, 64], "net_arch": {
        "depth": {"cnn": 128}, "state": {"mlp": [128, 64]}, "target": {"mlp": [128, 64]},
        "swarm": {"mlp": [128, 64]}}},
}
# path M: racing2 with PPO (visfly_tpu/exps/env_cfgs/racing2.yaml,
# alg_cfgs/racing2/PPO.yaml) and tracking with BPTT (env_cfgs/tracking.yaml,
# alg_cfgs/tracking/BPTT.yaml and its env override); tests/test_torch_zoo.py
# holds them equal to the files
RACING2 = {"num_agent_per_scene": 64, "visual": False, "max_episode_steps": 256,
           "dynamics_kwargs": {"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"}}
PPO_RACING2 = {
    "learning_rate": {"class": "linear", "kwargs": {"initial": 3.0e-4, "final": 0.0,
                                                    "total_steps": 7320}},
    "n_steps": 256, "batch_size": 16384, "n_epochs": 10,
    "policy_kwargs": {"pi_layers": [128, 128], "vf_layers": [128, 128]},
}
TRACKING = {"num_agent_per_scene": 64, "visual": False, "max_episode_steps": 256,
            "dynamics_kwargs": {"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"}}
TRACKING_BPTT_ENV = {"requires_grad": True}
BPTT_TRACKING = {"horizon": 48, "learning_rate": 1.0e-3,
                 "policy_kwargs": {"latent_dim": [128, 128]}}
# paths H-J: ``NavigationEnv2`` as visfly_tpu/exps/env_cfgs/navigation2.yaml
# configured it when commit a75efc1 added it (the file has left the tree since;
# the algorithm files below remain): the garage for the collision queries and
# the spawn rejection, no camera
NAVIGATION2 = {
    "num_agent_per_scene": 96, "visual": True, "requires_grad": True,
    "max_episode_steps": 256, "scene_kwargs": {"path": "garage_simple_l_medium"},
    "dynamics_kwargs": {"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate",
                        "ctrl_delay": True},
}
# the algorithm sections of visfly_tpu/exps/alg_cfgs/navigation2/{SHAC,APG,SAC}.yaml,
# and SAC.yaml's env section
SHAC_NAV2 = {"horizon": 32, "learning_rate": 1.0e-3, "policy_kwargs": {"latent_dim": [128, 128]}}
APG_NAV2 = {"horizon": 32, "learning_rate": 1.0e-3, "policy_kwargs": {"latent_dim": [128, 128]}}
SAC_NAV2_ENV = {"requires_grad": False, "num_agent_per_scene": 64}
SAC_NAV2 = {"learning_rate": 3.0e-4, "buffer_size": 500000, "batch_size": 512,
            "gradient_steps": 32, "learning_starts": 10000, "tau": 0.005, "gamma": 0.99,
            "policy_kwargs": {"latent_dim": [128, 128]}}
# path R1: the algorithm and env sections of
# visfly_tpu/exps/alg_cfgs/cluttered_flight/SHAC.yaml on path G's env
# (tests/test_torch_parallel_trainers.py holds them equal to the file)
SHAC_CLUTTERED_ENV = {"requires_grad": True}
SHAC_CLUTTERED = {"horizon": 32, "learning_rate": 1.0e-3, "policy_kwargs": {
    "latent_dim": [128, 128], "net_arch": {"depth": {"cnn": 128}, "state": {"mlp": [128, 64]},
                                           "target": {"mlp": [64]}}}}
# path R: leg → (the renders B1 makes on a rank, the data-parallel run's cuts)
R_LEGS = {"R1": 1 + 32, "R2": 0, "R3": 0, "R4": 1 + 2 * 32}
R_SAC_COLLECT = 2  # collecting steps before R3's training steps (learning_starts 128)
PATH_D = {
    0: (360, {"depth": "tri_trace_tile_sv", "depth48": "tri_trace_tile_mt"}),
    2: (5760, {"depth": "tri_trace_tile_sv"}),
    3: (23040, {"depth": "tri_trace_camsoup", "depth48": "tri_trace_soup"}),
}
SUITE = [
    {"uuid": "semantic", "sensor_type": "semantic"},
    {"uuid": "depth_march", "sensor_type": "depth", "trace_mode": "march"},
    {"uuid": "depth_nocull", "sensor_type": "depth", "trace_mode": "march", "cull": False,
     "march_omega": 1.5},
    {"uuid": "depth_tile", "sensor_type": "depth", "trace_mode": "march", "tile": 8},
]
# the kernel mode each sensor of path B must launch, once per render
SUITE_MODES = {"semantic": "trace_analytic_kid", "depth_march": "trace_march",
               "depth_nocull": "trace_march_nocull", "depth_tile": "trace_march_packed"}
# the CUDA function each trace mode launches, as the profiler names it
# (``chip_profile.py``)
KERNEL_NAMES = {"trace_analytic": "trace_analytic_kernel<false",
                "trace_analytic_kid": "trace_analytic_kernel<true",
                "trace_march": "trace_march_kernel", "trace_march_nocull": "trace_march_kernel",
                "trace_march_packed": "trace_march_kernel"}
KERNELS = {
    "trace_analytic": ("visfly_tpu_torch/csrc/trace_analytic.cu",
                       "visfly_tpu/render/pallas_trace.py:385"),
    "trace_analytic_kid": ("visfly_tpu_torch/csrc/trace_analytic.cu",
                           "visfly_tpu/render/pallas_trace.py:328"),
    "trace_march": ("visfly_tpu_torch/csrc/trace_march.cu",
                    "visfly_tpu/render/pallas_trace.py:108"),
    "trace_march_nocull": ("visfly_tpu_torch/csrc/trace_march.cu",
                           "visfly_tpu/render/pallas_trace.py:618"),
    "trace_march_packed": ("visfly_tpu_torch/csrc/trace_march.cu",
                           "visfly_tpu/render/pallas_trace.py:93"),
    "tri_trace_tile_sv": ("visfly_tpu_torch/csrc/tri_tile.cu",
                          "visfly_tpu/render/tri_trace.py:553"),
    "tri_trace_tile_mt": ("visfly_tpu_torch/csrc/tri_tile.cu",
                          "visfly_tpu/render/tri_trace.py:553"),
    "tri_trace_soup": ("visfly_tpu_torch/csrc/tri_trace.cu",
                       "visfly_tpu/render/tri_trace.py:809"),
    "tri_trace_camsoup": ("visfly_tpu_torch/csrc/tri_trace.cu",
                          "visfly_tpu/render/tri_trace.py:942"),
    "tri_trace_camsoup_merged": ("visfly_tpu_torch/csrc/tri_tile.cu",
                                 "visfly_tpu/render/tri_trace.py:999"),
    "tri_trace_camsoup_mx": ("visfly_tpu_torch/csrc/tri_trace.cu",
                             "visfly_tpu/render/tri_trace.py:1274"),
    "tri_trace_worklist": ("visfly_tpu_torch/csrc/tri_tile.cu",
                           "visfly_tpu/render/tri_trace.py:1454"),
    "tri_trace_probe": ("visfly_tpu_torch/csrc/tri_tile.cu", "examples/_tri_probe.py:30"),
    "tri_trace_knockout": ("visfly_tpu_torch/csrc/tri_tile.cu",
                           "examples/_tri_kernel_exp.py:39"),
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def bench_env(device, sensors=None, n=N_AGENTS, res=RES):
    """The depth leg's env; ``sensors`` replaces its one depth camera."""
    from visfly_tpu_torch.envs import NavigationEnv

    sensors = sensors or [{"uuid": "depth", "sensor_type": "depth"}]
    return NavigationEnv(
        num_agent_per_scene=n,
        visual=True,
        scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": TRACE_STEPS},
        sensor_kwargs=[dict(s, resolution=list(res)) for s in sensors],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        max_episode_steps=256,
        device=device,
    )


def landing_env(device, n=N_AGENTS):
    from visfly_tpu_torch.envs import LandingEnv

    return LandingEnv(num_agent_per_scene=n, device=device)


def hover_env(device, n=200):
    from visfly_tpu_torch.envs import HoverEnv

    return HoverEnv(num_agent_per_scene=n, visual=False, max_episode_steps=500, device=device,
                    dynamics_kwargs={"dt": 0.0025, "ctrl_dt": 0.02, "action_type": "bodyrate"})


def garage_mesh(levels, n_pillars=24, seed=0):
    """The garage of ``examples/mesh_assets.py::make_garage_obj``: a 16×8×3.5 m
    interior of six slabs and ``n_pillars`` square pillars, 12 triangles a
    box, each triangle split 1:4 at its edge midpoints ``levels`` times →
    (verts (V, 3), faces (F, 3))."""
    import numpy as np

    corners = np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                         np.float32)
    box_faces = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                            [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                           np.int32)
    boxes = [([8, 0, -0.25], [9, 5, 0.25]), ([8, 0, 3.75], [9, 5, 0.25]),
             ([-0.75, 0, 1.75], [0.25, 5, 2]), ([16.75, 0, 1.75], [0.25, 5, 2]),
             ([8, -4.75, 1.75], [9, 0.25, 2]), ([8, 4.75, 1.75], [9, 0.25, 2])]
    rng = np.random.RandomState(seed)
    for i in range(n_pillars):
        boxes.append(([2.0 + 12.0 * (i / max(n_pillars - 1, 1)), rng.uniform(-3, 3), 1.75],
                      [0.3, 0.3, 1.75]))
    v = np.concatenate([corners * np.asarray(h, np.float32) + np.asarray(c, np.float32)
                        for c, h in boxes])
    f = np.concatenate([box_faces + 8 * i for i in range(len(boxes))])
    for _ in range(levels):
        a, b, c = (v[f[:, k]] for k in range(3))
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        v = np.concatenate([np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
                            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)]).reshape(-1, 3)
        f = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    return v.astype(np.float32), f


def write_obj(path, verts, faces):
    with open(path, "w") as fo:
        for p in verts.tolist():  # repr of a float32's value reads back exactly
            fo.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for t in faces.tolist():
            fo.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
    return path


def mesh_sensor(uuid, variants=False):
    """Path D's sensor spec: by resolution, or, of the variants' env, 64×64
    with its ``tri_variant``."""
    if variants:
        return {"uuid": uuid, "sensor_type": "depth", "resolution": list(RES),
                "tri_variant": VARIANT_SENSORS[uuid][0]}
    return {"uuid": uuid, "sensor_type": "depth", "resolution": list(MESH_SENSORS[uuid])}


def mesh_env(device, scene_kwargs, sensors, n=N_AGENTS, variants=False):
    """Path D's env: agents spawn all over the garage, at least 1 m from
    every surface of the baked grid."""
    from visfly_tpu_torch.envs import NavigationEnv

    return NavigationEnv(
        num_agent_per_scene=n,
        visual=True,
        scene_kwargs=scene_kwargs,
        sensor_kwargs=[mesh_sensor(u, variants) for u in sensors],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [8.0, 0.0, 1.75], "half": [7.0, 3.0, 0.5]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        max_episode_steps=256,
        device=device,
    )


def hover_grad_env(device, n=128):
    """Path E's env: the BPTT leg of ``bench.py``."""
    from visfly_tpu_torch.envs import HoverEnv

    return HoverEnv(num_agent_per_scene=n, visual=False, requires_grad=True,
                    dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=256,
                    device=device)


def visual_grad_env(device, scene_kwargs, spawn, variant=None, n=64, extra=None):
    """Path F's env: one 64×64 depth camera an agent, differentiable;
    ``extra`` adds sensor-spec keys."""
    from visfly_tpu_torch.envs import NavigationEnv2

    sensor = dict({"uuid": "depth", "sensor_type": "depth", "resolution": list(RES)},
                  **(extra or {}))
    if variant is not None:
        sensor["tri_variant"] = variant
    return NavigationEnv2(
        num_agent_per_scene=n, visual=True, requires_grad=True, scene_kwargs=scene_kwargs,
        sensor_kwargs=[sensor],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [{"position": spawn}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=256, device=device)


def tensors_of(x):
    """Every tensor of a nested NamedTuple, tuple or dict."""
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from tensors_of(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from tensors_of(v)


def drive_bptt(trainer, seed, n_updates, expect):
    """``init``, one warm-up update, ``n_updates`` timed ones.
    ``expect(steps)`` → {mode: launches} of the whole run, the reset's render
    and the warm-up included; modes it leaves out must not launch. Returns
    (ms an update, agent steps/s, launches by mode, the last metrics)."""
    import torch

    env = trainer.env
    reset_launches()
    st = trainer.init(torch.Generator(device=env.device).manual_seed(seed))
    st, m = trainer.update(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_updates):
        st, m = trainer.update(st)
        for k in ("actor_loss", "grad_norm"):
            check(bool(torch.isfinite(m[k])), f"{k} is not finite")
        check(float(m["grad_norm"]) > 0, "the gradient is zero")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    want = {k: 0 for k in launches}
    want.update(expect(trainer.H * (n_updates + 1)))
    check(launches == want, f"kernel launches {launches} != expected {want}")
    carried = list(tensors_of(st.env_state)) + list(tensors_of(st.obs))
    check(len(carried) > 20 and not any(t.requires_grad or t.grad_fn is not None
                                        for t in carried),
          "the carried state still holds a graph after the update")
    check(st.global_step == trainer.H * env.num_envs * (n_updates + 1), "global_step")
    return dt / n_updates * 1e3, trainer.H * env.num_envs * n_updates / dt, launches, m


def bptt_card_vs_cpu(dev):
    """One H = 4 rollout of path E at 8 agents from the same parameters, state
    and noise on the card and on the CPU → (|Δloss|, the largest gradient
    difference relative to its parameter's largest gradient entry)."""
    import torch

    from visfly_tpu_torch.algos import BPTT

    out = {}
    tr = BPTT(hover_grad_env(dev, 8), horizon=4)
    st = tr.init()
    noise = torch.randn((4, 8, 4), generator=torch.Generator().manual_seed(7))
    tr_cpu = BPTT(hover_grad_env("cpu", 8), horizon=4)
    tr_cpu.build({k: v.cpu() for k, v in st.obs.items()})  # the same seed: the same policy
    for name, t, state, obs, eps in (
            ("card", tr, st.env_state, st.obs, noise.to(dev)),
            ("cpu", tr_cpu, to_device(st.env_state, "cpu", torch.Generator().manual_seed(0)),
             {k: v.cpu() for k, v in st.obs.items()}, noise)):
        loss, (_, _, _, metrics) = t._rollout_loss(state, obs, None, (), eps)
        loss.backward()
        check(not bool(metrics[1].any()), f"{name}: an agent was done within the horizon")
        out[name] = (float(loss.detach()), {n: p.grad.cpu() for n, p in
                                            t.actor.named_parameters()})
    for (n_a, p_a), (n_b, p_b) in zip(tr.actor.named_parameters(),
                                      tr_cpu.actor.named_parameters()):
        check(n_a == n_b and torch.equal(p_a.detach().cpu(), p_b.detach()),
              f"parameter {n_a} differs between the devices")
    rel = max(float((g - out["cpu"][1][n]).abs().max() / out["cpu"][1][n].abs().max())
              for n, g in out["card"][1].items())
    return abs(out["card"][0] - out["cpu"][0]), rel


def timed_parts(trainer, names):
    """Wrap the trainer's methods ``names`` to add their host-clocked,
    synchronised seconds to the returned dict (the update's parts)."""
    import torch

    spent = {n: 0.0 for n in names}
    for n in names:
        def wrapped(*args, _fn=getattr(trainer, n), _n=n, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[_n] += time.perf_counter() - t0
            return out
        setattr(trainer, n, wrapped)
    return spent


def trained_modules(trainer):
    """The modules a trainer optimises, by name."""
    return {n: getattr(trainer, n) for n in ("policy", "actor", "critic")
            if getattr(trainer, n, None) is not None}


def snapshot(trainer):
    return {f"{m}.{n}": p.detach().clone() for m, mod in trained_modules(trainer).items()
            for n, p in mod.named_parameters()}


def check_trained(name, trainer, st, m, before, loss_key, dev, still=()):
    """A trainer's state after timed updates: loss and gradient norm finite,
    the norm > 0, every parameter moved (but those in ``still``), the carried
    state detached and every tensor of it on the card."""
    import torch

    for k in (loss_key, "grad_norm"):
        check(bool(torch.isfinite(m[k])), f"{name}: {k} is not finite")
    check(float(m["grad_norm"]) > 0, f"{name}: the gradient is zero")
    after = snapshot(trainer)
    frozen = [k for k in after if torch.equal(after[k], before[k]) and k not in still]
    check(not frozen, f"{name}: parameters did not move: {frozen}")
    carried = list(tensors_of(st.env_state)) + list(tensors_of(st.obs))
    check(len(carried) > 20 and not any(t.requires_grad or t.grad_fn is not None
                                        for t in carried),
          f"{name}: the carried state still holds a graph after the update")
    off = [t.device for t in tensors_of(tuple(st)) if t.device != dev]
    check(not off, f"{name}: state tensors off the card: {off[:3]}")


def ppo_card_vs_cpu(dev):
    """One PPO update of path G's env and recipe at 8 agents, n_steps 4, 2
    epochs of 2 minibatches, from the same parameters, state, action noise
    and permutations on the card and on the CPU → (|Δloss|, the largest
    difference of the first minibatch's gradient relative to its parameter's
    largest gradient entry, the largest parameter difference after the update
    in the l2 norm relative to the parameter's norm, and elementwise relative
    to the parameter's largest entry with the count of elements past 1e-4 of
    it). Adam's step lr·g/(|g| + 1e-8) turns a 1e-9 difference in a gradient
    entry of 1e-9 into a move of 0.1 lr, so the elementwise difference of the
    parameters is printed, and the gradient and the l2 norm are held."""
    import torch

    from visfly_tpu_torch.algos import PPO
    from visfly_tpu_torch.algos.ppo import init_episode_stats
    from visfly_tpu_torch.envs import NavigationEnv

    kw = dict(PPO_TUNED, n_steps=4, n_epochs=2, batch_size=16)
    env_kw = dict(CLUTTERED_FLIGHT, num_agent_per_scene=8)
    tr = PPO(NavigationEnv(device=dev, **env_kw), **kw)
    st = tr.init()
    tr_cpu = PPO(NavigationEnv(device="cpu", **env_kw), **kw)
    tr_cpu.build({k: v.cpu() for k, v in st.obs.items()})  # the same seed: the same policy
    st_cpu = tr_cpu._state(to_device(st.env_state, "cpu", torch.Generator().manual_seed(0)),
                           {k: v.cpu() for k, v in st.obs.items()}, None, 0,
                           init_episode_stats("cpu"), ())
    noise = torch.randn((4, 8, 4), generator=torch.Generator().manual_seed(7))
    perms = torch.stack([torch.randperm(32, generator=torch.Generator().manual_seed(8 + e))
                         for e in range(2)])
    grads = []
    for t in (tr, tr_cpu):  # the gradient of the first minibatch, before its clip
        seen = {}
        grads.append(seen)

        def step(_step=t.optimizer.step, _t=t, _seen=seen):
            if not _seen:
                _seen.update({n: p.grad.detach().cpu().clone()
                              for n, p in _t.policy.named_parameters()})
            return _step()
        t.optimizer.step = step
    _, m_card = tr.update(st, noise.to(dev), perms.to(dev))
    st_cpu, m_cpu = tr_cpu.update(st_cpu, noise, perms)
    check(int(st_cpu.ep_stats.count) == 0, "PPO card vs cpu: an agent was done in the rollout")
    g_rel = max(float((grads[0][n] - g).abs().max() / g.abs().max())
                for n, g in grads[1].items())
    l2, elem, worst, n_past = 0.0, 0.0, "", 0
    for (name, p), q in zip(tr.policy.named_parameters(), tr_cpu.policy.parameters()):
        d = (p.detach().cpu() - q.detach()).abs()
        l2 = max(l2, float(torch.linalg.vector_norm(d) / torch.linalg.vector_norm(q.detach())))
        scale = q.detach().abs().max()
        if float(d.max() / scale) > elem:
            elem, worst = float(d.max() / scale), f"{name} ({d.numel()} elements)"
        n_past += int((d > 1e-4 * scale).sum())
    return (abs(float(m_card["loss"]) - float(m_cpu["loss"])), g_rel, l2, elem, worst,
            n_past)


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn()`` between CUDA events: the whole call,
    with the host time of its Python while the card waits (every ``ms`` of
    the kernels line; the kernel alone is :func:`device_ms`)."""
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


def device_ms(fn, reps=20, warmup=3):
    """Milliseconds the card spends per call of ``fn``, from CUDA events: the
    ``reps`` calls are queued behind a spin of the card (``torch.cuda._sleep``)
    and so run back to back, without the host's time between launches that
    :func:`cuda_ms` holds (0.03-0.08 ms a call, most of a kernel as short as
    B1). Each wrapper timed so launches one kernel, so this is the kernel and
    the gap of about a microsecond between two launches. The spin is doubled
    until every call was queued before it ended; ``fn`` must not wait for the
    card. ``torch.profiler``'s kernel records, which this replaced, dropped
    the launches of a 16-microsecond kernel three traces running, and once a
    trace had dropped some, the next could report half the kernel's time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000  # about 10 ms at the H100's clock
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError(f"FAILED: {reps} calls were not queued within a spin of {cycles} cycles")


def camera_rays_of(env, state, sensor=0):
    """The component-major rays (3, 1, N·H·W) the render gives the kernels."""
    from visfly_tpu_torch.render import camera_rays_components

    spec = env.sensor_kwargs[sensor]
    n, hw = env.num_agent, spec["resolution"][0] * spec["resolution"][1]
    o_c, d_c, _ = camera_rays_components(spec, state.dyn.pos, state.dyn.q, env.cameras[sensor])
    o = o_c[:, :, None].expand(3, n, hw).reshape(3, 1, n * hw).contiguous()
    return o, d_c.reshape(3, 1, n * hw).contiguous()


def packed(x):
    return x.permute(1, 2, 0).contiguous()


def kernel_modes(t_init, img_w=None):
    """name → (kernel call, plain call) on (kscene, o, d), with the arguments
    the main paths give each mode. ``t_init`` warm-starts the packed march;
    ``img_w`` is the width of the camera whose rays o and d are (None for
    rays of no camera): the culls' frustum planes take it, and the march
    kernel its warps' patches of pixels. The analytic modes cull, as the
    render does on whole 1,024-ray tiles."""
    from visfly_tpu_torch.render import (trace_analytic, trace_analytic_reference, trace_march,
                                         trace_march_reference)

    half = max(8, TRACE_STEPS // 2)
    return {
        "trace_analytic": (
            lambda ks, o, d: trace_analytic(ks, o, d, MAX_DEPTH, cull=True, img_w=img_w),
            lambda ks, o, d, **kw: trace_analytic_reference(ks, o, d, MAX_DEPTH, cull=True,
                                                            img_w=img_w)),
        "trace_analytic_kid": (
            lambda ks, o, d: trace_analytic(ks, o, d, MAX_DEPTH, want_kid=True, cull=True,
                                            img_w=img_w),
            lambda ks, o, d, **kw: trace_analytic_reference(ks, o, d, MAX_DEPTH, want_kid=True,
                                                            cull=True, img_w=img_w)),
        "trace_march": (
            lambda ks, o, d: trace_march(ks, o, d, None, TRACE_STEPS, MAX_DEPTH, img_w=img_w),
            lambda ks, o, d, **kw: trace_march_reference(ks, o, d, None, TRACE_STEPS,
                                                         MAX_DEPTH, cull=True, img_w=img_w,
                                                         **kw)),
        "trace_march_nocull": (
            lambda ks, o, d: trace_march(ks, o, d, None, TRACE_STEPS, MAX_DEPTH, omega=1.5,
                                         cull=False, img_w=img_w),
            lambda ks, o, d, **kw: trace_march_reference(ks, o, d, None, TRACE_STEPS,
                                                         MAX_DEPTH, omega=1.5, **kw)),
        "trace_march_packed": (
            lambda ks, o, d: trace_march(ks, packed(o), packed(d), t_init(o), half, MAX_DEPTH,
                                         packed=True, img_w=img_w),
            lambda ks, o, d, **kw: trace_march_reference(ks, o, d, t_init(o), half, MAX_DEPTH,
                                                         **kw)),
    }


def cull_counts(case, ks, o, d, img_w, card):
    """The culled march kernel's per-tile (nb, nc) against the plain cull's
    on every tile, exactly; a tile that differs is printed with the margins
    of its rows against the four frustum planes. → the share of tiles whose
    rows fit the compacted block."""
    import torch

    from visfly_tpu_torch.render import trace_march
    from visfly_tpu_torch.render.trace_kernel import cull_rows

    counts = trace_march(ks, o, d, None, TRACE_STEPS, MAX_DEPTH, img_w=img_w,
                         want_counts=True)[2]
    plan = cull_rows(ks, o, d, MAX_DEPTH, img_w)
    want = torch.stack([plan.nb, plan.nc], -1).to(torch.int32)
    bad = (counts != want).any(-1).nonzero().tolist()
    for s, tile in bad[:8]:
        margins = "none (no frustum)"
        if plan.box_margin is not None:  # per plane, the least |margin| of a box / capsule row
            margins = [f"{float(plan.box_margin[s, tile, q].abs().min()):.3e}/"
                       f"{float(plan.cap_margin[s, tile, q].abs().min()):.3e}" for q in range(4)]
        print(f"phase 3 | cull counts on {case}, scene {s} tile {tile}: kernel "
              f"{counts[s, tile].tolist()}, plain {want[s, tile].tolist()}; plane margins "
              f"{margins}", flush=True)
    fits = float(plan.fits.double().mean())
    print(f"phase 3 | cull counts on {case}: {counts.shape[0] * counts.shape[1]} tiles, "
          f"{len(bad)} differ; rows fit the compacted block on {fits:.4f} of the tiles; "
          f"culled-in rows a tile: boxes {float(plan.nb.double().mean()):.2f} of "
          f"{ks.boxes.shape[1]}, capsules {float(plan.nc.double().mean()):.2f} of "
          f"{ks.capsules.shape[1]} | {card}", flush=True)
    check(not bad, f"cull counts differ on {len(bad)} tiles of {case}")
    return fits


def compare(mode, case, kernel, plain, kscene, o, d):
    """Kernel vs plain version on the same card tensors → max |Δt| on rays
    that both hit. Fails on non-finite output, |Δt| > T_TOL, or hit flags or
    ids that differ on more than HIT_TOL of the rays; prints whether every
    output is equal."""
    import torch

    out_k, out_p = kernel(kscene, o, d), plain(kscene, o, d)
    torch.cuda.synchronize()
    (t_k, hit_k), (t_p, hit_p) = out_k[:2], out_p[:2]
    check(bool(torch.isfinite(t_k).all()), f"{mode} on {case}: non-finite kernel output")
    both = hit_k & hit_p
    err = float((t_k - t_p).abs()[both].max()) if bool(both.any()) else 0.0
    flip = float((hit_k != hit_p).float().mean())
    equal = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    msg = (f"phase 3 | {mode} on {case}: rays={o.shape[1] * o.shape[2]} "
           f"hit={float(hit_k.float().mean()):.4f} max|dt|={err:.3e} m hit_mismatch={flip:.3e} "
           f"equal={equal}")
    if len(out_k) > 2:
        kid_off = float((out_k[2] != out_p[2]).float().mean())
        msg += f" kid_mismatch={kid_off:.3e} kid>=0 on {float((out_k[2] >= 0).float().mean()):.4f}"
        check(kid_off <= HIT_TOL, f"{mode} on {case}: kid mismatch {kid_off} > {HIT_TOL}")
        check(bool((out_k[2][~hit_k] == -1).all()), f"{mode} on {case}: a miss has an id")
    print(msg, flush=True)
    check(err <= T_TOL, f"{mode} on {case}: max |dt| {err} > {T_TOL}")
    check(flip <= HIT_TOL, f"{mode} on {case}: hit mismatch {flip} > {HIT_TOL}")
    return err


def one_origin_tiles(o):
    """(S, T) True where every ray of a 1,024-ray tile of the rays o
    (3, S, R), R a multiple of 1,024, has the tile's first origin, bit for
    bit."""
    import torch

    bits = o.contiguous().view(torch.int32).reshape(3, o.shape[1], -1, 1024)
    return (bits == bits[..., :1]).all(-1).all(0)


def analytic_ops(kscene, o, plan=None, old=False):
    """Float32 operations of the analytic trace of the rays o (3, S, R), R a
    multiple of 1,024 (OPS): per tile, each row that meets it (``plan``:
    ``cull_rows``'s ``box_in``, ``cap_in``; else every active row) charged its
    per-ray terms for every ray, its origin terms once where the tile's rays
    share one origin (``one_origin_tiles``) and for every ray elsewhere, and
    its row constants once. ``old``: the old yardstick, every active row's
    ``box_hit`` or ``cap_hit`` for every ray."""
    act_b = kscene.boxes[..., 11] > 0.5  # (S, KB)
    act_c = kscene.capsules[..., 7] > 0.5
    n_rays = o.shape[1] * o.shape[2]
    if old:
        return n_rays / o.shape[1] * float(act_b.sum() * OPS["box_hit"]
                                           + act_c.sum() * OPS["cap_hit"])
    T = o.shape[2] // 1024
    box_in = act_b[:, None].expand(-1, T, -1) if plan is None else plan.box_in
    cap_in = act_c[:, None].expand(-1, T, -1) if plan is None else plan.cap_in
    b = kscene.boxes
    sphere = (b[..., 9] >= 0.0) & (b[..., 3] + b[..., 4] + b[..., 5] < 1e-6)
    n_sph = (box_in & sphere[:, None]).sum(-1).double()  # (S, T)
    n_slab = box_in.sum(-1).double() - n_sph
    n_cap = cap_in.sum(-1).double()
    ray = n_slab * OPS["box_ray"] + n_sph * OPS["sphere_ray"] + n_cap * OPS["cap_ray"]
    origin = n_slab * OPS["box_origin"] + n_sph * OPS["sphere_origin"] + n_cap * OPS["cap_origin"]
    rows = (n_slab + n_sph) * OPS["box_row"] + n_cap * OPS["cap_row"]
    per_origin = one_origin_tiles(o).double() * (1 - 1024) + 1024  # 1 or 1,024
    return float((1024 * ray + per_origin * origin + rows).sum())


def analytic_phase(case, ks, o, d, img_w, errs, card):
    """The analytic modes beyond :func:`kernel_modes`' comparison, on one
    case: the culled kernel against the un-culled plain version (each ray
    that differs printed with its winning row's margins against the frustum
    planes), the culled kernel without the frustum planes and the un-culled
    kernel each against its plain version, the last also on rays that end in
    a ragged tile; all within the smoke's limits.
    Prints the share of tiles whose rays share one origin and the rows a ray
    tests."""
    import torch

    from visfly_tpu_torch.render import trace_analytic, trace_analytic_reference
    from visfly_tpu_torch.render import trace_kernel as tk

    plan = tk.cull_rows(ks, o, d, MAX_DEPTH, img_w)
    for kid in (False, True):
        mode = "trace_analytic_kid" if kid else "trace_analytic"
        culled = lambda ks_, o_, d_, w=img_w: trace_analytic(  # noqa: E731
            ks_, o_, d_, MAX_DEPTH, want_kid=kid, cull=True, img_w=w)
        unculled = lambda ks_, o_, d_: trace_analytic(ks_, o_, d_, MAX_DEPTH,  # noqa: E731
                                                      want_kid=kid)
        plain_all = lambda ks_, o_, d_: trace_analytic_reference(  # noqa: E731
            ks_, o_, d_, MAX_DEPTH, want_kid=kid)
        calls = [(f"{mode} (culled) vs the un-culled plain version", culled, plain_all),
                 (f"{mode} (cull=False)", unculled, plain_all)]
        if img_w is not None:
            calls.append((f"{mode} (culled, no frustum planes)",
                          lambda ks_, o_, d_: culled(ks_, o_, d_, None),
                          lambda ks_, o_, d_: trace_analytic_reference(
                              ks_, o_, d_, MAX_DEPTH, want_kid=kid, cull=True)))
        for name, kernel, plain in calls:
            errs[mode] = max(errs[mode], compare(name, case, kernel, plain, ks, o, d))
        for cut in (1500, 1028):  # a ragged last tile, R % 4 != 0 and == 0
            o_r, d_r = o[:, :, :-cut].contiguous(), d[:, :, :-cut].contiguous()
            errs[mode] = max(errs[mode], compare(
                f"{mode} (cull=False, {o_r.shape[2]} rays)", case, unculled, plain_all, ks, o_r,
                d_r))
        t_k, hit_k = culled(ks, o, d)[:2]
        t_p, hit_p = plain_all(ks, o, d)[:2]
        bad = ((t_k != t_p) | (hit_k != hit_p)).nonzero().tolist()
        for s, r in bad[:8]:
            tile = r // 1024
            oi = tuple(o[i, s, r:r + 1, None] for i in range(3))
            di = tuple(d[i, s, r:r + 1, None] for i in range(3))
            cand = torch.cat([tk._box_t(ks.boxes[s], oi, di),
                              tk._capsule_t(ks.capsules[s], oi, di)], dim=1)[0]
            k = int(cand.argmin())
            kb = ks.boxes.shape[1]
            cull_in = bool(plan.box_in[s, tile, k] if k < kb else plan.cap_in[s, tile, k - kb])
            margin = plan.box_margin if k < kb else plan.cap_margin
            margins = ("none" if margin is None else
                       [f"{float(margin[s, tile, q, k % kb if k < kb else k - kb]):.3e}"
                        for q in range(4)])
            print(f"phase 3 | {mode} culled vs un-culled on {case}, scene {s} ray {r}: t "
                  f"{float(t_k[s, r]):.6f} / {float(t_p[s, r]):.6f}, winning row {k} culled in "
                  f"{cull_in}, its plane margins {margins}", flush=True)
    one = one_origin_tiles(o)
    rays_b = float(plan.box_in.sum(-1).double().mean())
    rays_c = float(plan.cap_in.sum(-1).double().mean())
    print(f"phase 3 | analytic cull on {case}: {one.numel()} tiles, one origin on "
          f"{float(one.double().mean()):.4f}; a ray tests {rays_b:.2f} of "
          f"{int((ks.boxes[..., 11] > 0.5).sum()) // ks.boxes.shape[0]} box and {rays_c:.2f} of "
          f"{int((ks.capsules[..., 7] > 0.5).sum()) // ks.capsules.shape[0]} capsule rows | "
          f"{card}", flush=True)


def march_ops(kscene, stats, plan=None, per_eval_rows=False):
    """Float32 operations of a march (OPS): each ray's evaluations
    (``stats["ray_evals"]`` of the plain version) times the active rows its
    tile evaluates, all of them, or with ``plan`` (``cull_rows``) the culled
    function's; and each capsule row's constants once for each tile that
    evaluates it (``per_eval_rows``: at every evaluation instead, as the
    march kernel did before it staged them)."""
    import torch

    act_b = kscene.boxes[..., 11] > 0.5  # (S, KB)
    act_c = kscene.capsules[..., 7] > 0.5
    evals = stats["ray_evals"]
    n_tiles = -(-evals.shape[1] // 1024)
    if plan is None:
        n_box = act_b.sum(-1)[:, None].expand(-1, n_tiles)
        n_cap = act_c.sum(-1)[:, None].expand(-1, n_tiles)
    else:
        n_box = (plan.box_rows & act_b[:, None]).sum(-1)  # (S, T)
        n_cap = (plan.cap_rows & act_c[:, None]).sum(-1)
    cap_eval = OPS["cap_sdf"] + OPS["cap_row"] * per_eval_rows
    per_tile = (n_box * OPS["box_sdf"] + n_cap * cap_eval).double()
    tile_evals = torch.zeros(evals.shape[0], n_tiles * 1024, dtype=torch.float64,
                             device=evals.device)
    tile_evals[:, :evals.shape[1]] = evals.double()
    tile_evals = tile_evals.reshape(evals.shape[0], n_tiles, 1024).sum(-1)
    rows = 0.0 if per_eval_rows else float(n_cap.double().sum()) * OPS["cap_row"]
    return float((tile_evals * per_tile).sum()) + rows


def bound_ms(mode, kscene, n_rays, stats=None, plan=None, o=None, old=False):
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its float32 operations, on
    this run's data, over the float32 peak → (ms, "bytes" | "operations").
    A march's operations are :func:`march_ops` of the plain version's
    ``stats``; the culled march's (``plan``) count the rows each tile
    evaluates. The analytic trace's are :func:`analytic_ops` of the origins
    ``o`` and the cull ``plan`` (``old``: on the old yardstick)."""
    if mode.startswith("trace_analytic"):
        # six ray components in, t and hit (and the id) out
        n_bytes = n_rays * (6 * 4 + 4 + 1 + (4 if mode.endswith("kid") else 0))
        ops = analytic_ops(kscene, o, plan, old)
    else:
        n_bytes = n_rays * (6 * 4 + 4 + 4 + 1)  # and t_init in
        ops = march_ops(kscene, stats, plan)
    by_bytes, by_ops = n_bytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gradient_phase(kscene, o, d, gen):
    """The IFT gradient through the kernel forward against the same rule on
    the plain forward, for both layouts, with one upstream gradient."""
    import torch

    from visfly_tpu_torch.render import trace_diff, trace_march_reference
    from visfly_tpu_torch.render.trace_kernel import trace_ift_backward

    g_t = torch.randn((o.shape[1], o.shape[2]), generator=gen, device=o.device)
    for layout, o_in, d_in in (("component", o, d), ("packed", packed(o), packed(d))):
        o_in, d_in = o_in.clone().requires_grad_(True), d_in.clone().requires_grad_(True)
        t = trace_diff(kscene, o_in, d_in, None, TRACE_STEPS, MAX_DEPTH,
                       packed=layout == "packed")[0]
        g_o, g_d = torch.autograd.grad((t * g_t).sum(), (o_in, d_in))
        t_p, hit_p = trace_march_reference(kscene, o, d, None, TRACE_STEPS, MAX_DEPTH,
                                           cull=layout == "component")
        r_o, r_d = trace_ift_backward(kscene, o_in.detach(), d_in.detach(), t_p, hit_p, g_t,
                                      layout == "packed")
        torch.cuda.synchronize()
        check(bool(torch.isfinite(g_o).all() and torch.isfinite(g_d).all()),
              f"{layout} gradient not finite")
        check(float(g_o.abs().max()) > 0, f"{layout} gradient is zero")
        rel = max(float((g - r).abs().max() / r.abs().max()) for g, r in ((g_o, r_o), (g_d, r_d)))
        print(f"phase 3 | gradient ({layout} rays, kernel forward vs plain forward): "
              f"max relative difference {rel:.3e}, max|d_o|={float(g_o.abs().max()):.3e}",
              flush=True)
        check(rel <= GRAD_TOL, f"{layout} gradient differs by {rel} > {GRAD_TOL}")


def reset_launches():
    from visfly_tpu_torch.render import trace_kernel, tri_kernel

    trace_kernel.reset_launches()
    tri_kernel.reset_launches()


def all_launches():
    """Launches of every kernel since the last reset, by the names of KERNELS."""
    from visfly_tpu_torch.render import trace_kernel, tri_kernel

    return {**trace_kernel.LAUNCHES, **tri_kernel.LAUNCHES}


def mesh_camera_rays(env, state, sensor):
    """The component-major rays (3, S, N/S·H·W) that the exact-triangle
    render of ``sensor`` traces, and the ``img_w`` and ``cam_rays`` it
    passes on."""
    from visfly_tpu_torch.render import camera_rays

    spec = env.sensor_kwargs[sensor]
    h, w = spec["resolution"]
    n, S = env.num_agent, env.num_scene
    origins, dirs, _ = camera_rays(spec, state.dyn.pos, state.dyn.q)
    o = origins[:, None, :].expand(n, h * w, 3).reshape(S, n // S * h * w, 3)
    o_c = o.permute(2, 0, 1).contiguous()
    d_c = dirs.reshape(S, n // S * h * w, 3).permute(2, 0, 1).contiguous()
    whole = (h * w) % 1024 == 0
    return o_c, d_c, (w if whole else None), (h * w if whole else None)


def not_tied(tris, o_c, d_c, gid_a, gid_b):
    """Rays whose two winners ``gid_a`` and ``gid_b`` differ although the ray
    does not meet both triangles at one t (shared edges and coplanar
    neighbours tie; either id is then right)."""
    import torch

    differ = gid_a != gid_b
    idx = differ.nonzero(as_tuple=True)
    if idx[0].numel() == 0:
        return differ
    o = o_c[:, idx[0], idx[1]].T
    d = d_c[:, idx[0], idx[1]].T
    ts = []
    for gid in (gid_a, gid_b):
        rows = tris[idx[0], gid[idx].long()]
        a, e1, e2 = rows[:, 0:3], rows[:, 3:6] - rows[:, 0:3], rows[:, 6:9] - rows[:, 0:3]
        p = torch.linalg.cross(d, e2)
        det = (e1 * p).sum(-1)
        inv = 1.0 / torch.where(det.abs() > 1e-9, det, 1.0)
        tv = o - a
        u = (tv * p).sum(-1) * inv
        q = torch.linalg.cross(tv, e1)
        v = (d * q).sum(-1) * inv
        on = (det.abs() > 1e-9) & (u >= -1e-3) & (v >= -1e-3) & (u + v <= 1 + 1e-3)
        ts.append(torch.where(on, (e2 * q).sum(-1) * inv, float("nan")))
    tied = (ts[0] - ts[1]).abs() <= T_TOL
    out = torch.zeros_like(differ)
    out[idx] = ~tied
    return out


def tri_bound_ms(ops_key, stats, n_rays, lists, per_ray_origins=False, out_bytes=9):
    """The triangle kernel's bound on this run's data → (ms, by what, ms by
    bytes). Bytes: directions in (and origins, for the per-ray body), the
    outputs, the walked lists, and every staged triangle row once a tile;
    operations: the tests on real triangles up to the body's gate, the next
    part for those past it, and the division and the rest only for those that
    divide (``TRI_OPS``), at the float32 rate; for "mx" the larger of that and
    its TF32 products (``TRI_TC_FLOPS``) at the tensor cores' rate."""
    n_bytes = (n_rays * (12 + (12 if per_ray_origins else 0) + out_bytes)
               + stats["real_tests"] / 1024 * 36
               + stats["tests"] / 1024 * 4.0 / lists.block + lists.lb.numel() * 4
               + lists.n_stage.numel() * 4 * (1 if lists.start is None else 2))
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    to_gate, past_gate, divide = TRI_OPS[ops_key] if ops_key else (0, 0, 0)
    ops = (stats["real_tests"] * to_gate + stats["gated"] * past_gate
           + stats["divided"] * divide)
    tc_flops = stats["real_tests"] * TRI_TC_FLOPS.get(ops_key, 0)
    by_ops = max(ops / PEAK_FP32_PER_S, tc_flops / PEAK_TF32_PER_S) * 1e3
    return (by_bytes, "bytes", by_bytes) if by_bytes >= by_ops else (by_ops, "operations",
                                                                      by_bytes)



def mx_floor_ms(stats):
    """The floor of the matrix form's design on this run's data → (ms, its
    products' ms at the TF32 tensor rate, its gate's ms at the float32 rate):
    every staged slot's ``MX_TC_FLOPS``, and the gate as the bound counts it."""
    tc_ms = stats["tests"] * MX_TC_FLOPS / PEAK_TF32_PER_S * 1e3
    to_gate, _, divide = TRI_OPS["mx"]
    gate_ms = (stats["real_tests"] * to_gate + stats["divided"] * divide) / PEAK_FP32_PER_S * 1e3
    return max(tc_ms, gate_ms), tc_ms, gate_ms

def agree(name, a, b, tris=None, rays=None):
    """Two (t, hit, gid) results of one ray set held to the smoke's limits →
    max |Δt| where both hit. With ``tris`` and ``rays`` ids are compared where
    the two winners are not tied, else wherever both hit."""
    import torch

    (t_a, hit_a, gid_a), (t_b, hit_b, gid_b) = a[:3], b[:3]
    check(bool(torch.isfinite(t_a).all()), f"{name}: non-finite output")
    both = hit_a & hit_b
    err = float((t_a - t_b).abs()[both].max()) if bool(both.any()) else 0.0
    flip = float((hit_a != hit_b).float().mean())
    differ = (gid_a != gid_b) if tris is None else not_tied(tris, *rays, gid_a, gid_b)
    gid_off = float((differ & both).float().mean())
    print(f"phase 3 | {name}: hit={float(hit_a.float().mean()):.4f} max|dt|={err:.3e} m "
          f"hit_mismatch={flip:.3e} {'untied ' if tris is not None else ''}"
          f"id_mismatch={gid_off:.3e}", flush=True)
    check(err <= T_TOL, f"{name}: max |dt| {err} > {T_TOL}")
    check(flip <= HIT_TOL, f"{name}: hit mismatch {flip} > {HIT_TOL}")
    check(gid_off <= HIT_TOL, f"{name}: id mismatch {gid_off} > {HIT_TOL}")
    return err


def sass_of(lib, kernel):
    """The SASS instructions of the function whose mangled name holds
    ``kernel`` in the built library ``lib`` (``cuobjdump -sass``)."""
    from visfly_tpu_torch.build import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    for block in sass.split("Function : ")[1:]:
        if kernel in block.split()[0]:
            return [ln.split("*/", 1)[1].strip().rstrip(" ;") for ln in block.splitlines()
                    if ln.strip().startswith("/*") and "*/" in ln and ";" in ln]
    raise RuntimeError(f"FAILED: no function {kernel} in {lib}")


def ptxas_entries(lib):
    """[(mangled name, registers, spill store bytes, spill load bytes)] of every
    function ptxas compiled into the built library ``lib``, from the build log
    beside it."""
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        log = f.read()
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        name, rest = entry.split("'", 1)
        regs = int(rest.split("Used ", 1)[1].split(" registers")[0])
        stores = int(rest.split(" bytes spill stores")[0].rsplit(" ", 1)[-1])
        loads = int(rest.split(" bytes spill loads")[0].rsplit(" ", 1)[-1])
        out.append((name, regs, stores, loads))
    return out


def ptxas_entry(lib, kernel):
    """(registers, spill store bytes, spill load bytes) of the function of
    ``lib`` whose mangled name holds ``kernel``."""
    for name, *counts in ptxas_entries(lib):
        if kernel in name:
            return tuple(counts)
    raise RuntimeError(f"FAILED: ptxas reported no function {kernel} for {lib}")


def shared_edge_rays(tris, o_cams, per_cam):
    """Rays from each camera origin of ``o_cams`` (3, n) through the float32
    midpoint of every edge that two coplanar triangles of the mesh share (a
    flat surface's inner edges, where a ray can only slip through by rounding;
    a box's corner edges are silhouettes, where float32 and float64 rightly
    disagree), ``per_cam`` (a multiple of 1,024) a camera, the list repeated
    to fill → (o_c, d_c) (3, 1, n · per_cam), the edges' count and the
    distances to the midpoints (1, n · per_cam)."""
    import numpy as np
    import torch

    v = tris[0].reshape(-1, 3, 3).cpu().numpy()
    p, q = v.reshape(-1, 3), v[:, [1, 2, 0]].reshape(-1, 3)
    swap = ((p[:, 0] > q[:, 0]) | ((p[:, 0] == q[:, 0]) & (
        (p[:, 1] > q[:, 1]) | ((p[:, 1] == q[:, 1]) & (p[:, 2] > q[:, 2])))))[:, None]
    key = np.concatenate([np.where(swap, q, p), np.where(swap, p, q)], 1)
    order = np.lexsort(key.T[::-1])
    same = np.all(key[order[1:]] == key[order[:-1]], axis=1)
    pad = np.concatenate([[False], same, [False]])
    first = np.nonzero(pad[1:-1] & ~pad[:-2] & ~pad[2:])[0]  # edges shared exactly twice
    vd = v.astype(np.float64)
    n = np.cross(vd[:, 1] - vd[:, 0], vd[:, 2] - vd[:, 0])
    na, nb = n[order[first] // 3], n[order[first + 1] // 3]
    flat = ((np.linalg.norm(np.cross(na, nb), axis=1)
             <= 1e-6 * np.linalg.norm(na, axis=1) * np.linalg.norm(nb, axis=1))
            & ((na * nb).sum(1) > 0))
    edges = key[order[first[flat]]]
    mid = ((edges[:, :3] + edges[:, 3:]) * np.float32(0.5)).astype(np.float32)
    mid = np.resize(mid, (per_cam, 3))
    dev = o_cams.device
    m = torch.from_numpy(mid).to(dev).T[:, None, :]  # (3, 1, per_cam)
    o_c = o_cams[:, :, None].expand(3, o_cams.shape[1], per_cam).reshape(3, 1, -1)
    d = m.expand(3, o_cams.shape[1], per_cam).reshape(3, 1, -1) - o_c
    dist = torch.linalg.vector_norm(d, dim=0)
    return o_c.contiguous(), (d / dist).contiguous(), len(edges), dist


def whole_mesh_lists(T, tiles, block, dev):
    """Every tile's list is every block of the mesh in order, bounds 0."""
    import torch

    from visfly_tpu_torch.render.tri_kernel import TileLists

    n = T // block
    ids = torch.arange(n, dtype=torch.int32, device=dev).expand(1, tiles, n).contiguous()
    return TileLists(ids, torch.full((1, tiles), n, dtype=torch.int32, device=dev),
                     torch.zeros((1, tiles, n), device=dev), block, block)


def mx_phase(tris, o8, d8, img_w, cam_rays, args, plan, stats, n_rays, ms, b_ms, card, timing):
    """The matrix form on the tensor cores, beyond what every variant is held
    to: its time on the device, its distance from the TF32 split's model,
    shared edges (on rays through every flat shared edge's midpoint, hit
    flags equal to the plain version's and t within 1e-3 m of it on every
    ray; a float64 brute force beside them), exact ties (the mesh twice over: every id
    equal to the plain version's), its SASS (HMMA, no float32 product loop),
    registers, and the floor of its design beside the bound."""
    import torch

    from visfly_tpu_torch.build import library_path
    from visfly_tpu_torch.render import (tri_first_hit, tri_first_hit_reference, tri_trace_brute,
                                         tri_trace_tiled)
    from visfly_tpu_torch.render.tri_kernel import sv_first_hit_tf32
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    mode = "tri_trace_camsoup_mx"
    T = tris.shape[1]
    dev_ms = device_ms(lambda: tri_first_hit(*args, mode="mx"))
    timing["device_ms"] = dev_ms

    # the kernel against its split's model on 8 cameras, lists of the whole mesh
    t_k, hit_k = tri_trace_tiled(tris, o8, d8, MAX_DEPTH, T, img_w, cam_rays, variant="mx")[:2]
    t_m, hit_m = [], []
    for cam in range(o8.shape[2] // cam_rays):
        sl = slice(cam * cam_rays, (cam + 1) * cam_rays)
        t, hit = sv_first_hit_tf32(tris[0], tuple(o8[:, 0, sl.start]), d8[:, 0, sl].T, MAX_DEPTH,
                                   slab=2048)
        t_m.append(t)
        hit_m.append(hit)
    t_m, hit_m = torch.cat(t_m)[None], torch.cat(hit_m)[None]
    both = hit_k & hit_m
    print(f"phase 3 | {mode} T={T} vs its TF32 split's model (tf32_split, three passes summed "
          f"in float64) on 8 cameras, lists of the whole mesh: max|dt|="
          f"{float((t_k - t_m).abs()[both].max()):.3e} m, hit flags differ on "
          f"{float((hit_k != hit_m).float().mean()):.3e}", flush=True)

    # shared edges: rays from 4 cameras through every flat shared edge's
    # midpoint, held to the plain version's hit flags and t (a ray that slips
    # between two triangles ends metres deeper); beside them a float64 brute
    # force's, from which float32 grazing rays differ by about 1e-3 m
    cams = 4
    per_cam = -(-(3 * T // 2) // 1024) * 1024
    o_w, d_w, n_edges, dist = shared_edge_rays(tris, o8[:, 0, ::cam_rays][:, :cams], per_cam)
    lists = whole_mesh_lists(T, o_w.shape[2] // 1024, plan.lists.block, o_w.device)
    w_args = (tris, lists, o_w, d_w, MAX_DEPTH, "sv_cam", per_cam // 1024)
    out_k = tri_first_hit(*w_args, mode="mx")
    out_p = tri_first_hit_reference(*w_args, mode="mx")
    t64, hit64, _, _ = tri_trace_brute(tris.double(), o_w.double().permute(1, 2, 0),
                                       d_w.double().permute(1, 2, 0), MAX_DEPTH,
                                       max_elems=1 << 24)
    torch.cuda.synchronize()
    flips = int((out_k[1] != out_p[1]).sum())
    dt = (out_k[0] - out_p[0]).abs()[out_k[1] & out_p[1]]
    past = [int(((out[0].double() - t64).abs() > T_TOL)[out[1] & hit64].sum())
            for out in (out_k, out_p)]
    err64 = [float((out[0].double() - t64).abs()[out[1] & hit64].max()) for out in (out_k, out_p)]
    edge_seen = float(((t64 - dist).abs() <= T_TOL).double().mean())
    print(f"phase 3 | {mode} T={T} watertight: {n_edges} flat shared edges, {o_w.shape[2]} rays "
          f"through their float32 midpoints from {cams} cameras, {edge_seen:.4f} of them end at "
          f"the edge; against the plain version hit flags differ on {flips} rays, max|dt|="
          f"{float(dt.max()):.3e} m, rays past {T_TOL} m {int((dt > T_TOL).sum())}; against "
          f"float64 hit flags differ on {int((out_k[1] != hit64).sum())} rays, "
          f"max|dt|={err64[0]:.3e}"
          f" m, rays past {T_TOL} m {past[0]} (the plain version, torch.matmul in float32: "
          f"{err64[1]:.3e} m, {past[1]})", flush=True)
    check(flips == 0, f"{mode} watertight: hit flags differ on {flips} rays")
    check(float(dt.max()) <= T_TOL, f"{mode} watertight: max |dt| {float(dt.max())} > {T_TOL}")

    # exact ties: the mesh twice over, so that every hit ties with its copy
    tris2 = torch.cat([tris, tris], 1).contiguous()
    p2 = plan_tiles(tris2, o8, d8, MAX_DEPTH, 2 * T, img_w, cam_rays, variant="mx")
    a2 = (tris2, p2.lists, p2.origins_c, p2.dirs_c, MAX_DEPTH, p2.form, p2.origin_tiles)
    out_k = tri_first_hit(*a2, mode="mx")
    out_p = tri_first_hit_reference(*a2, mode="mx")
    torch.cuda.synchronize()
    bb = out_k[1] & out_p[1]
    dt = float((out_k[0] - out_p[0]).abs()[bb].max())
    id_off = int((out_k[2] != out_p[2])[bb].sum())
    copy_off = int(((out_k[2] != out_p[2]) & (out_k[2] % T == out_p[2] % T))[bb].sum())
    print(f"phase 3 | {mode} ties: the mesh twice over ({2 * T} triangles), 8 cameras: hit "
          f"{float(bb.float().mean()):.4f}, max|dt|={dt:.3e}"
          f" m, hit flags differ on {int((out_k[1] != out_p[1]).sum())} rays, ids differ on "
          f"{id_off} hit rays ({copy_off} of them between a triangle and its copy); first copy "
          f"wins on {float((out_k[2] < T)[bb].float().mean()):.4f}", flush=True)
    check(bool(torch.equal(out_k[1], out_p[1])), f"{mode} ties: hit flags differ")
    check(id_off == 0, f"{mode} ties: ids differ on {id_off} hit rays")

    # what the compiler made of it
    lib = library_path("tri_trace")
    ins = sass_of(lib, "tri_trace_mx_kernel")
    ops = [x.split()[1] if x.startswith("@") else x.split()[0] for x in ins]
    # the tensor cores' instructions: HMMA (mma.sync) and HGMMA (wgmma)
    mma = sorted({o for o in ops if o.startswith(("HMMA", "HGMMA"))})
    n = {k: sum(o.startswith(k) for o in ops) for k in ("HGMMA", "HMMA", "FMUL", "FFMA", "FADD")}
    regs, st, ld = ptxas_entry(lib, "tri_trace_mx_kernel")
    print(f"phase 3 | {mode} SASS: {len(ins)} instructions, " + ", ".join(
        f"{k} {v}" for k, v in n.items()) + f" ({', '.join(mma)}); ptxas {regs} registers, "
          f"{st} bytes spill stores, {ld} bytes spill loads | {card}", flush=True)
    check(mma and all("TF32" in o for o in mma), f"{mode}: no TF32 tensor instruction: {mma}")

    floor_ms, tc_ms, gate_ms = mx_floor_ms(stats)
    old_ms = tri_bound_ms("sv_cam", stats, n_rays, plan.lists)[0]
    print(f"phase 3 | {mode} T={T} 64x64 at {n_rays} rays: kernel {ms:.4f} ms (CUDA events "
          f"around the call), on the device {dev_ms:.4f} ms (20 calls queued behind a spin); "
          f"bound {b_ms:.4f} ms (the function's products, 3 TF32 passes, at the tensor rate; its "
          f"gate at the float32 rate), share {b_ms / ms:.4f} (device {b_ms / dev_ms:.4f}); old "
          f"yardstick {old_ms:.4f} ms (the float32 body on the CUDA cores, as B6); floor of this "
          f"design {floor_ms:.4f} ms (every staged slot's 96 TF32 flops {tc_ms:.4f}, gate "
          f"{gate_ms:.4f}), share {floor_ms / dev_ms:.4f} on the device | {card}",
          flush=True)

def variant_phase(env, state, card, errs, timing):
    """Phase 3 for the variants of the per-camera tier and the two
    diagnostics, on path D's camera rays at 23,040 triangles."""
    import torch

    from visfly_tpu_torch.render import (default_tri_cap, knockout_trace, stage_stats,
                                         tri_first_hit, tri_first_hit_reference,
                                         tri_trace_brute, tri_trace_tiled)
    from visfly_tpu_torch.render.tri_kernel import TILE_BLOCK_RAYS, count_name, tile_occupancy
    from visfly_tpu_torch.render.tri_trace import plan_tiles, walk_order

    tris = env.scene.triangles
    T = tris.shape[1]
    cap = default_tri_cap(T)
    o_c, d_c, img_w, cam_rays = mesh_camera_rays(env, state, 0)  # the 64×64 sensor
    n_rays = o_c.shape[2]

    def plan_of(variant, cap_, budget=None):
        return plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap_, img_w, cam_rays, variant=variant,
                          work_budget=budget)

    def args_of(plan):
        return (tris, plan.lists, plan.origins_c, plan.dirs_c, MAX_DEPTH, plan.form,
                plan.origin_tiles)

    # "scalar" with lists of the whole mesh and at the default cap: what every
    # variant is held against beside its own plain version
    full_s = plan_of("scalar", T)
    rays = (full_s.origins_c, full_s.dirs_c)  # every variant repacks alike
    out_full = tri_first_hit(*args_of(full_s))
    base = plan_of("scalar", cap)
    out_base = tri_first_hit(*args_of(base))
    scalar_ms = cuda_ms(lambda: tri_first_hit(*args_of(base)))
    r8 = 8 * cam_rays
    o8, d8 = o_c[:, :, :r8].contiguous(), d_c[:, :, :r8].contiguous()
    t_b, hit_b, _, gid_b = tri_trace_brute(tris, o8.permute(1, 2, 0), d8.permute(1, 2, 0),
                                           MAX_DEPTH)
    every = 10 ** 6  # a worklist budget that covers every stage
    for variant in ("merged", "mx", "wl"):
        plan = plan_of(variant, cap)
        mode = count_name(plan.form, plan.lists.block, plan.mode, plan.lists.start is not None)
        check(mode == VARIANT_SENSORS[{"merged": "depth", "mx": "depth_mx",
                                       "wl": "depth_wl"}[variant]][1], f"{variant}: {mode}")
        args = args_of(plan)
        out_k = tri_first_hit(*args, mode=plan.mode)
        stats = {}
        out_p = tri_first_hit_reference(*args, stats=stats, mode=plan.mode)
        torch.cuda.synchronize()
        err = agree(f"{mode} T={T} vs its plain version at the default cap", out_k, out_p, tris,
                    rays)
        # against "scalar": the same lists for merged and mx, so at the default
        # cap; the worklist culls 16-triangle clusters, so its lists and
        # scalar's hold the same triangles only when they hold the whole mesh
        if variant == "wl":
            out_v = tri_first_hit(*args_of(plan_of("wl", T, every)))
            agree(f"{mode} T={T} vs scalar, lists of the whole mesh, budget for every stage",
                  out_v, out_full, tris, rays)
            check(bool((out_k[0] >= out_full[0] - T_TOL).all()),
                  f"{mode}: a nearer hit at the default cap and budget")
            quota, need = plan.lists.n_stage, float(stats["stages"].float().mean())
            print(f"phase 3 | {mode} default budget: {plan.lists.lb.shape[1]} stages for "
                  f"{quota.numel()} tiles, quota mean {float(quota.float().mean()):.2f} max "
                  f"{int(quota.max())}, executed mean {need:.2f}; far hits lost against the whole "
                  f"mesh {float((out_full[1] & ~out_k[1]).float().mean()):.3e}", flush=True)
        else:
            agree(f"{mode} T={T} vs scalar at the default cap", out_k, out_base, tris, rays)
        t_t, hit_t, _, gid_t = tri_trace_tiled(tris, o8, d8, MAX_DEPTH, T, img_w, cam_rays,
                                               variant=variant, work_budget=every)
        agree(f"{mode} T={T} vs brute force on 8 cameras, lists of the whole mesh",
              (t_t, hit_t, gid_t), (t_b, hit_b, gid_b), tris, (o8, d8))
        ms = cuda_ms(lambda: tri_first_hit(*args, mode=plan.mode))
        prepass_ms = cuda_ms(lambda: plan_of(variant, cap), reps=10)
        plain_ms = cuda_ms(lambda: tri_first_hit_reference(*args, mode=plan.mode), reps=3,
                           warmup=1)
        b_ms, b_by, by_bytes = tri_bound_ms("mx" if variant == "mx" else plan.form, stats,
                                            n_rays, plan.lists,
                                            out_bytes=8 if variant == "merged" else 9)
        print(f"phase 3 | {mode} T={T} 64x64 at {n_rays} rays: kernel {ms:.4f} ms (scalar "
              f"{scalar_ms:.4f} ms), prepass {prepass_ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
              f"{b_ms:.4f} ms by {b_by} (bytes {by_bytes:.4f}), share of bound {b_ms / ms:.3f}; "
              f"{stats['real_tests'] / n_rays:.1f} tests a ray on triangles, "
              f"{stats['gated'] / n_rays:.2f} past the gate | {card}", flush=True)
        errs[mode] = err
        timing[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if variant == "mx":  # a kernel of its own, on the tensor cores, one block a tile
            mx_phase(tris, o8, d8, img_w, cam_rays, args, plan, stats, n_rays, ms, b_ms, card,
                     timing[mode])
            continue
        # the list walk against the cluster walk it replaced, on the plan's
        # lists and on a ragged set
        timing[mode]["device_ms"] = list_report(mode, f"T={T} 64x64", args, plan.mode, card,
                                                b_ms, b_by, n_rays)
        if variant == "merged":
            ragged, what = ragged_blocks(plan.lists), f"ragged block lists {list(RAGGED_BLOCKS)}"
        else:
            ragged, what = plan_of("wl", cap, every).lists, "lists at a budget for every stage"
        r_args = (tris, ragged, *args[2:])
        stats = {}
        err = agree(f"{mode} T={T} {what} vs plain", tri_first_hit(*r_args, mode=plan.mode),
                    tri_first_hit_reference(*r_args, stats=stats, mode=plan.mode), tris,
                    r_args[2:4])
        errs[mode] = max(err, errs[mode])
        r_ms, r_by, _ = tri_bound_ms(plan.form, stats, n_rays, ragged,
                                     out_bytes=8 if variant == "merged" else 9)
        list_report(mode, f"T={T} 64x64 {what}", r_args, plan.mode, card, r_ms, r_by, n_rays,
                    full=False)
        # few tiles (8 cameras: path T3's grid), where the walk splits a tile's stages too
        few = plan_tiles(tris, o8, d8, MAX_DEPTH, cap, img_w, cam_rays, variant=variant)
        f_args = (tris, few.lists, few.origins_c, few.dirs_c, MAX_DEPTH, few.form,
                  few.origin_tiles)
        stats = {}
        err = agree(f"{mode} T={T} 8 cameras vs plain", tri_first_hit(*f_args, mode=plan.mode),
                    tri_first_hit_reference(*f_args, stats=stats, mode=plan.mode), tris,
                    f_args[2:4])
        errs[mode] = max(err, errs[mode])
        f_ms, f_by, _ = tri_bound_ms(plan.form, stats, r8, few.lists,
                                     out_bytes=8 if variant == "merged" else 9)
        list_report(mode, f"T={T} 64x64 8 cameras", f_args, plan.mode, card, f_ms, f_by, r8,
                    full=False)

    # B8a, stages executed, on the list walk: the kernel's count against the
    # plain version's at 512 rays a block (TILE_BLOCK_RAYS), exactly, on the
    # 48x48 sensor's rays (the Moeller-Trumbore body over the soup's lists with
    # the count and longest-first order stage_stats gives them, as the TPU
    # probe) and on the per-camera tier's lists (neither: the count derived
    # from the ids, index order); t and hit against the cluster walk's at
    # k = 1 to the bit, and the two timed side by side
    o48, d48, w48, cam48 = mesh_camera_rays(env, state, 1)
    soup = plan_tiles(tris, o48, d48, MAX_DEPTH, cap, w48, cam48)
    soup = soup._replace(lists=walk_order(soup.lists))
    for name, plan in (("soup, 48x48", soup), ("per-camera, 64x64", base)):
        args = args_of(plan)
        reset_launches()
        out_k = tri_first_hit(*args, count_stages=True)
        out_c = tri_first_hit(*args, count_stages=True, split=1)
        torch.cuda.synchronize()
        got = {k: v for k, v in all_launches().items() if v}
        check(got == {"tri_trace_probe": 1, "tri_trace_probe_cluster": 1},
              f"tri_trace_probe {name}: launched {got}")
        stats, s_whole = {}, {}
        out_p = tri_first_hit_reference(*args, stats=stats, block_rays=TILE_BLOCK_RAYS)
        tri_first_hit_reference(*args, stats=s_whole)
        check(torch.equal(out_k[3], stats["stages"]), f"tri_trace_probe {name}: stage counts "
                                                      "differ from the plain version's")
        check(torch.equal(out_c[3], s_whole["stages"]), f"tri_trace_probe {name}: the cluster "
                                                        "walk's counts differ from its plain version's")
        check(same_result(out_k, out_c), f"tri_trace_probe {name}: the list walk differs from the "
                                         "cluster walk at k = 1")
        err = agree(f"tri_trace_probe T={T} {name} vs its plain version", out_k[:3], out_p)
        occ = tile_occupancy(plan.form, tris.device, count_stages=True)
        new_ms = device_ms(lambda: tri_first_hit(*args, count_stages=True))
        old_ms = device_ms(lambda: tri_first_hit(*args, count_stages=True, split=1))
        n = args[2].shape[2]
        b_ms, b_by, _ = tri_bound_ms(plan.form, stats, n, plan.lists, plan.form == "mt",
                                     9 + 8 / 1024)
        w_ms = tri_bound_ms(plan.form, s_whole, n, plan.lists, plan.form == "mt", 9 + 4 / 1024)[0]
        print(f"phase 3 | tri_trace_probe T={T} {name}: stages executed equal to the plain "
              f"version's on {out_k[3].numel()} tiles, mean {float(out_k[3].float().mean()):.2f} "
              f"summed over 2 blocks of {TILE_BLOCK_RAYS} rays (the cluster walk's tile-wide vote "
              f"{float(out_c[3].float().mean()):.2f}) of {plan.lists.lb.shape[2]}; t and hit equal "
              f"to the cluster walk at k = 1; on the device the list walk {new_ms:.4f} ms "
              f"({occ['regs']} registers, {occ['blocks_per_sm']} blocks an SM), the cluster walk "
              f"at k = 1 {old_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by} on the list walk's "
              f"{stats['real_tests'] / n:.1f} tests a ray (shares {b_ms / new_ms:.3f}, "
              f"{b_ms / old_ms:.3f}); the tile-wide vote's {s_whole['real_tests'] / n:.1f} tests a "
              f"ray bound it at {w_ms:.4f} ms (shares {w_ms / new_ms:.3f}, {w_ms / old_ms:.3f}) | "
              f"{card}", flush=True)
        if plan is soup:
            ms = cuda_ms(lambda: tri_first_hit(*args, count_stages=True))
            plain_ms = cuda_ms(lambda: tri_first_hit_reference(*args, block_rays=TILE_BLOCK_RAYS),
                               reps=3, warmup=1)
            errs["tri_trace_probe"] = err
            timing["tri_trace_probe"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                             bound_by=b_by, device_ms=new_ms,
                                             cluster_k1_device_ms=old_ms)
    torch.cuda.synchronize()
    reset_launches()
    st = stage_stats(tris, o48, d48, MAX_DEPTH, cap, w48)
    check(all_launches()["tri_trace_probe"] == 1, "stage_stats did not launch the probe")
    print(f"phase 3 | stage_stats T={T} 48x48, cap {cap}: stages executed a tile mean "
          f"{st['mean']:.2f} p50 {st['p50']:.0f} p90 {st['p90']:.0f} max {st['max']} of "
          f"{st['n_stage']} (summed over blocks of {st['block_rays']} rays), blocks seen mean "
          f"{st['visible_mean']:.2f}, hit {st['hit_frac']:.4f} | {card}", flush=True)

    # B8b, the knock-outs of the merged kernel, on the list walk (B7a's own
    # launch): each against its plain version at 512 rays a block and against
    # the cluster walk at k = 1, both timed; the split read from the list walk
    merged = plan_of("merged", cap)
    args = args_of(merged)
    new, old = {}, {}
    for body in (True, False):
        for pin in (False, True):
            name = f"body {'on' if body else 'off'}, stage {'pinned' if pin else 'walked'}"
            reset_launches()
            t_k = knockout_trace(tris, o_c, d_c, body=body, pin_stage=pin, plan=merged)
            t_c = tri_first_hit(*args, mode="merged", body=body, pin_stage=pin, split=1)[0]
            torch.cuda.synchronize()
            got = {k: v for k, v in all_launches().items() if v}
            want = ({"tri_trace_camsoup_merged": 1, "tri_trace_list_cluster": 1}
                    if body and not pin else
                    {"tri_trace_knockout": 1, "tri_trace_knockout_cluster": 1})
            check(got == want, f"tri_trace_knockout {name}: launched {got}, expected {want}")
            stats = {}
            t_p = tri_first_hit_reference(*args, stats=stats, mode="merged", body=body,
                                          pin_stage=pin, block_rays=TILE_BLOCK_RAYS)[0]
            err = float((t_k - t_p).abs().max())
            check(err <= T_TOL, f"tri_trace_knockout {name}: max |dt| {err} > {T_TOL}")
            check(torch.equal(t_k, t_c), f"tri_trace_knockout {name}: t differs from the cluster "
                                         "walk's at k = 1")
            if not body:
                check(bool((t_k == MAX_DEPTH).all()), f"tri_trace_knockout {name}: a hit")
            new[(body, pin)] = device_ms(
                lambda: knockout_trace(tris, o_c, d_c, body=body, pin_stage=pin, plan=merged))
            old[(body, pin)] = device_ms(lambda: tri_first_hit(
                *args, mode="merged", body=body, pin_stage=pin, split=1))
            print(f"phase 3 | tri_trace_knockout T={T} {name}: max|dt|={err:.3e} m vs its plain "
                  f"result, equal to the cluster walk at k = 1, mean t {float(t_k.mean()):.3f} m; on "
                  f"the device the list walk {new[(body, pin)]:.4f} ms, the cluster walk at k = 1 "
                  f"{old[(body, pin)]:.4f} ms | {card}", flush=True)
            if (body, pin) == (False, False):
                ms = cuda_ms(
                    lambda: knockout_trace(tris, o_c, d_c, body=body, pin_stage=pin, plan=merged))
                plain_ms = cuda_ms(lambda: tri_first_hit_reference(
                    *args, mode="merged", body=False, block_rays=TILE_BLOCK_RAYS), reps=3,
                    warmup=1)
                b_ms, b_by, _ = tri_bound_ms(None, stats, n_rays, merged.lists,
                                             out_bytes=8)  # the real rows staged, no operation
                occ = tile_occupancy("sv_cam", tris.device, "merged", knock=1)
                print(f"phase 3 | tri_trace_knockout T={T} {name}: {ms:.4f} ms by events around "
                      f"the call, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}, share "
                      f"{b_ms / new[(body, pin)]:.3f} on the device; {occ['regs']} registers, "
                      f"{occ['blocks_per_sm']} blocks an SM | {card}", flush=True)
                errs["tri_trace_knockout"] = err
                timing["tri_trace_knockout"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                                    bound_by=b_by, device_ms=new[(body, pin)],
                                                    cluster_k1_device_ms=old[(body, pin)])
    for walk, ms in (("the list walk", new), ("the cluster walk at k = 1", old)):
        full, nobody, pinned, neither = (ms[k] for k in ((True, False), (False, False),
                                                         (True, True), (False, True)))
        print(f"phase 3 | {walk}: the merged kernel's {full:.4f} ms on the device split by its "
              f"own knock-outs: launch, votes and barriers {neither:.4f} ms; staging the walked "
              f"blocks {nobody - neither:.4f} ms; arithmetic {full - nobody:.4f} ms "
              f"({(full - nobody) / full:.3f} of it; pinned stage with the body: {pinned:.4f} ms) "
              f"| {card}", flush=True)


def same_result(a, b):
    """Two (t, hit, gid) results equal as the split promises: t and hit to
    the bit, ids where the ray hits (a miss's id is whatever its walk kept)."""
    import torch

    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][b[1]], b[2][b[1]]))


def split_report(mode, case, args, plan, ms, b_ms, card):
    """The wrapper's split k of one kernel use against k = 1: equal to it
    (:func:`same_result`), their times, the stages executed a tile summed over
    its blocks, and the blocks an SM the occupancy query gives."""
    from visfly_tpu_torch.render import tri_first_hit
    from visfly_tpu_torch.render.tri_kernel import default_split, occupancy

    k = default_split(plan.lists, plan.form, plan.mode, args[2].device)
    occ = occupancy(plan.form, plan.mode)
    one = tri_first_hit(*args, mode=plan.mode, split=1, count_stages=True)
    at_k = tri_first_hit(*args, mode=plan.mode, split=k, count_stages=True)
    check(same_result(at_k, one), f"{mode} {case}: k = {k} differs from k = 1")
    ms_1 = cuda_ms(lambda: tri_first_hit(*args, mode=plan.mode, split=1))
    print(f"phase 3 | {mode} {case} split: k = {k} blocks a tile, {occ['blocks_per_sm']} blocks "
          f"an SM of {occ['sms']} ({occ['regs']} registers); kernel {ms:.4f} ms at k = {k}, "
          f"{ms_1:.4f} ms at k = 1; stages executed a tile summed over its blocks mean "
          f"{float(at_k[3].float().mean()):.2f} (k = 1: {float(one[3].float().mean()):.2f}); "
          f"share of bound {b_ms / ms:.3f} (k = 1: {b_ms / ms_1:.3f}); equal to k = 1 | {card}",
          flush=True)


def kept_lists(lists, counts):
    """Padded per-triangle lists with every slot past a tile's ``counts`` (S,
    tiles) emptied (−1) and each tile's stages cut to those that hold them (at
    least one): the slots the tile kernel walks, as lists that every walk
    takes alike. The stage bounds stay (the least of more slots is still a
    bound)."""
    import torch

    from visfly_tpu_torch.render.tri_kernel import TileLists, longest_first

    pos = torch.arange(lists.ids.shape[-1], device=lists.ids.device)
    ids = torch.where(pos < counts[..., None], lists.ids, -1).contiguous()
    nst = torch.clamp(-(-counts // lists.chunk), min=1).to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    return TileLists(ids, nst, lists.lb, lists.chunk, 1, count=counts,
                     order=longest_first(counts))


def ragged_lists(lists, pattern=RAGGED_COUNTS):
    """A synthetic list set from a plan's per-triangle lists: tile i keeps the
    first ``pattern[i % len(pattern)]`` slots of its own list, at most the cap
    (an empty tile, a count on a stage boundary, one a slot past it, a tile at
    the cap, one triangle), the rest emptied (:func:`kept_lists`)."""
    import torch

    cap = lists.ids.shape[-1]
    per = torch.tensor([min(c, cap) for c in pattern], dtype=torch.int32, device=lists.ids.device)
    tiles = lists.n_stage.shape[1]
    counts = per[torch.arange(tiles, device=per.device) % len(pattern)].expand_as(lists.n_stage)
    return kept_lists(lists, counts.contiguous())


def ragged_blocks(lists, pattern=RAGGED_BLOCKS):
    """A synthetic set from a plan's block lists: tile i keeps the first
    ``pattern[i % len(pattern)]`` of the blocks it sees, the rest emptied (-1)
    and its stages cut to those (at least one), with the count and the
    longest-first order of what is left."""
    import torch

    from visfly_tpu_torch.render.tri_kernel import longest_first

    per = torch.tensor(pattern, dtype=torch.int32, device=lists.ids.device)
    tiles = lists.n_stage.shape[1]
    want = per[torch.arange(tiles, device=per.device) % len(pattern)].expand_as(lists.n_stage)
    blocks = torch.minimum(want, lists.count // lists.chunk)
    entries = torch.arange(lists.ids.shape[-1], device=per.device)
    ids = torch.where(entries < blocks[..., None], lists.ids, -1).contiguous()
    count = (blocks * lists.chunk).to(torch.int32).contiguous()
    return lists._replace(ids=ids, n_stage=torch.clamp(blocks, min=1).to(torch.int32).contiguous(),
                          count=count, order=longest_first(count))


def list_report(mode, case, args, var, card, b_ms, b_by, n_rays, full=True):
    """B7a's or B7c's list walk against the cluster walk it replaced, on one
    use of it: equal to the walk at k = 1 and at the k the wrapper would pick
    for it, in index order and longest first (:func:`same_result`), and the
    device time (:func:`device_ms`) of the list walk and of the cluster walk
    at k in index order (the design before), beside the bound, with registers
    and blocks an SM; ``full`` also times the cluster walk at k = 1 in index
    order and at k in the lists' longest-first order -> the list walk's
    device ms."""
    from visfly_tpu_torch.render import tri_first_hit
    from visfly_tpu_torch.render.tri_kernel import (TILE, TILE_BLOCK_RAYS, default_split,
                                                    occupancy, stage_parts, tile_occupancy)

    tris, lists, o_c, d_c, max_depth, form, origin_tiles = args
    k = default_split(lists, form, var, o_c.device)
    index = (tris, lists._replace(order=None), *args[2:])
    new = tri_first_hit(*args, mode=var)
    one = tri_first_hit(*index, mode=var, split=1)
    check(same_result(new, one), f"{mode} {case}: the list walk differs from the cluster walk at "
                                 "k = 1")
    for a, kk in ((index, k), (args, 1), (args, k)):
        check(same_result(tri_first_hit(*a, mode=var, split=kk), one),
              f"{mode} {case}: the cluster walk at k = {kk} differs from k = 1")
    runs = [("old k = 1", index, {"split": 1})] if full else []
    runs += [("new", args, {}), ("old k", index, {"split": k})]
    runs += [("ordered k", args, {"split": k})] if full else []
    times = {}
    for name, a, kw in runs:
        times[name] = device_ms(lambda: tri_first_hit(*a, mode=var, **kw))
    old = min(t for name, t in times.items() if name.startswith("old"))
    check(times["new"] <= old,
          f"{mode} {case}: the list walk ({times['new']:.4f} ms) is slower than the cluster walk "
          f"in index order ({old:.4f} ms)")
    occ_t = tile_occupancy(form, o_c.device, var)
    occ_c = occupancy(form, var, device=o_c.device)
    check(occ_t["rays"] == TILE_BLOCK_RAYS, f"the list walk's blocks take {occ_t['rays']} rays, "
                                            f"TILE_BLOCK_RAYS says {TILE_BLOCK_RAYS}")
    n_blocks = lists.n_stage.numel() * (TILE // TILE_BLOCK_RAYS)
    parts = stage_parts(n_blocks, occ_t["blocks_per_sm"] * occ_t["sms"])
    more = (f"{times['old k = 1']:.4f} ms at k = 1 (share {b_ms / times['old k = 1']:.3f}), "
            if full else "")
    last = f"; at k = {k} longest first {times['ordered k']:.4f} ms" if full else ""
    print(f"phase 3 | {mode} {case} at {n_rays} rays, on the device: list walk "
          f"{times['new']:.4f} ms ({occ_t['threads']} threads x {occ_t['rays'] // occ_t['threads']}"
          f" rays a block, {parts} stage shares a tile, {n_blocks * parts} blocks, "
          f"{occ_t['regs']} registers, {occ_t['blocks_per_sm']} blocks an SM), "
          f"share of bound {b_ms / times['new']:.3f}; the cluster walk in index order {more}"
          f"{times['old k']:.4f} ms at the k = {k} it would pick ({occ_c['regs']} registers, "
          f"{occ_c['blocks_per_sm']} blocks an SM, share {b_ms / times['old k']:.3f}){last}; "
          f"bound {b_ms:.4f} ms by {b_by}; equal to the cluster walk at k = 1 and k = {k} | "
          f"{card}", flush=True)
    return times["new"]


def tile_report(mode, case, args, card, b_ms, b_by, n_rays):
    """B4's tile kernel against the cluster walk it replaced, on one use of
    it: equal to the walk at k = 1 and at the k the wrapper would pick for it
    (:func:`same_result`), and the device time of each (:func:`device_ms`)
    beside the bound, with registers and blocks an SM → the tile kernel's
    device ms."""
    from visfly_tpu_torch.render import tri_first_hit
    from visfly_tpu_torch.render.tri_kernel import (TILE_BLOCK_RAYS, default_split, occupancy,
                                                    tile_occupancy)

    tris, lists, o_c, d_c, max_depth, form, origin_tiles = args
    k = default_split(lists, form, "scalar", o_c.device)
    new = tri_first_hit(*args)
    one = tri_first_hit(*args, split=1)
    at_k = tri_first_hit(*args, split=k)
    check(same_result(new, one), f"{mode} {case}: the tile kernel differs from the cluster walk "
                                 "at k = 1")
    check(same_result(at_k, one), f"{mode} {case}: k = {k} differs from k = 1")
    times = {}
    for name, kw in (("old k = 1", {"split": 1}), ("new", {}), (f"old k = {k}", {"split": k})):
        times[name] = device_ms(lambda: tri_first_hit(*args, **kw))
    check(times["new"] <= min(times["old k = 1"], times[f"old k = {k}"]),
          f"{mode} {case}: the tile kernel ({times['new']:.4f} ms) is slower than the cluster "
          f"walk ({times['old k = 1']:.4f} ms at k = 1, {times[f'old k = {k}']:.4f} at k = {k})")
    occ_t, occ_c = tile_occupancy(form, o_c.device), occupancy(form, device=o_c.device)
    check(occ_t["rays"] == TILE_BLOCK_RAYS, f"the tile kernel's blocks take {occ_t['rays']} rays, "
                                            f"TILE_BLOCK_RAYS says {TILE_BLOCK_RAYS}")
    print(f"phase 3 | {mode} {case} at {n_rays} rays, on the device: tile kernel "
          f"{times['new']:.4f} ms ({occ_t['threads']} threads x {occ_t['rays'] // occ_t['threads']}"
          f" rays a block, {occ_t['regs']} registers, {occ_t['blocks_per_sm']} blocks an SM), "
          f"share of bound {b_ms / times['new']:.3f}; the cluster walk {times['old k = 1']:.4f} ms "
          f"at k = 1, {times[f'old k = {k}']:.4f} at the k = {k} it would pick ({occ_c['regs']} "
          f"registers, {occ_c['blocks_per_sm']} blocks an SM), shares "
          f"{b_ms / times['old k = 1']:.3f}, {b_ms / times[f'old k = {k}']:.3f}; bound {b_ms:.4f} "
          f"ms by {b_by}; equal to the cluster walk at k = 1 and k = {k} | {card}", flush=True)
    return times["new"]


def triangle_phase(level, env, state, card, errs, timing):
    """Phase 3 for one mesh size: each sensor's kernel use against its plain
    version on the same lists, at the full ray count; against the brute force
    on 8 cameras; the gradient; the times."""
    import torch

    from visfly_tpu_torch.render import (default_tri_cap, tri_first_hit, tri_first_hit_reference,
                                         tri_trace_brute, tri_trace_diff, tri_trace_tiled)
    from visfly_tpu_torch.render.tri_kernel import count_name, tile_route
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    tris = env.scene.triangles
    T = tris.shape[1]
    cap = default_tri_cap(T)
    for sensor, spec in enumerate(env.sensor_kwargs):
        h, w = spec["resolution"]
        o_c, d_c, img_w, cam_rays = mesh_camera_rays(env, state, sensor)
        n_rays = o_c.shape[2]
        plan = plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap, img_w, cam_rays)
        mode = count_name(plan.form, plan.lists.block)
        check(mode == PATH_D[level][1][spec["uuid"]], f"T={T} {h}x{w}: tier {mode}")
        args = (tris, plan.lists, plan.origins_c, plan.dirs_c, MAX_DEPTH, plan.form,
                plan.origin_tiles)
        t_k, hit_k, gid_k = tri_first_hit(*args)
        stats = {}
        t_p, hit_p, gid_p = tri_first_hit_reference(*args, stats=stats)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(t_k).all()), f"{mode} T={T}: non-finite kernel output")
        both = hit_k & hit_p
        err = float((t_k - t_p).abs()[both].max()) if bool(both.any()) else 0.0
        flip = float((hit_k != hit_p).float().mean())
        gid_off = float(((gid_k != gid_p) & both).float().mean())
        lists = plan.lists
        overflow = float((lists.n_stage >= lists.lb.shape[2]).float().mean())
        print(f"phase 3 | {mode} T={T} {h}x{w}: rays={n_rays} tiles={n_rays // 1024} "
              f"stages<= {lists.lb.shape[2]} of {lists.chunk} hit={float(hit_k.float().mean()):.4f} "
              f"max|dt|={err:.3e} m hit_mismatch={flip:.3e} id_mismatch={gid_off:.3e} | "
              f"{stats['tests'] / n_rays:.1f} slots a ray staged, {stats['real_tests'] / n_rays:.1f} "
              f"tests a ray on triangles, {stats['gated'] / n_rays:.2f} past the gate, "
              f"{stats['divided'] / n_rays:.2f} divide, tiles at their cap {overflow:.4f}",
              flush=True)
        check(err <= T_TOL, f"{mode} T={T}: max |dt| {err} > {T_TOL}")
        check(flip <= HIT_TOL, f"{mode} T={T}: hit mismatch {flip} > {HIT_TOL}")
        check(gid_off <= HIT_TOL, f"{mode} T={T}: id mismatch {gid_off} > {HIT_TOL}")
        tile = tile_route(plan.form, lists)
        if tile:  # the bound counts the tests on the slots the tile kernel walks
            kept = kept_lists(lists, lists.count)
            kept_args = (tris, kept, *args[2:])
            stats = {}
            plain_kept = tri_first_hit_reference(*kept_args, stats=stats)
            # ids where not tied: on the card the plain version's torch.min
            # may take either of two equal t
            d_t = int((plain_kept[0] != t_p).sum())
            d_hit = int((plain_kept[1] != hit_p).sum())
            d_id = int((not_tied(tris, plan.origins_c, plan.dirs_c, plain_kept[2], gid_p)
                        & hit_p).sum())
            check(d_t == d_hit == d_id == 0,
                  f"{mode} T={T}: the slots past the tiles' counts change the plain version "
                  f"({d_t} t, {d_hit} hit flags, {d_id} untied ids differ)")

        # against every triangle, on 8 cameras, with lists that hold the mesh
        r8 = 8 * h * w
        o8, d8 = o_c[:, :, :r8].contiguous(), d_c[:, :, :r8].contiguous()
        t_b, hit_b, _, gid_b = tri_trace_brute(tris, o8.permute(1, 2, 0), d8.permute(1, 2, 0),
                                               MAX_DEPTH)
        for cap_b, name in ((T, "lists of the whole mesh"), (cap, f"the default cap {cap}")):
            t_t, hit_t, _, gid_t = tri_trace_tiled(tris, o8, d8, MAX_DEPTH, cap_b, img_w, cam_rays)
            bb = hit_t & hit_b
            e_b = float((t_t - t_b).abs()[bb].max())
            f_b = float((hit_t != hit_b).float().mean())
            g_b = float((not_tied(tris, o8, d8, gid_t, gid_b) & bb).float().mean())
            lost = float((hit_b & ~hit_t).float().mean())
            print(f"phase 3 | {mode} T={T} {h}x{w} vs brute force on 8 cameras, {name}: "
                  f"max|dt|={e_b:.3e} m hit_mismatch={f_b:.3e} (far hits lost {lost:.3e}) "
                  f"untied id_mismatch={g_b:.3e}", flush=True)
            if cap_b == T:
                check(e_b <= T_TOL, f"{mode} T={T} vs brute: max |dt| {e_b} > {T_TOL}")
                check(f_b <= HIT_TOL, f"{mode} T={T} vs brute: hit mismatch {f_b} > {HIT_TOL}")
                check(g_b <= HIT_TOL, f"{mode} T={T} vs brute: id mismatch {g_b} > {HIT_TOL}")
            else:  # overflow only ever turns far geometry into background
                check(bool((t_t >= t_b - T_TOL).all()), f"{mode} T={T}: a nearer hit at the cap")

        # the gradient through the kernel forward against the closed form on
        # the plain forward's t, hit and ids (its t taken on the winner's
        # plane for the signed-volume bodies, as tri_trace_tiled takes it)
        from visfly_tpu_torch.render import normals_from_gid
        from visfly_tpu_torch.render.tri_trace import _winner_plane_t

        g_t = torch.randn((1, n_rays), device=o_c.device,
                          generator=torch.Generator(device=o_c.device).manual_seed(3))
        o_in, d_in = o_c.clone().requires_grad_(True), d_c.clone().requires_grad_(True)
        t_d = tri_trace_diff(tris, o_in, d_in, MAX_DEPTH, cap, img_w, True, cam_rays)[0]
        g_o, g_d = torch.autograd.grad((t_d * g_t).sum(), (o_in, d_in))
        unpack = plan.unpack or (lambda y: y)
        n_p = normals_from_gid(tris, gid_p, plan.dirs_c.permute(1, 2, 0), hit_p)
        if plan.form != "mt":
            t_p = _winner_plane_t(tris, gid_p, plan.origins_c.permute(1, 2, 0),
                                  plan.dirs_c.permute(1, 2, 0), hit_p, t_p, MAX_DEPTH)
        t_u, hit_u, n_u = unpack(t_p), unpack(hit_p), unpack(n_p)
        denom = (n_u * d_c.permute(1, 2, 0)).sum(-1)
        scale = torch.where(hit_u & (denom.abs() > 1e-3), 1.0 / denom, 0.0)
        r_o = -((g_t * scale)[..., None] * n_u).permute(2, 0, 1)
        r_d = r_o * t_u
        rel = max(float((g - r).abs().max() / r.abs().max()) for g, r in ((g_o, r_o), (g_d, r_d)))
        check(bool(torch.isfinite(g_o).all()) and float(g_o.abs().max()) > 0,
              f"{mode} T={T}: gradient zero or not finite")
        check(rel <= GRAD_TOL, f"{mode} T={T}: gradient differs by {rel} > {GRAD_TOL}")

        ms = cuda_ms(lambda: tri_first_hit(*args))  # at the split the wrapper picks
        prepass_ms = cuda_ms(lambda: plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap, img_w, cam_rays),
                             reps=10)
        plain_ms = cuda_ms(lambda: tri_first_hit_reference(*args), reps=3, warmup=1)
        b_ms, b_by, by_bytes = tri_bound_ms(plan.form, stats, n_rays, lists, plan.form == "mt")
        print(f"phase 3 | {mode} T={T} {h}x{w} at {n_rays} rays: kernel {ms:.4f} ms, prepass "
              f"{prepass_ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by} "
              f"(bytes {by_bytes:.4f}; {stats['real_tests'] / n_rays:.1f} tests a ray"
              f"{' on the real slots' if tile else ''}); gradient max relative difference "
              f"{rel:.3e} | {card}", flush=True)
        dev_ms = None
        if tile:  # B4's tile kernel against the cluster walk it replaced
            dev_ms = tile_report(mode, f"T={T} {h}x{w}", args, card, b_ms, b_by, n_rays)
        else:  # a tile's stages split over a cluster of k blocks, against one block
            split_report(mode, f"T={T} {h}x{w}", args, plan, ms, b_ms, card)
        errs[mode] = max(errs.get(mode, 0.0), err)
        if level in (0, 3):  # the sizes whose numbers stand in the kernels line
            timing[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                **({"device_ms": dev_ms} if tile else {}))
        if level == 0:  # the synthetic ragged lists on the same rays
            ragged_phase(mode, f"T={T} {h}x{w}", args, card, errs)


def ragged_phase(mode, case, args, card, errs):
    """B4's tile kernel on :func:`ragged_lists` cut from the plan's lists:
    against its plain version (the kernel limits), the same lists with the
    counts derived from the ids, and the cluster walk (:func:`tile_report`)."""
    from visfly_tpu_torch.render import tri_first_hit, tri_first_hit_reference

    tris, lists, *rest = args
    ragged = ragged_lists(lists)
    r_args = (tris, ragged, *rest)
    stats = {}
    out = tri_first_hit(*r_args)
    err = agree(f"{mode} {case} ragged lists {list(RAGGED_COUNTS)} vs plain", out,
                tri_first_hit_reference(*r_args, stats=stats))
    check(same_result(tri_first_hit(tris, ragged._replace(count=None), *rest), out),
          f"{mode} {case} ragged lists: the counts derived from the ids differ")
    n_rays = rest[0].shape[2]
    b_ms, b_by, _ = tri_bound_ms(rest[3], stats, n_rays, ragged, rest[3] == "mt")
    tile_report(mode, f"{case} ragged lists", r_args, card, b_ms, b_by, n_rays)
    errs[mode] = max(errs.get(mode, 0.0), err)


def drive(env, gen_seed, n_chunks, chunk, expect):
    """Reset, one warm-up chunk, ``n_chunks`` timed chunks with every
    observation consumed. ``expect(steps)`` → {mode: launches} of the whole
    run, reset and warm-up included; modes it leaves out must not launch.
    Returns (state, last output, env steps/s, launches by mode, timed s)."""
    import torch

    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    act_gen = torch.Generator(device=dev).manual_seed(gen_seed + 1)
    n = env.num_agent
    reset_launches()
    state, obs = env.reset(gen)
    carried = torch.zeros((), device=dev)

    def run(state, carried):
        for _ in range(chunk):
            a = torch.rand((n, 4), generator=act_gen, device=dev) * 0.6 - 0.3
            state, out = env.step(state, a)
            obs_sum = sum(v.float().sum() for v in out.obs.values())
            carried = carried + out.reward.sum() + obs_sum * 1e-12
        return state, carried, out

    state, carried, out = run(state, carried)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        state, carried, out = run(state, carried)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = all_launches()
    steps = chunk * (n_chunks + 1)
    want = {k: 0 for k in launches}
    want.update(expect(steps))
    check(launches == want, f"kernel launches {launches} != expected {want}")
    check(bool(torch.isfinite(carried)), "carried sum is not finite")
    check(bool(torch.isfinite(out.obs["state"]).all()), "state obs not finite")
    return state, out, n * chunk * n_chunks / dt, launches, dt


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


def card_vs_cpu(env, env_cpu, state, seed):
    """One ``is_test`` step from ``state`` on the card and on the CPU."""
    import torch

    a = torch.rand((env.num_agent, 4), device=env.device,
                   generator=torch.Generator(device=env.device).manual_seed(seed)) * 0.6 - 0.3
    state_cpu = to_device(state, "cpu", torch.Generator().manual_seed(0))
    _, out_gpu = env.step(state, a, is_test=True)
    _, out_cpu = env_cpu.step(state_cpu, a.cpu(), is_test=True)
    s_err = float((out_gpu.obs["state"].cpu() - out_cpu.obs["state"]).abs().max())
    check(s_err <= OBS_TOL, f"state obs card vs cpu {s_err} > {OBS_TOL}")
    return out_gpu, out_cpu, s_err


def training_paths(dev, card, launches):
    """Paths G-J, the trainers at their published widths; adds each path's
    launches to ``launches`` → path G's trainer and its state after the
    timed updates (path N resumes it)."""
    import torch

    # path G: the default training run, PPO on cluttered_flight; B1 renders
    # twice a step (the terminal observation before the auto-reset, the
    # observation after it) and once at the reset
    from visfly_tpu_torch.algos import APG, PPO, SAC, SHAC
    from visfly_tpu_torch.envs import NavigationEnv, NavigationEnv2

    def report_train(name, counts, what):
        used = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            launches[k] += v
        print(f"phase 4 | {name}: {used or 'no kernel'} launches | {what} | {card}", flush=True)

    tr_g = PPO(NavigationEnv(device=dev, **CLUTTERED_FLIGHT), **PPO_TUNED)
    parts = timed_parts(tr_g, ("_collect", "_advantages", "_train_flat"))
    n_env, n_steps, n_timed = tr_g.env.num_envs, tr_g.n_steps, 1
    reset_launches()
    st = tr_g.init(torch.Generator(device=dev).manual_seed(90))
    before = snapshot(tr_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        st, m = tr_g.update(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_launches()
    want = {k: 0 for k in counts}
    want["trace_analytic"] = 1 + 2 * n_steps * n_timed
    check(counts == want, f"path G: kernel launches {counts} != expected {want}")
    check_trained("path G", tr_g, st, m, before, "loss", dev)
    check(tr_g.n_minibatches == 1 and tr_g.env.terminal_obs_in_info, "path G: PPO's layout")
    check(st.obs["depth"].shape == (n_env, 1, *RES), "path G: depth shape")
    ms = {k: v / n_timed * 1e3 for k, v in parts.items()}
    report_train(
        "path G (PPO, cluttered_flight)", counts,
        f"{dt / n_timed * 1e3:.1f} ms an update ({n_env} agents x {n_steps} steps, 64x64 "
        f"depth, {tr_g.n_epochs} epochs of 1 minibatch of {n_env * n_steps}): rollout "
        f"{ms['_collect']:.1f} ms, GAE {ms['_advantages']:.1f} ms, epochs "
        f"{ms['_train_flat']:.1f} ms; {n_env * n_steps / (ms['_collect'] / 1e3):.1f} env steps/s "
        f"of the rollout; trace_analytic {counts['trace_analytic'] - 1} launches in "
        f"{n_timed} update = 2 x {n_steps} x {n_timed}; loss {float(m['loss']):.4f}, "
        f"gradient norm {float(m['grad_norm']):.4f}, approx KL {float(m['approx_kl']):.5f}")
    st_g = st

    # paths H and I: SHAC and APG through the differentiable navigation2 env,
    # the garage for collisions, no camera: no kernel
    for name, cls, cfg, loss_key, still in (
            ("path H (SHAC, navigation2)", SHAC, SHAC_NAV2, "actor_loss", ()),
            # the deterministic actor never uses its log-std head
            ("path I (APG, navigation2)", APG, APG_NAV2, "loss",
             ("actor.head.log_std.weight", "actor.head.log_std.bias"))):
        tr = cls(NavigationEnv2(device=dev, **NAVIGATION2), **cfg)
        n_timed = 1
        reset_launches()
        st = tr.init(torch.Generator(device=dev).manual_seed(100))
        st, m = tr.update(st)
        before = snapshot(tr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            st, m = tr.update(st)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = all_launches()
        check(not any(counts.values()), f"{name}: launched {counts}")
        check_trained(name, tr, st, m, before, loss_key, dev, still)
        check(st.global_step == tr.H * tr.env.num_envs * (n_timed + 1), f"{name}: global_step")
        extra = f", critic loss {float(m['critic_loss']):.4f}" if cls is SHAC else ""
        report_train(name, counts,
                     f"{dt / n_timed * 1e3:.1f} ms an update ({tr.env.num_envs} agents, "
                     f"H={tr.H}), {tr.H * tr.env.num_envs * n_timed / dt:.1f} agent steps/s; "
                     f"loss {float(m[loss_key]):.4f}{extra}, gradient norm "
                     f"{float(m['grad_norm']):.4f}")

    # path J: SAC, collecting until ``learning_starts`` transitions are stored,
    # then training at every env step, as ``SAC.learn`` decides
    tr_j = SAC(NavigationEnv2(device=dev, **dict(NAVIGATION2, **SAC_NAV2_ENV)), **SAC_NAV2)
    n_env = tr_j.env.num_envs
    reset_launches()
    st = tr_j.init(torch.Generator(device=dev).manual_seed(110))
    n_collect = -(-tr_j.learning_starts // n_env)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_collect):
        check(i * n_env < tr_j.learning_starts, "path J: training before learning_starts")
        st, m = tr_j.step_and_train(st, False)
    torch.cuda.synchronize()
    dt_collect = time.perf_counter() - t0
    before = snapshot(tr_j)
    alpha0 = float(tr_j.log_alpha.detach())
    n_train = 4
    t0 = time.perf_counter()
    for i in range(n_collect, n_collect + n_train):
        st, m = tr_j.step_and_train(st, i * n_env >= tr_j.learning_starts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_launches()
    check(not any(counts.values()), f"path J: launched {counts}")
    check_trained("path J", tr_j, st, m, before, "actor_loss", dev)
    check(bool(torch.isfinite(m["critic_loss"])) and float(tr_j.log_alpha.detach()) != alpha0,
          "path J: critic loss or temperature")
    check(st.buffer.pos == n_env * (n_collect + n_train) and not st.buffer.full,
          "path J: replay ring position")
    report_train("path J (SAC, navigation2)", counts,
                 f"{dt / n_train * 1e3:.1f} ms a training env step ({n_env} agents, "
                 f"{tr_j.gradient_steps} gradient steps of {tr_j.batch_size}), "
                 f"{dt_collect / n_collect * 1e3:.1f} ms a collecting step ({n_collect} steps to "
                 f"{tr_j.learning_starts} transitions); critic loss "
                 f"{float(m['critic_loss']):.4f}, actor loss {float(m['actor_loss']):.4f}, alpha "
                 f"{float(m['alpha']):.4f}, gradient norm {float(m['grad_norm']):.4f}")
    return tr_g, st_g


def cpu_view(env):
    """What ``render_global`` reads of an env, with its scene on the CPU."""
    import torch

    return types.SimpleNamespace(scene=to_device(env.scene, "cpu", None), bbox=env.bbox.cpu(),
                                 device=torch.device("cpu"))


def payload_diff(a, b):
    """(bitwise equal, largest elementwise difference) of two checkpoint
    payloads (``utils.checkpoint.to_payload``) of one structure."""
    import torch

    if isinstance(a, torch.Tensor):
        if torch.equal(a, b):
            return True, 0.0
        d = (a.double() - b.double()).abs().max() if a.numel() else torch.zeros(())
        return False, float(d)
    if isinstance(a, dict):
        parts = [payload_diff(a[k], b[k]) for k in a]
    elif isinstance(a, (list, tuple)):
        parts = [payload_diff(x, y) for x, y in zip(a, b)]
    else:
        return a == b, 0.0 if a == b else float("inf")
    return all(p[0] for p in parts), max((p[1] for p in parts), default=0.0)


def global_view_check(name, env, state, kw, card):
    """One global view on the card (one ``trace_analytic_kid`` launch)
    against the same render from CPU copies of the scene and the state →
    the frame."""
    import torch

    from visfly_tpu_torch.render.global_view import render_global

    reset_launches()
    img = env.render(state, **kw)
    torch.cuda.synchronize()
    counts = all_launches()
    want = {k: 0 for k in counts}
    want["trace_analytic_kid"] = 1
    check(counts == want, f"path N {name}: kernel launches {counts} != expected {want}")
    ref = render_global(cpu_view(env), to_device(state, "cpu", torch.Generator()), **kw)
    off = float((img != ref).any(-1).mean())
    print(f"phase 5 | path N global view {name} ({img.shape[0]}x{img.shape[1]}) card vs cpu: "
          f"colour differs on {off:.3e} of pixels; std {img.std():.1f} | {card}", flush=True)
    check(img.shape == (480, 640, 3) and img.dtype.name == "uint8", f"{name}: frame {img.shape}")
    check(off <= COLOR_TOL, f"path N {name}: colour card vs cpu differs on {off} of pixels")
    check(img.std() > 5, f"path N {name}: blank frame")
    return img, counts


def experiment_layer_path(dev, card, launches, errs, timing, tr_g, st_g):
    """Path N, the experiment layer at path G's width: path G's state saved,
    continued through ``learn(log_dir=...)`` and resumed in a fresh trainer
    (held to the continuation); ``python -m visfly_tpu_torch.run`` training
    one update and evaluating its checkpoint; the global view of the
    evaluation's last state through B1-kid at 480×640, held to the CPU and
    the kernel to its plain version; the crossing env's scene 0. Adds the
    launches to ``launches`` and B1-kid's error at the view to ``errs``."""
    import torch

    from visfly_tpu_torch import run
    from visfly_tpu_torch.algos import PPO
    from visfly_tpu_torch.envs import MultiNavigationEnv, NavigationEnv
    from visfly_tpu_torch.render import camera_rays_components, prepare_kernel_scene
    from visfly_tpu_torch.render import global_view as gv
    from visfly_tpu_torch.render.trace_kernel import cull_rows
    from visfly_tpu_torch.utils.checkpoint import to_payload

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
        return {k: v for k, v in counts.items() if v}

    t_path = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="visfly_path_n_")
    cwd = os.getcwd()
    deterministic = torch.backends.cudnn.deterministic
    try:
        # 1. exact resume: save, continue through learn (the logger), resume.
        # cuDNN's convolution backward may accumulate in another order each
        # run, and Adam turns such a difference in a near-zero gradient entry
        # into a move of up to lr (ROADMAP Queue C, "Adam and parity"): both
        # updates take cuDNN's deterministic algorithms, so that the
        # comparison sees the resume alone
        torch.backends.cudnn.deterministic = True
        per = tr_g.n_steps * tr_g.env.num_envs
        reset_launches()
        ckpt = tr_g.save(st_g, os.path.join(work.name, "path_g"))
        log_dir = os.path.join(work.name, "logs")
        st_cont = tr_g.learn(total_timesteps=per, state=st_g, log_dir=log_dir)
        with open(os.path.join(log_dir, "progress.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 1 and {"train/loss", "time/fps"} <= set(rows[0]),
              f"path N: progress.csv rows {rows}")
        tr_r = PPO(NavigationEnv(device=dev, **CLUTTERED_FLIGHT), seed=7, **PPO_TUNED)
        st_r = tr_r.load(tr_r.init(torch.Generator(device=dev).manual_seed(91)), ckpt)
        st_res, m_res = tr_r.update(st_r)
        torch.cuda.synchronize()
        counts = all_launches()
        want = {k: 0 for k in counts}
        want["trace_analytic"] = 2 * 2 * tr_g.n_steps + 1
        check(counts == want, f"path N resume: kernel launches {counts} != expected {want}")
        torch.backends.cudnn.deterministic = deterministic
        d_loss = abs(float(m_res["loss"]) - float(rows[0]["train/loss"]))
        p_l2, worst = max((float(torch.linalg.vector_norm(p.detach() - q.detach())
                                 / torch.linalg.vector_norm(q.detach())), name)
                          for (name, p), q in zip(tr_r.policy.named_parameters(),
                                                  tr_g.policy.parameters()))
        gens = (torch.equal(st_res.gen.get_state(), st_cont.gen.get_state())
                and torch.equal(st_res.env_state.gen.get_state(),
                                st_cont.env_state.gen.get_state()))
        count_eq = st_res.opt_state.count == st_cont.opt_state.count
        bitwise, elem = payload_diff(to_payload(tuple(st_res)), to_payload(tuple(st_cont)))
        print(f"phase 5 | path N exact resume ({tr_g.env.num_envs} agents x {tr_g.n_steps} "
              f"steps, checkpoint {os.path.getsize(ckpt)} bytes, cuDNN deterministic): |d loss|="
              f"{d_loss:.3e}, parameters l2 relative difference {p_l2:.3e} (largest at "
              f"{worst}), generators equal {gens}, "
              f"AdamChain.count {st_res.opt_state.count} / {st_cont.opt_state.count}, state "
              f"bitwise equal {bitwise}, largest elementwise difference {elem:.3e}; "
              f"progress.csv carries train/loss and time/fps; {add(counts)} launches | {card}",
              flush=True)
        check(d_loss <= 1e-5, f"path N resume: loss off by {d_loss} > 1e-5")
        check(p_l2 <= GRAD_TOL, f"path N resume: parameters off by {p_l2} > {GRAD_TOL} (l2)")
        check(gens and count_eq, "path N resume: generator states or AdamChain.count differ")
        del tr_r, st_r, st_res, st_cont

        # 2. the runner trains one update of the default run and saves it
        os.chdir(work.name)
        reset_launches()
        t0 = time.perf_counter()
        trained = run.main(["-t", "1", "-e", "cluttered_flight", "-a", "PPO_tuned", "-n",
                            str(per), "-c", "smoke"])
        torch.cuda.synchronize()
        dt_train = time.perf_counter() - t0
        counts = all_launches()
        want = {k: 0 for k in counts}
        want["trace_analytic"] = 1 + 2 * tr_g.n_steps
        check(counts == want, f"path N run -t 1: kernel launches {counts} != expected {want}")
        path = trained["checkpoint"]
        check(path == os.path.join(work.name, "saved", "cluttered_flight", "PPO_smoke_1.pt")
              and os.path.isfile(path), f"path N: checkpoint {path}")
        print(f"phase 4 | path N (python -m visfly_tpu_torch.run -t 1 -e cluttered_flight -a "
              f"PPO_tuned -n {per}): {add(counts)} launches = 1 + 2 x {tr_g.n_steps} | "
              f"{dt_train:.1f} s; checkpoint {os.path.getsize(path)} bytes | {card}", flush=True)
        del trained

        # 3. the runner evaluates the checkpoint in the eval env
        reset_launches()
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            ev = run.main(["-t", "0", "-e", "cluttered_flight", "-a", "PPO_tuned", "-w", path])
        torch.cuda.synchronize()
        dt_eval = time.perf_counter() - t0
        sys.stdout.write(printed.getvalue())
        counts = all_launches()
        tester, stats = ev["tester"], ev["stats"]
        steps = len(tester.last_record["done"])
        want = {k: 0 for k in counts}
        # PPO switches its env to the terminal observation, the eval env too
        # (as the JAX trainer does): two renders a step, and one at each of
        # the two resets (the trainer's init, then the rollout's)
        want["trace_analytic"] = 2 + 2 * steps
        check(counts == want, f"path N run -t 0: kernel launches {counts} != expected {want}")
        check(tester.env.num_envs == 4, f"path N: eval env of {tester.env.num_envs} agents")
        check("['env_state', 'obs']" in printed.getvalue(),
              "path N: the load did not report the env fields it kept")
        check(all(os.path.isfile(f) for f in tester.files) and len(tester.files) >= 1,
              f"path N: files {tester.files}")
        check(0 <= stats["success_rate"] <= 1 and math.isfinite(stats["mean_return"]),
              f"path N: stats {stats}")
        print(f"phase 4 | path N (run -t 0 -w PPO_smoke_1.pt): {add(counts)} launches = 2 + 2 x "
              f"{steps} steps | {dt_eval:.1f} s; success rate {stats['success_rate']:.4f}, mean "
              f"return {stats['mean_return']:.4f}, mean length {stats['mean_length']:.1f}; wrote "
              f"{[os.path.relpath(f, work.name) for f in tester.files]} | {card}", flush=True)

        # 4. the global view of the evaluation's last state, 480×640 colour
        env_e, st_e = tester.env, tester.last_state
        traj = tester.last_record["position"]
        views = {"top": dict(view="top", trajectory=True, traj_history=traj),
                 "near": dict(view="near", traj_history=traj, velocity=True, collision=True,
                              axes=True)}
        for name, kw in views.items():
            add(global_view_check(name, env_e, st_e, kw, card)[1])
        # B1-kid at the top view's rays against its plain version, timed
        focus = st_e.dyn.pos.mean(0).cpu().numpy()
        eye, look = gv._camera_pose("top", env_e.bbox.cpu().numpy(), focus)
        q = gv._look_at_quat(eye.astype("float64"), look.astype("float64"))
        spec = {"sensor_type": "color", "resolution": [480, 640], "hfov": 90.0, "tile": 1}
        o_c, d_c, _ = camera_rays_components(
            spec, torch.tensor(eye, dtype=torch.float32, device=dev)[None],
            torch.tensor(q, dtype=torch.float32, device=dev)[None])
        n_rays = 480 * 640
        o = o_c[:, :, None].expand(3, 1, n_rays).contiguous()
        d = d_c.reshape(3, 1, n_rays).contiguous()
        ks = prepare_kernel_scene(gv.scene_zero(env_e.scene))
        kernel, plain = kernel_modes(None, 640)["trace_analytic_kid"]
        errs["trace_analytic_kid"] = max(errs["trace_analytic_kid"], compare(
            "trace_analytic_kid", "the 480x640 global view (cull without frustum planes)",
            kernel, plain, ks, o, d))
        call = lambda: kernel(ks, o, d)  # noqa: E731
        ms = cuda_ms(call)
        dev_ms = device_ms(call)
        plain_ms = cuda_ms(lambda: plain(ks, o, d))
        b_ms, b_by = bound_ms("trace_analytic_kid", ks, n_rays,
                              plan=cull_rows(ks, o, d, MAX_DEPTH, 640), o=o)
        a = timing["trace_analytic_kid"]
        print(f"phase 3 | trace_analytic_kid at the 480x640 global view ({n_rays} rays, one "
              f"camera): kernel {ms:.4f} ms (CUDA events around the call; on the device "
              f"{dev_ms:.4f} ms, 20 calls queued behind a spin), plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}, share {b_ms / ms:.4f} (device "
              f"{b_ms / dev_ms:.4f}); path "
              f"A's at 1048576 rays: device {a['device_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms "
              f"by {a['bound_by']} | {card}", flush=True)

        # the crossing env's scene: 24 scenes, the view renders scene 0
        env_x = MultiNavigationEnv(device=dev, **CROSSING)
        st_x, _ = env_x.reset(torch.Generator(device=dev).manual_seed(130))
        add(global_view_check("crossing top (scene 0 of 24)", env_x, st_x, dict(view="top"),
                              card)[1])
        print(f"phase 4 | path N (the experiment layer): {time.perf_counter() - t_path:.1f} s | "
              f"{card}", flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        os.chdir(cwd)
        work.cleanup()


# path L: ``DynEnv`` amid moving objects; ``spheres`` are template-less
# circle objects, which enter the analytic kernel's scene as dynamic capsules;
# ``mixed`` adds a drone and a human template, and then every object of the
# env is intersected after the kernel (templates, and the spheres as their
# fallback), as in the JAX package
OBJ_SPHERES = [
    {"name": "ring", "num": 2, "radius": 0.5, "velocity": 1.5,
     "path": {"class": "circle", "kwargs": {"radius": 2.5, "center": [5.0, 0.0, 1.5]}}},
    {"name": "patrol", "radius": 0.4, "velocity": 2.0,
     "path": {"class": "polygon", "kwargs": {"points": [[3, -3, 1.2], [9, -3, 1.2],
                                                        [9, 3, 1.2], [3, 3, 1.2]]}}},
]
OBJ_MIXED = OBJ_SPHERES + [
    {"name": "drone", "model_path": "drone", "radius": 0.35, "velocity": 1.0,
     "path": {"class": "circle", "kwargs": {"radius": 1.5, "center": [4.0, 1.0, 1.8]}}},
    {"name": "human", "model_path": "human", "radius": 0.9, "velocity": 0.8,
     "path": {"class": "polygon", "kwargs": {"points": [[6, -2, 0.0], [6, 2, 0.0]]}}},
]
# the sensor noise phase: a depth model at a time on the depth leg's env, and
# salt and pepper on path A's colour camera
DEPTH_NOISE = {
    "GaussianNoiseModel": {"sigma": 0.05, "mean": 0.01},
    "RedwoodDepthNoiseModel": {"noise_multiplier": 1.0, "lateral_prob": 0.5,
                               "dropout_scale": 0.25},
}
SALT_AND_PEPPER = {"amount": 0.1, "s_vs_p": 0.5}


def dyn_env(device, obj_settings, n=None):
    """Path L's env: the depth leg's spawn and scene with objects, 64×64
    depth and 64×64 colour."""
    from visfly_tpu_torch.envs import DynEnv

    return DynEnv(num_agent_per_scene=n or N_AGENTS, visual=True, device=device, max_episode_steps=256,
                  scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": TRACE_STEPS,
                                "obj_settings": obj_settings},
                  sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": list(RES)},
                                 {"uuid": "color", "sensor_type": "color", "resolution": list(RES)}],
                  random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                      {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
                  dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"})


def depth_off(a, b):
    """(share of pixels off by more than T_TOL, the largest difference on
    the rest) between two depth images, the second on the CPU."""
    diff = (a.cpu() - b).abs()
    off = diff > T_TOL
    return float(off.float().mean()), float(diff[~off].max())


def two_drones(device):
    """Two agents of one scene 1.2 m apart at the same height, agent 0
    facing agent 1 (tests/test_object_mesh.py's swarm view)."""
    from visfly_tpu_torch.envs import MultiNavigationEnv

    return MultiNavigationEnv(
        num_scene=1, num_agent_per_scene=2, visual=True, uav_radius=0.25, device=device,
        scene_kwargs={"path": "box15_wall_empty"},
        sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [64, 64]}],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, -1.0, 2.0], "half": [0, 0, 0]}},
            {"position": {"mean": [2.2, -1.0, 2.0], "half": [0, 0, 0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})


def swarm_and_zoo_paths(dev, card, launches):
    """Paths K (the swarm crossing run), L (dynamic objects) and M (the rest
    of the zoo); adds each path's launches to ``launches``."""
    import torch

    from visfly_tpu_torch.algos import BPTT, PPO
    from visfly_tpu_torch.envs import CatchEnv, HoverEnv, MultiNavigationEnv, RacingEnv2, TrackEnv

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
        return {k: v for k, v in counts.items() if v} or "no kernel"

    # path K: PPO_tuned on crossing; the drones are posed templates composed
    # after B1, which renders twice a step and once at the reset
    tr = PPO(MultiNavigationEnv(device=dev, **CROSSING), **PPO_TUNED_CROSSING)
    parts = timed_parts(tr, ("_collect", "_advantages", "_train_flat"))
    n_env, n_steps, n_timed = tr.env.num_envs, tr.n_steps, 1
    reset_launches()
    st = tr.init(torch.Generator(device=dev).manual_seed(120))
    before = snapshot(tr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        st, m = tr.update(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = all_launches()
    want = {k: 0 for k in counts}
    want["trace_analytic"] = 1 + 2 * n_steps * n_timed
    check(counts == want, f"path K: kernel launches {counts} != expected {want}")
    check_trained("path K", tr, st, m, before, "loss", dev)
    check(tr.n_minibatches == 1 and tr.batch_size == n_env * n_steps == 18432
          and n_env == 72, "path K: PPO's layout")
    check(st.obs["depth"].shape == (n_env, 1, *RES) and st.obs["swarm"].shape == (n_env, 2, 13),
          "path K: observation shapes")
    ms = {k: v / n_timed * 1e3 for k, v in parts.items()}
    print(f"phase 4 | path K (PPO_tuned, crossing): {add(counts)} launches | "
          f"{dt / n_timed * 1e3:.1f} ms an update ({tr.env.num_scene} scenes x "
          f"{tr.env.num_agent_per_scene} agents x {n_steps} steps, 64x64 depth with the other "
          f"drones as posed templates, {tr.n_epochs} epochs of 1 minibatch of "
          f"{n_env * n_steps}): rollout {ms['_collect']:.1f} ms, GAE {ms['_advantages']:.1f} ms, "
          f"epochs {ms['_train_flat']:.1f} ms; {n_env * n_steps / (ms['_collect'] / 1e3):.1f} "
          f"env steps/s of the rollout; trace_analytic {counts['trace_analytic'] - 1} launches in "
          f"{n_timed} update = 2 x {n_steps} x {n_timed}; loss {float(m['loss']):.4f}, "
          f"gradient norm {float(m['grad_norm']):.4f} | {card}", flush=True)

    # drones in view, card vs CPU: agent 0's camera sees agent 1 as a flat
    # quadrotor (outside the counted runs)
    depth = {}
    for d in (dev, "cpu"):
        _, obs = two_drones(d).reset(torch.Generator(device=d).manual_seed(0))
        depth[str(d)] = obs["depth"]
    share, err = depth_off(depth[str(dev)], depth["cpu"])
    sil = {}
    for k, img in depth.items():
        ys, xs = torch.nonzero(img[0, 0].cpu() < 1.7, as_tuple=True)
        check(len(ys) > 0, f"path K drones in view ({k}): no drone silhouette")
        sil[k] = (len(ys), int(xs.max() - xs.min()) + 1, int(ys.max() - ys.min()) + 1)
        check(sil[k][1] > sil[k][2], f"path K drones in view ({k}): silhouette {sil[k]} is not "
                                     "wider than tall")
    print(f"phase 5 | path K drones in view card vs cpu: depth max|d|={err:.3e} m on all but "
          f"{share:.3e} of pixels; silhouette (pixels, width, height) card {sil[str(dev)]}, "
          f"cpu {sil['cpu']} | {card}", flush=True)
    check(share <= HIT_TOL, f"path K drones in view: depth off on {share} of pixels")

    # path L: DynEnv amid moving objects, B1 (depth) and B1-kid (colour) once
    # a render; card vs CPU on one step at 32 agents, from the same state
    for name, objs in (("spheres in the kernel", OBJ_SPHERES),
                       ("templates after the kernel", OBJ_MIXED)):
        env_l = dyn_env(dev, objs)
        check((env_l.objects.mesh is None) == (objs is OBJ_SPHERES), f"path L {name}: templates")
        state_l, out, sps, counts, dt = drive(
            env_l, 130, 1, CHUNK,
            lambda steps: {"trace_analytic": 1 + steps, "trace_analytic_kid": 1 + steps})
        images = env_l.sensor_observations(state_l)
        check(bool(((out.obs["depth"] >= 0) & (out.obs["depth"] <= MAX_DEPTH)).all()),
              f"path L {name}: depth outside [0, 20]")
        check(images["color"].dtype == torch.uint8, f"path L {name}: colour dtype")
        check(state_l.objects.pos.device == dev
              and abs(float(state_l.objects.t[0]) - 2 * CHUNK * 0.03) < 1e-4,
              f"path L {name}: objects not stepped on the card")
        print(f"phase 4 | path L (DynEnv, {name}, {env_l.objects.num_objects} objects): "
              f"{add(counts)} launches in {CHUNK * 2} steps | {sps:.1f} env steps/s "
              f"({env_l.num_agent} agents, 64x64 depth + 64x64 colour, timed {dt:.3f} s) | {card}",
              flush=True)
        n = 32
        small, small_cpu = dyn_env(dev, objs, n), dyn_env("cpu", objs, n)
        st = small.reset(torch.Generator(device=dev).manual_seed(131))[0]
        st = st._replace(objects=state_l.objects)  # the objects where the run left them
        a = torch.rand((n, 4), device=dev, generator=torch.Generator(device=dev).manual_seed(132))
        st_g, out_g = small.step(st, a * 0.6 - 0.3, is_test=True)
        st_c, out_c = small_cpu.step(to_device(st, "cpu", torch.Generator().manual_seed(0)),
                                     (a * 0.6 - 0.3).cpu(), is_test=True)
        share, err = depth_off(out_g.obs["depth"], out_c.obs["depth"])
        col_g = small.sensor_observations(st_g)["color"].cpu()
        col_c = small_cpu.sensor_observations(st_c)["color"]
        c_flip = float((col_g != col_c).any(dim=1).float().mean())
        print(f"phase 5 | path L ({name}) card vs cpu ({n} agents, one step): depth max|d|="
              f"{err:.3e} m on all but {share:.3e} of pixels; colour differs on {c_flip:.3e} of "
              f"pixels | {card}", flush=True)
        check(share <= HIT_TOL, f"path L {name}: depth card vs cpu off on {share} of pixels")
        check(c_flip <= COLOR_TOL, f"path L {name}: colour card vs cpu differs on {c_flip}")

    # path M: the rest of the zoo; no kernel
    tr = PPO(RacingEnv2(device=dev, **RACING2), **PPO_RACING2)
    reset_launches()
    st = tr.init(torch.Generator(device=dev).manual_seed(140))
    st, m = tr.update(st)
    before = snapshot(tr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, m = tr.update(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_trained("path M racing2", tr, st, m, before, "loss", dev)
    check(st.obs["gate"].dtype == torch.int32, "path M racing2: gate observation")
    print(f"phase 4 | path M (PPO, racing2): {add(all_launches())} launches | {dt * 1e3:.1f} ms "
          f"an update ({tr.env.num_envs} agents x {tr.n_steps} steps, {tr.n_epochs} epochs); "
          f"gates passed {int(st.env_state.aux.past_targets.sum())}; loss "
          f"{float(m['loss']):.4f}, gradient norm {float(m['grad_norm']):.4f} | {card}",
          flush=True)

    tr = BPTT(TrackEnv(device=dev, **dict(TRACKING, **TRACKING_BPTT_ENV)), **BPTT_TRACKING)
    reset_launches()
    st = tr.init(torch.Generator(device=dev).manual_seed(150))
    st, m = tr.update(st)
    before = snapshot(tr)
    n_timed = 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        st, m = tr.update(st)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_trained("path M tracking", tr, st, m, before, "actor_loss", dev)
    ms, sps = dt / n_timed * 1e3, tr.H * tr.env.num_envs * n_timed / dt
    print(f"phase 4 | path M (BPTT, tracking): {add(all_launches())} launches | {ms:.1f} ms an "
          f"update, {sps:.1f} agent steps/s ({tr.env.num_envs} agents, H={tr.H}); loss "
          f"{float(m['actor_loss']):.4f}, gradient norm {float(m['grad_norm']):.4f} | {card}",
          flush=True)

    env_catch = CatchEnv(num_agent_per_scene=N_AGENTS, device=dev,
                         dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})
    state, out, sps, counts, dt = drive(env_catch, 160, 1, 16, lambda steps: {})
    check(bool(torch.isfinite(out.obs["ball"]).all()), "path M catch: ball not finite")
    print(f"phase 4 | path M (CatchEnv): {add(counts)} launches in 32 steps | {sps:.1f} env "
          f"steps/s ({N_AGENTS} agents); balls grounded {int(state.aux.grounded.sum())} | {card}",
          flush=True)

    wind = ["0.5 * sin(x)", "0.3 * cos(2 * x)", "0 * x", "0.2 + 0 * x", "0.9 * y", "0.1 * exp(-x)"]
    env_w = HoverEnv(num_agent_per_scene=200, device=dev, visual=False, max_episode_steps=500,
                     dynamics_kwargs={"dt": 0.0025, "ctrl_dt": 0.02, "action_type": "bodyrate",
                                      "wind_settings": wind, "drag_random": 0.3})
    state, out, sps, counts, dt = drive(env_w, 170, 1, 125, lambda steps: {})
    state = env_w.reset_agents(state, torch.ones(200, dtype=torch.bool, device=dev))
    rel = state.dyn.linear_drag / env_w.params.linear_drag_coeffs - 1
    check(bool(torch.isfinite(state.dyn.wind).all()) and float(state.dyn.wind.abs().max()) > 0.1,
          "path M wind: no wind")
    check(float(rel.abs().max()) <= 0.3 + 1e-5 and float(rel.std()) > 0.05,
          f"path M drag: relative coefficients {float(rel.abs().max())}, {float(rel.std())}")
    print(f"phase 4 | path M (HoverEnv, string wind of two fields, drag_random 0.3): "
          f"{add(counts)} launches in 250 steps | {sps:.1f} env steps/s (200 agents, 8 "
          f"substeps, path C's settings); wind {[round(float(w), 4) for w in state.dyn.wind[0]]}, drag spread "
          f"{float(rel.std()):.4f} (uniform: {0.3 / 3 ** 0.5:.4f}) | {card}", flush=True)


def noise_phase(dev, card):
    """Sensor noise on the card: each depth model on the depth leg's env and
    salt and pepper on path A's colour camera, drawn from the env's CUDA
    generator, the noisy minus the clean image held to the model's
    parameters; and the models on constant images with the JAX package's
    tolerances (tests/test_scene_render.py)."""
    import torch

    from visfly_tpu_torch.envs import LandingEnv, NavigationEnv
    from visfly_tpu_torch.envs.landing import _SPAWN
    from visfly_tpu_torch.render import noise as nz

    def nav(noise):
        return NavigationEnv(
            num_agent_per_scene=N_AGENTS, visual=True, device=dev,
            scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": TRACE_STEPS},
            sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": list(RES)}],
            random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]},
                "noise_kwargs": noise},
            dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"})

    clean_env = nav({})
    state, _ = clean_env.reset(torch.Generator(device=dev).manual_seed(180))
    check(state.gen.device.type == "cuda", "the env's generator is not on the card")
    clean = clean_env.sensor_observations(state)["depth"]
    for model, kw in DEPTH_NOISE.items():
        env = nav({"depth": {"model": model, "kwargs": kw}})
        start = state.gen.get_state()
        noisy = env.sensor_observations(state)["depth"]
        state.gen.set_state(start)
        check(torch.equal(env.sensor_observations(state)["depth"], noisy) and noisy.is_cuda,
              f"{model}: the draws do not replay from the env's CUDA generator")
        if model == "GaussianNoiseModel":
            d = noisy - clean
            mean, std = float(d.mean()), float(d.std())
            what = f"noisy - clean mean {mean:.5f} m (model {kw['mean']}), std {std:.5f} m " \
                   f"(model {kw['sigma']})"
            ok = abs(mean - kw["mean"]) < 1e-3 and abs(std - kw["sigma"]) < 0.05 * kw["sigma"]
        else:
            # flat pixels: the clean depth of all four neighbours within 1%,
            # where the lateral jitter moves nothing and the rest is unbiased
            near = [torch.roll(clean, k, dims=dim) for k in (1, -1) for dim in (-1, -2)]
            flat = (torch.stack([(z - clean).abs() for z in near]).amax(0) < 0.01 * clean) & (
                clean < MAX_DEPTH)
            kept = flat & (noisy > 0)
            rel = float(((noisy - clean) / clean)[kept].mean())
            rel_std = float(((noisy - clean) / clean)[kept].std())
            dropped = float((noisy == 0).float().mean())
            dropped_flat = float((noisy == 0)[flat].float().mean())
            what = (f"flat kept pixels' relative error mean {rel:.5f}, std {rel_std:.5f}; "
                    f"dropped share {dropped:.4f} of all pixels, {dropped_flat:.4f} of the flat")
            ok = abs(rel) < 0.01 and rel_std > 0 and dropped > dropped_flat and dropped_flat < 0.1
        print(f"phase 5 | noise {model} on the depth leg's 64x64 depth ({N_AGENTS} agents): "
              f"{what} | {card}", flush=True)
        check(ok, f"{model}: {what}")

    g = torch.Generator(device=dev).manual_seed(181)
    rgb = torch.full((4, 3, 32, 32), 128, dtype=torch.uint8, device=dev)
    depth = torch.full((4, 1, 32, 32), 3.0, device=dev)
    x = nz.gaussian(g, rgb, intensity_constant=0.1).float()
    stats = [5.0 < float(x.std()) < 40.0 and abs(float(x.mean()) - 128.0) < 2.0]
    x = nz.salt_and_pepper(g, rgb, amount=0.1)
    stats.append(0.03 < float((x == 255).float().mean()) < 0.07
                 and 0.03 < float((x == 0).float().mean()) < 0.07)
    x = nz.poisson(g, rgb).float()
    stats.append(5.0 < float(x.std()) < 20.0 and abs(float(x.mean()) - 128.0) < 2.0)
    x = nz.speckle(g, rgb, sigma=0.05).float()
    stats.append(3.0 < float(x.std()) < 15.0)
    x = nz.redwood_depth(g, depth)
    valid = x[x > 0]
    stats.append(abs(float(valid.mean()) - 3.0) < 0.1 and float(valid.std()) > 0)
    edge = depth.clone()
    edge[..., 16:] = 10.0
    stats.append(bool((nz.redwood_depth(g, edge, lateral_prob=0.0) == 0).any()))
    print(f"phase 5 | noise models on constant images on the card (gaussian, salt and pepper, "
          f"poisson, speckle, redwood, redwood edge dropout): {stats} | {card}", flush=True)
    check(all(stats), f"noise model statistics on the card: {stats}")

    clean_env = LandingEnv(num_agent_per_scene=N_AGENTS, device=dev)
    noisy_env = LandingEnv(num_agent_per_scene=N_AGENTS, device=dev, random_kwargs=dict(
        _SPAWN, noise_kwargs={"color": {"model": "SaltAndPepperNoiseModel",
                                        "kwargs": SALT_AND_PEPPER}}))
    state, _ = clean_env.reset(torch.Generator(device=dev).manual_seed(182))
    clean = clean_env.sensor_observations(state)["color"]
    noisy = noisy_env.sensor_observations(state)["color"]
    amount, s_vs_p = SALT_AND_PEPPER["amount"], SALT_AND_PEPPER["s_vs_p"]
    salt = float(((noisy == 255) & (clean != 255)).float().mean())
    pepper = float(((noisy == 0) & (clean != 0)).float().mean())
    want_salt = amount * s_vs_p * float((clean != 255).float().mean())
    want_pepper = amount * (1 - s_vs_p) * float((clean != 0).float().mean())
    print(f"phase 5 | noise SaltAndPepperNoiseModel on path A's 64x64 colour: salt {salt:.5f} "
          f"(model {want_salt:.5f}), pepper {pepper:.5f} (model {want_pepper:.5f}); other "
          f"pixels unchanged: {bool(((noisy == clean) | (noisy == 0) | (noisy == 255)).all())} "
          f"| {card}", flush=True)
    check(abs(salt - want_salt) < 0.05 * want_salt and abs(pepper - want_pepper)
          < 0.05 * want_pepper, "salt and pepper shares")
    check(bool(((noisy == clean) | (noisy == 0) | (noisy == 255)).all()),
          "salt and pepper changed other pixels")


# path O: the scenes users bring. A habitat-format dataset written by the
# smoke (a textured GLB stage, four object templates, six scene instances)
# loaded by ``NavigationEnv`` at both backends: decomposed into primitives for
# the analytic kernel (O1) and baked with its exact, textured triangles and
# per-instance ids for the triangle kernel (O2)
O_SCENES, O_AGENTS, O_FILES, O_OBJECTS = 4, 64, 6, 32
# agents a scene of the card-vs-CPU step: the CPU's exact render of 47,616
# triangles a scene takes about 9 times as long at 4 agents as at 2 (89.7 s
# against 10.2 s on an 8-core host)
O_CHECK_AGENTS = 2
O_SPACING = 0.15  # m: the decomposition's and the bake's grid cell
O_VIEW = (480, 640)  # the global view's resolution
O_SEED = 42  # the env's seed, and so its scene loader's
O_SENSORS = [{"uuid": u, "sensor_type": u, "resolution": list(RES)}
             for u in ("depth", "color", "semantic")]
# habitat (y-up) → std (z-up): std = hab @ _H2S, hab = std @ _H2S.T
_H2S = ((0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (-1.0, 0.0, 0.0))
# the checker colours of the textured objects, told apart by their red/blue ratio
O_RED, O_BLUE = (210, 40, 40), (40, 40, 210)


def subdivided_box(half, levels):
    """A box of half extents ``half`` at the origin, each triangle split 1:4
    ``levels`` times → (verts (3F, 3), faces (F, 3)): 12·4^levels triangles."""
    import numpy as np

    corners = np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                         np.float32) * np.asarray(half, np.float32)
    box_faces = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                            [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                           np.int32)
    v, f = corners, box_faces
    for _ in range(levels):
        a, b, c = (v[f[:, k]] for k in range(3))
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        v = np.concatenate([np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
                            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)]).reshape(-1, 3)
        f = np.arange(len(v), dtype=np.int32).reshape(-1, 3)
    return v.astype(np.float32), f


def planar_uv(v, f, tile):
    """Per-corner texcoords (V, 2) of a soup (each vertex in one face): each
    face projected along its normal's dominant axis, one texture every
    ``tile`` m (REPEAT wraps the rest)."""
    import numpy as np

    tri = v[f]
    n = np.abs(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    axis = np.argmax(n, axis=1)
    keep = np.asarray([[1, 2], [0, 2], [0, 1]])[axis]  # (F, 2) the other two axes
    uv = np.take_along_axis(tri, np.repeat(keep[:, None, :], 3, axis=1), axis=2) / tile
    out = np.zeros((len(v), 2), np.float32)
    out[f.reshape(-1)] = uv.reshape(-1, 2)
    return out


def write_o_glb(path, verts, faces, uvs=None, png=None, color=None):
    """A one-primitive GLB: with ``png`` a baseColorTexture sampled at
    ``uvs``, with ``color`` a flat baseColorFactor."""
    import json
    import struct

    import numpy as np

    blobs = [verts.astype(np.float32).tobytes(), faces.astype(np.uint32).tobytes()]
    attrs = {"POSITION": 0}
    accessors = [{"bufferView": 0, "componentType": 5126, "count": len(verts), "type": "VEC3"},
                 {"bufferView": 1, "componentType": 5125, "count": faces.size, "type": "SCALAR"}]
    prim = {"attributes": attrs, "indices": 1, "material": 0}
    gltf = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}], "meshes": [{"primitives": [prim]}]}
    if png is not None:
        blobs += [uvs.astype(np.float32).tobytes(), png]
        attrs["TEXCOORD_0"] = 2
        accessors.append({"bufferView": 2, "componentType": 5126, "count": len(uvs),
                          "type": "VEC2"})
        gltf.update(materials=[{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
                    textures=[{"source": 0}], images=[{"bufferView": 3, "mimeType": "image/png"}])
    else:
        gltf["materials"] = [{"pbrMetallicRoughness": {"baseColorFactor": [*color, 1.0]}}]
    views, off = [], 0
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(b)})
        off += len(b) + (-len(b) % 4)
    bin_ = b"".join(b + b"\0" * (-len(b) % 4) for b in blobs)
    gltf.update(accessors=accessors, bufferViews=views, buffers=[{"byteLength": len(bin_)}])
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as fo:
        fo.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bin_)))
        fo.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        fo.write(struct.pack("<II", len(bin_), 0x004E4942) + bin_)


def write_o_dataset(root):
    """The habitat-format dataset of path O under ``root``, in the habitat
    frame: the stage, ``garage_mesh(3)`` (23,040 triangles) with per-face
    texcoords and a 1,024×1,024 brick PNG; four templates of 768 triangles
    (two textured GLBs with red/blue checkers, a GLB of a flat colour, an OBJ
    with an MTL ``Kd``); ``O_FILES`` scene instances of ``O_OBJECTS``
    placements each (translation, yaw, uniform or non-uniform scale); the
    dataset config. → (the config's path, {scene file: placements' templates})."""
    import json

    import numpy as np

    from visfly_tpu_torch.scene.png import encode_png

    h2s = np.asarray(_H2S)
    for d in ("meshes", "configs/stages", "configs/objects", "configs/scenes"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    # the stage: grey bricks, 128×64 texels with darker mortar, a tile every 2 m
    yy, xx = np.mgrid[0:1024, 0:1024]
    row = yy // 64
    brick = (xx + 64 * (row % 2)) // 128
    shade = 150 + ((brick * 37 + row * 11) % 5) * 10
    mortar = (yy % 64 < 4) | ((xx + 64 * (row % 2)) % 128 < 4)
    img = np.where(mortar, 95, shade).astype(np.uint8)
    v, f = garage_mesh(3)
    write_o_glb(os.path.join(root, "meshes", "garage.glb"), v @ h2s.T, f,
                planar_uv(v, f, 2.0), encode_png(np.stack([img] * 3, -1), (1, 2, 4)))

    def checker(cells, px):
        g = (np.indices((cells, cells)).sum(0) % 2).astype(bool)
        cell = np.where(g[..., None], np.asarray(O_RED, np.uint8), np.asarray(O_BLUE, np.uint8))
        return np.repeat(np.repeat(cell, px, axis=0), px, axis=1)

    box_v, box_f = subdivided_box((0.5, 0.5, 0.5), 3)
    templates = {
        "crate_a": ("glb", dict(uvs=planar_uv(box_v, box_f, 1.0),
                                png=encode_png(checker(8, 32), (0, 1, 2, 3, 4)))),
        "crate_b": ("glb", dict(uvs=planar_uv(box_v, box_f, 0.5),
                                png=encode_png(checker(4, 16), (4,)))),
        "barrel": ("glb", dict(color=[0.25, 0.7, 0.25])),
        "bin": ("obj", None),
    }
    for name, (kind, kw) in templates.items():
        mesh = os.path.join(root, "meshes", f"{name}.{kind}")
        if kind == "glb":
            write_o_glb(mesh, box_v, box_f, **kw)
        else:
            with open(os.path.join(root, "meshes", "bin.mtl"), "w") as fo:
                fo.write("newmtl metal\nKd 0.6 0.58 0.6\n")
            with open(mesh, "w") as fo:
                fo.write("mtllib bin.mtl\nusemtl metal\n")
                fo.write("".join(f"v {p[0]} {p[1]} {p[2]}\n" for p in box_v.tolist()))
                fo.write("".join(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n" for t in box_f.tolist()))
        with open(os.path.join(root, "configs", "objects", f"{name}.object_config.json"),
                  "w") as fo:
            json.dump({"render_asset": f"../../meshes/{name}.{kind}"}, fo)
    with open(os.path.join(root, "configs", "stages", "garage.stage_config.json"), "w") as fo:
        json.dump({"render_asset": "../../meshes/garage.glb"}, fo)
    names = list(templates)
    placed = {}
    for i in range(O_FILES):
        rng = np.random.default_rng(100 + i)
        objs = []
        for k in range(O_OBJECTS):
            s = float(rng.uniform(0.4, 0.8))
            inst = {"template_name": names[k % 4]}
            if k % 3 == 2:
                ns = rng.uniform(0.3, 0.9, 3)
                inst["non_uniform_scale"] = ns.tolist()
                height = ns[1]  # habitat y is up
            else:
                inst["uniform_scale"] = s
                height = s
            z = height / 2 if k % 4 else float(rng.uniform(1.0, 2.5))
            std = np.asarray([rng.uniform(1.5, 15.0), rng.uniform(-3.8, 3.8), z])
            inst["translation"] = (std @ h2s.T).tolist()
            yaw = float(rng.uniform(0, np.pi))
            inst["rotation"] = [np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0]
            objs.append(inst)
        path = os.path.join(root, "configs", "scenes", f"room_{i}.scene_instance.json")
        with open(path, "w") as fo:
            json.dump({"stage_instance": {"template_name": "garage"},
                       "object_instances": objs}, fo)
        placed[path] = [o["template_name"] for o in objs]
    config = os.path.join(root, "rooms.scene_dataset_config.json")
    with open(config, "w") as fo:
        json.dump({"stages": {"paths": {".json": ["configs/stages/*.json"]}},
                   "objects": {"paths": {".json": ["configs/objects/*.json"]}},
                   "scene_instances": {"paths": {".json": ["configs/scenes/*.json"]}}}, fo)
    return config, placed


def o_env(device, config, grid):
    """Path O's env: ``NavigationEnv`` on the dataset config, agents all over
    the garage, 64×64 depth, colour and semantic."""
    from visfly_tpu_torch.envs import NavigationEnv

    scene = {"path": config, "max_prims": 64, "spacing": O_SPACING, "sdf_spacing": O_SPACING}
    if grid:
        scene["backend"] = "grid"
    return NavigationEnv(
        num_agent_per_scene=O_AGENTS, num_scene=O_SCENES, visual=True, device=device,
        seed=O_SEED, scene_kwargs=scene, sensor_kwargs=[dict(s) for s in O_SENSORS],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [8.0, 0.0, 1.75], "half": [6.5, 3.0, 0.5]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        max_episode_steps=256)


def o_twin(device, scene, n, num_scene, sensors, **scene_kw):
    """An env like path O's with ``n`` agents a scene and ``scene`` (already
    built) in effect: how the card-vs-CPU checks and the shadow and grid
    sensors share one load (an env swaps its scene in place)."""
    from visfly_tpu_torch.envs import NavigationEnv

    twin = NavigationEnv(
        num_agent_per_scene=n, num_scene=num_scene, visual=True, device=device, seed=O_SEED,
        scene_kwargs={"path": "box15_wall_empty", **scene_kw},
        sensor_kwargs=[dict(s) for s in sensors],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [8.0, 0.0, 1.75], "half": [6.5, 3.0, 0.5]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"})
    twin.scene = to_device(scene, device, None)
    twin.bbox = twin.scene.bbox
    return twin


def scene_rows(scene, s):
    """Every per-scene tensor of scene ``s`` (a packed primitive scene's rows,
    a mesh scene's grids, triangles and texture tables)."""
    import torch

    return {f: getattr(scene, f)[s].clone() for f in scene._fields
            if isinstance(getattr(scene, f), torch.Tensor) and getattr(scene, f).dim() > 1
            and f not in ("bbox",)}


def same_rows(a, b):
    """Rows of one scene before and after a swap, equal where both have them
    and zero (padding) beyond the smaller."""
    import torch

    for f in a:
        x, y = a[f], b[f]
        common = tuple(slice(0, min(p, q)) for p, q in zip(x.shape, y.shape))
        if not torch.equal(x[common], y[common]):
            return False
        for z in (x, y):
            rest = z.clone()
            rest[common] = 0
            if bool(rest.any()):
                return False
    return True


def o_expected_files(config):
    """The files the env loads at its build, its swap and its rotation, as a
    CPU ``SimpleDataLoader`` of the env's seed gives them."""
    from visfly_tpu_torch.scene.habitat_dataset import list_habitat_scenes
    from visfly_tpu_torch.utils.dataloader import SimpleDataLoader

    loader = SimpleDataLoader(list_habitat_scenes(config), seed=O_SEED)
    return loader.next(O_SCENES), loader.next(1), loader.next(O_SCENES)


def o_scene_ids(env):
    """What names the files of the env's scenes: the decomposed specs'
    names (O1), each scene's real triangle count (O2)."""
    if hasattr(env.scene, "params"):
        return [s.name for s in env._scene_specs]
    return [int((env.scene.triangles[s].abs().sum(-1) > 0).sum()) for s in range(O_SCENES)]


def o_file_ids(files, grid):
    import os as _os

    from visfly_tpu_torch.scene.habitat_dataset import load_habitat_scene_mesh

    if not grid:
        return [_os.path.basename(f)[:-len(".scene_instance.json")] for f in files]
    return [len(load_habitat_scene_mesh(f)[1]) for f in files]


def o_drive(env, name, per_render, config, card):
    """Reset, one warm-up chunk and one timed chunk of ``CHUNK`` steps with
    every observation consumed; in the timed chunk ``reset_env_by_id(state,
    2)`` after 10 steps and ``reset_scenes(state)`` after 20, timed apart
    from the steps. Launches are held to ``per_render`` a render (one at the
    reset, one a step), the swap to scene 2's rows and agents, the rotation
    to the loader's order. → (state, launches)."""
    import torch

    dev = env.device
    gen = torch.Generator(device=dev).manual_seed(90)
    act_gen = torch.Generator(device=dev).manual_seed(91)
    n = env.num_agent
    first, swap_f, rot_f = o_expected_files(config)
    grid = not hasattr(env.scene, "params")
    check(o_scene_ids(env) == o_file_ids(first, grid),
          f"path O {name}: the scenes loaded are not the loader's first {O_SCENES}")
    reset_launches()
    state, _ = env.reset(gen)
    carried = torch.zeros((), device=dev)
    step_s, swap_s, rot_s = 0.0, 0.0, 0.0
    for i in range(2 * CHUNK):
        timed = i >= CHUNK
        if i == CHUNK + CHUNK * 5 // 16:  # the 10th step of a 32-step chunk
            before = [scene_rows(env.scene, s) for s in range(O_SCENES)]
            pos0, count0 = state.dyn.pos.clone(), state.step_count.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = env.reset_env_by_id(state, 2)
            torch.cuda.synchronize()
            swap_s = time.perf_counter() - t0
            after = [scene_rows(env.scene, s) for s in range(O_SCENES)]
            kept = [same_rows(before[s], after[s]) for s in range(O_SCENES)]
            check(kept == [True, True, False, True],
                  f"path O {name}: scenes kept their rows across the swap: {kept}")
            mine = env.scene_ids == 2
            check(bool((state.step_count[mine] == 0).all())
                  and torch.equal(state.dyn.pos[~mine], pos0[~mine])
                  and torch.equal(state.step_count[~mine], count0[~mine]),
                  f"path O {name}: the swap moved agents outside scene 2")
            check(o_scene_ids(env)[2] == o_file_ids(swap_f, grid)[0],
                  f"path O {name}: the swap did not load the loader's next file")
        if i == CHUNK + CHUNK * 5 // 8:  # the 20th
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = env.reset_scenes(state)
            torch.cuda.synchronize()
            rot_s = time.perf_counter() - t0
            check(o_scene_ids(env) == o_file_ids(rot_f, grid),
                  f"path O {name}: the rotation did not load the loader's next {O_SCENES}")
            check(bool((state.step_count == 0).all()), f"path O {name}: rotation kept agents")
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        a = torch.rand((n, 4), generator=act_gen, device=dev) * 0.6 - 0.3
        state, out = env.step(state, a)
        obs_sum = sum(v.float().sum() for v in out.obs.values())
        carried = carried + out.reward.sum() + obs_sum * 1e-12
        if timed:
            torch.cuda.synchronize()
            step_s += time.perf_counter() - t0
    launches = all_launches()
    renders = 1 + 2 * CHUNK
    used = {k: v for k, v in launches.items() if v}
    want = {k: v * renders for k, v in per_render.items()}
    check(used == want, f"path O {name}: kernel launches {used} != expected {want}")
    check(bool(torch.isfinite(carried)), f"path O {name}: carried sum is not finite")
    sps = n * CHUNK / step_s
    print(f"phase 4 | path O {name}: {used} launches in {renders} renders (exactly "
          f"{per_render} a render, the renders after the swap and the rotation included) | "
          f"{sps:.1f} env steps/s ({n} agents, {O_SCENES} scenes, 64x64 depth + colour + "
          f"semantic, {CHUNK} steps in {step_s:.3f} s); reset_env_by_id {swap_s:.3f} s, "
          f"reset_scenes {rot_s:.3f} s (host loads, apart from the steps) | {card}", flush=True)
    return state, launches


def o_card_step(env, n, seed):
    """``n`` agents a scene in the env's scene on the card (twins), reset and
    stepped once with actions in [-0.3, 0.3], both drawn from ``seed`` → (the
    twin with cameras, the state before the step, the actions, the state
    after it, the step's output)."""
    import torch

    dev = env.device
    twin = o_twin(dev, env.scene, n, O_SCENES, O_SENSORS)
    state0, _ = twin.reset(torch.Generator(device=dev).manual_seed(seed))
    a = torch.rand((twin.num_agent, 4), device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed)) * 0.6 - 0.3
    state, out = o_twin(dev, env.scene, n, O_SCENES, []).step(state0, a, is_test=True)
    return twin, state0, a, state, out


def o_card_vs_cpu(name, env, card, seed):
    """One step of ``O_CHECK_AGENTS`` agents a scene in the env's scene on
    the card and on the CPU from the same state (twins without cameras: state
    within OBS_TOL), then the three cameras at the card's state after it on
    both: depth within T_TOL on all but HIT_TOL of the pixels, colour and
    semantic equal on all but COLOR_TOL."""
    import torch

    n = O_CHECK_AGENTS
    twin, state0, a, state, out_gpu = o_card_step(env, n, seed)
    state_cpu = to_device(state0, "cpu", torch.Generator().manual_seed(0))
    _, out_cpu = o_twin("cpu", env.scene, n, O_SCENES, []).step(state_cpu, a.cpu(), is_test=True)
    s_err = float((out_gpu.obs["state"].cpu() - out_cpu.obs["state"]).abs().max())
    check(s_err <= OBS_TOL, f"path O {name}: state obs card vs cpu {s_err} > {OBS_TOL}")
    imgs = twin.sensor_observations(state)
    twin_cpu = o_twin("cpu", env.scene, n, O_SCENES, O_SENSORS)
    imgs_cpu = twin_cpu.sensor_observations(to_device(state, "cpu", torch.Generator()))
    d_flip, d_err = depth_off(imgs["depth"], imgs_cpu["depth"])
    c_off = float((imgs["color"].cpu() != imgs_cpu["color"]).any(dim=1).float().mean())
    s_off = float((imgs["semantic"].cpu() != imgs_cpu["semantic"]).float().mean())
    print(f"phase 5 | path O {name} card vs cpu ({n} agents a scene, {O_SCENES} scenes): one step, "
          f"state max|d|={s_err:.3e}; the cameras after it: depth max|d|={d_err:.3e} m on all but "
          f"{d_flip:.3e} of pixels, colour differs on {c_off:.3e}, semantic on {s_off:.3e} | "
          f"{card}", flush=True)
    check(d_flip <= HIT_TOL, f"path O {name}: depth card vs cpu off on {d_flip}")
    check(c_off <= COLOR_TOL, f"path O {name}: colour card vs cpu differs on {c_off}")
    check(s_off <= COLOR_TOL, f"path O {name}: semantic card vs cpu differs on {s_off}")


def o_kernel_times(name, env, state, card):
    """Each kernel of ``modes`` on path O's 256-agent rays against its plain
    version, its time (CUDA events around the call; on the device, queued)
    and its bound, printed."""
    import torch

    from visfly_tpu_torch.render import (default_tri_cap, prepare_kernel_scene, trace_analytic,
                                         trace_analytic_reference, tri_first_hit,
                                         tri_first_hit_reference)
    from visfly_tpu_torch.render.trace_kernel import cull_rows
    from visfly_tpu_torch.render.tri_kernel import count_name
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    out = {}
    if hasattr(env.scene, "params"):
        ks = prepare_kernel_scene(env.scene)
        for mode, sensor in (("trace_analytic", 0), ("trace_analytic_kid", 1)):
            o, d = camera_rays_of(env, state, sensor)
            S = O_SCENES
            o, d = o.reshape(3, S, -1).contiguous(), d.reshape(3, S, -1).contiguous()
            kid = mode.endswith("kid")
            kernel = lambda: trace_analytic(ks, o, d, MAX_DEPTH, want_kid=kid, cull=True,  # noqa
                                            img_w=RES[1])
            plain = lambda: trace_analytic_reference(ks, o, d, MAX_DEPTH, want_kid=kid,  # noqa
                                                     cull=True, img_w=RES[1])
            err = compare(mode, f"path O {name} rays", lambda *a: kernel(), lambda *a: plain(),
                          ks, o, d)
            plan = cull_rows(ks, o, d, MAX_DEPTH, RES[1])
            b_ms, b_by = bound_ms(mode, ks, o.shape[1] * o.shape[2], plan=plan, o=o)
            out[mode] = dict(ms=cuda_ms(kernel), device_ms=device_ms(kernel),
                             plain_ms=cuda_ms(plain, reps=5, warmup=1), bound_ms=b_ms,
                             bound_by=b_by, err=err, rows=ks.boxes.shape[1] + ks.capsules.shape[1])
    else:
        tris = env.scene.triangles
        T = tris.shape[1]
        cap = default_tri_cap(T)
        o_c, d_c, w, hw = mesh_camera_rays(env, state, 0)
        plan = plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap, w, hw)
        mode = count_name(plan.form, plan.lists.block)
        args = (tris, plan.lists, plan.origins_c, plan.dirs_c, MAX_DEPTH, plan.form,
                plan.origin_tiles)
        t_k, hit_k, gid_k = tri_first_hit(*args)
        stats = {}
        plain_ms = cuda_ms(lambda: tri_first_hit_reference(*args, stats=stats), reps=1, warmup=0)
        t_p, hit_p, gid_p = tri_first_hit_reference(*args)
        torch.cuda.synchronize()
        both = hit_k & hit_p
        err = float((t_k - t_p).abs()[both].max())
        flip = float((hit_k != hit_p).float().mean())
        gid_off = float(((gid_k != gid_p) & both).float().mean())
        check(err <= T_TOL and flip <= HIT_TOL and gid_off <= HIT_TOL,
              f"path O {name}: {mode} vs plain: |dt| {err}, hit {flip}, id {gid_off}")
        b_ms, b_by, by_bytes = tri_bound_ms(plan.form, stats, o_c.shape[1] * o_c.shape[2],
                                            plan.lists, plan.form == "mt")
        kernel = lambda: tri_first_hit(*args)  # noqa: E731
        out[mode] = dict(ms=cuda_ms(kernel), device_ms=device_ms(kernel), plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, err=err, triangles=T, cap=cap,
                         flip=flip, gid_off=gid_off,
                         prepass_ms=cuda_ms(lambda: plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap,
                                                               w, hw), reps=5, warmup=1))
        print(f"phase 3 | path O {name}: the triangle kernel's tier at {T} triangles a scene, "
              f"{o_c.shape[2]} rays a scene, cap {cap}: {mode} (form {plan.form}, block "
              f"{plan.lists.block}); {stats['real_tests'] / (o_c.shape[1] * o_c.shape[2]):.1f} "
              f"tests a ray on triangles; vs plain max|dt|={err:.3e} m hit_mismatch={flip:.3e} "
              f"id_mismatch={gid_off:.3e} | {card}", flush=True)
    for mode, x in out.items():
        rays = env.num_agent_per_scene * RES[0] * RES[1]
        print(f"phase 3 | path O {name}: {mode} at {O_SCENES} x {rays} rays: "
              f"kernel {x['ms']:.4f} ms (on the device {x['device_ms']:.4f} ms, queued), plain "
              f"{x['plain_ms']:.4f} ms, bound {x['bound_ms']:.4f} ms by {x['bound_by']}, share "
              f"{x['bound_ms'] / x['device_ms']:.4f} of the device time"
              + (f", prepass {x['prepass_ms']:.4f} ms" if "prepass_ms" in x else "")
              + f" | {card}", flush=True)


def scene_ingest_path(dev, card, launches):
    """Path O: the habitat dataset at both backends (O1 decomposed, O2 exact
    and textured), with the swap, the rotation, the approaching points and
    the global view; on O2's scene the shadow rays, the grid render opt-out
    and a grid-only preset. Adds its launches to ``launches``."""
    import types as _types

    import numpy as np
    import torch

    from visfly_tpu_torch.envs.base import DroneGymEnv
    from visfly_tpu_torch.render import bake_lighting, render_camera
    from visfly_tpu_torch.render.global_view import scene_zero
    from visfly_tpu_torch.render.tri_trace import pack_triangles
    from visfly_tpu_torch.scene.scene import SceneData

    work = tempfile.TemporaryDirectory(prefix="visfly_path_o_")
    t0 = time.perf_counter()
    config, placed = write_o_dataset(work.name)
    print(f"phase 4 | path O: dataset written in {time.perf_counter() - t0:.1f} s ({O_FILES} "
          f"scene instances of {O_OBJECTS} objects, a 23040-triangle textured stage) | {card}",
          flush=True)
    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for name, grid in (("O1 (decomposed)", False), ("O2 (exact, textured)", True)):
        t_path = t0 = time.perf_counter()
        env = o_env(dev, config, grid)
        load_s = time.perf_counter() - t0
        if grid:
            check(isinstance(env.scene, SceneData) and isinstance(env.scene.tri_uv, torch.Tensor),
                  f"path O {name}: no texture tables")
            # the parts of one scene's bake: the signed grid, one unsigned grid an
            # instance (in a thread pool), the pack, the atlas
            from visfly_tpu_torch.scene import mesh as tmesh

            v, f, inst, cols, tex = env._scene_meshes[0]
            frame = tmesh._Frame(env.scene.origin.cpu().numpy(), float(env.scene.spacing),
                                 tuple(env.scene.sdf.shape[1:]), env.scene.bbox.cpu().numpy())
            parts = {}
            for part, fn in (
                    ("signed grid", lambda: tmesh.mesh_to_sdf_grid(v, f, frame.lo, frame.spacing,
                                                                   frame.dims)),
                    (f"{len(np.unique(inst))} instance grids",
                     lambda: tmesh._instance_grids(v, f, inst, cols, frame)),
                    ("pack", lambda: pack_triangles(v, f, return_order=True)),
                    ("atlas", lambda: tmesh.build_atlas(tex))):
                t1 = time.perf_counter()
                fn()
                parts[part] = time.perf_counter() - t1
            print(f"phase 4 | path O {name}: one scene's bake, host seconds "
                  f"{ {k: round(x, 3) for k, x in parts.items()} } | {card}", flush=True)
            tris = [int((env.scene.triangles[s].abs().sum(-1) > 0).sum()) for s in range(O_SCENES)]
            size = f"{tris} triangles a scene (packed {env.scene.triangles.shape[1]})"
            check(min(tris) > 40000, f"path O {name}: triangles {tris}")
        else:
            prims = [len(s.primitives) for s in env._scene_specs]
            size = (f"{prims} primitives a scene (packed rows {env.scene.boxes.shape[1]} boxes, "
                    f"{env.scene.capsules.shape[1]} capsules, floor {env._pack_floor})")
            check(min(prims) > 8, f"path O {name}: primitives {prims}")
        print(f"phase 4 | path O {name}: {O_SCENES} scenes loaded in {load_s:.1f} s on the host; "
              f"{size}; grid {tuple(getattr(env.scene, 'sdf', torch.zeros(1, 0, 0, 0)).shape[1:])}"
              f" | {card}", flush=True)
        # the tier each sensor takes: one render with the counts reset
        st0, _ = env.reset(torch.Generator(device=dev).manual_seed(89))
        if grid:
            reset_launches()
            env.sensor_observations(st0)
            torch.cuda.synchronize()
            per_render = {k: v for k, v in all_launches().items() if v}
            check(sum(per_render.values()) == 3 and len(per_render) == 1,
                  f"path O {name}: one render launched {per_render}")
        else:
            per_render = {"trace_analytic": 1, "trace_analytic_kid": 2}
        state, counts = o_drive(env, name, per_render, config, card)
        add(counts)
        t_check = time.perf_counter()
        # the approaching points, card vs CPU
        reset_launches()
        ap = env.approaching_point(state)
        cpu_env = _types.SimpleNamespace(scene=to_device(env.scene, "cpu", None),
                                         scene_ids=env.scene_ids.cpu())
        state_cpu = to_device(state, "cpu", torch.Generator())
        ap_cpu = DroneGymEnv.approaching_point(cpu_env, state_cpu)
        ap_err = float((ap.cpu() - ap_cpu).abs().max())
        print(f"phase 5 | path O {name}: approaching_point of {env.num_agent} agents card vs cpu "
              f"max|d|={ap_err:.3e} m; {float((ap - state.dyn.pos).norm(dim=-1).median()):.2f} m "
              f"ahead (median) | {card}", flush=True)
        check(ap_err <= T_TOL, f"path O {name}: approaching_point card vs cpu {ap_err} > {T_TOL}")
        # the global view of scene 0 with the approaching lines
        t0 = time.perf_counter()
        img = env.render(state, view="top", approaching=True, resolution=list(O_VIEW))
        torch.cuda.synchronize()
        gv_s = time.perf_counter() - t0
        counts = all_launches()
        add(counts)
        used = {k: v for k, v in counts.items() if v}
        check(img.shape == (*O_VIEW, 3) and img.std() > 5,
              f"path O {name}: global view {img.shape}")
        check(sum(used.values()) == 1, f"path O {name}: the global view launched {used}")
        print(f"phase 4 | path O {name}: global view {O_VIEW[0]}x{O_VIEW[1]} of scene 0 with "
              f"approaching lines in "
              f"{gv_s:.3f} s, {used} | {card}", flush=True)
        # one step at O_CHECK_AGENTS agents a scene, card vs CPU
        o_card_vs_cpu(name, env, card, 93)
        if grid:
            # the card's images of 4 agents a scene after one step
            twin, _, _, tst, _ = o_card_step(env, 4, 93)
            imgs = twin.sensor_observations(tst)
            sem, rgb = imgs["semantic"][:, 0], imgs["color"].int()
            # textures: red and blue checker cells on the textured objects
            red = (rgb[:, 0] > 2 * rgb[:, 2]) & (rgb[:, 0] > 2 * rgb[:, 1]) & (sem >= 2)
            blue = (rgb[:, 2] > 2 * rgb[:, 0]) & (rgb[:, 2] > 2 * rgb[:, 1]) & (sem >= 2)
            n_red, n_blue = int(red.sum()), int(blue.sum())
            # instance ids: every instance on 16 or more pixels of the semantic
            # camera (its winning triangles') has its id in the image
            from visfly_tpu_torch.render import camera_rays, default_tri_cap, tri_trace_diff

            spec = twin.sensor_kwargs[2]
            origins, dirs, _ = camera_rays(spec, tst.dyn.pos, tst.dyn.q)
            Rs = 4 * RES[0] * RES[1]
            o_c = origins[:, None].expand(-1, RES[0] * RES[1], 3).reshape(O_SCENES, Rs, 3)
            d_c = dirs.reshape(O_SCENES, Rs, 3)
            tri = env.scene.triangles
            _, hit, _, gid = tri_trace_diff(tri, o_c.permute(2, 0, 1).contiguous(),
                                            d_c.permute(2, 0, 1).contiguous(), MAX_DEPTH,
                                            default_tri_cap(tri.shape[1]), RES[1], True,
                                            RES[0] * RES[1])
            missing, n_vis, n_ids = [], 0, 0
            for s in range(O_SCENES):
                v, f, inst = env._scene_meshes[s][:3]
                _, order = pack_triangles(v, f, return_order=True)
                face = torch.as_tensor(order, device=dev)[gid[s].long()][hit[s]]
                ids, px = torch.unique(torch.as_tensor(inst, device=dev)[face], return_counts=True)
                seen = set(torch.unique(sem[4 * s:4 * s + 4]).tolist())
                vis = [int(i) for i, c in zip(ids.tolist(), px.tolist()) if c >= 16]
                n_vis += len(vis)
                n_ids += len(seen - {0})
                missing += [(s, i) for i in vis if i % 255 + 1 not in seen]
                check(1 in seen, f"path O {name}: scene {s}'s semantic image lacks the stage's id")
            print(f"phase 5 | path O {name}: textured objects show {n_red} red and {n_blue} blue "
                  f"checker pixels; {n_vis} instances on >= 16 pixels, {n_ids} distinct ids in "
                  f"the semantic images, missing {missing[:6]} | {card}", flush=True)
            check(n_red >= 50 and n_blue >= 50, f"path O {name}: the checkerboard did not come "
                  f"through ({n_red} red, {n_blue} blue pixels)")
            check(not missing and n_ids >= n_vis, f"path O {name}: instance ids missing {missing}")
            del twin
        t_cpu = time.perf_counter()
        o_kernel_times(name, env, state, card)
        print(f"phase 4 | path O {name}: {time.perf_counter() - t_path:.1f} s in all, of which the "
              f"card-vs-CPU step and the checks after the chunk {t_cpu - t_check:.1f} s, the "
              f"kernels against their plain versions {time.perf_counter() - t_cpu:.1f} s | {card}",
              flush=True)
        if grid:
            o2_scene = env.scene
        del env
    # separately, on O2's scene 0: shadow rays, the grid opt-out, a grid-only preset
    t_rest = time.perf_counter()
    scene0 = scene_zero(o2_scene)
    light = {"ambient": 0.3, "lights": [{"type": "directional", "direction": [0.4, 0.3, -1.0],
                                         "intensity": 0.9}]}
    color = [O_SENSORS[1]]
    lit = o_twin(dev, scene0, 4, 1, color, lighting=light)
    shadowed = o_twin(dev, scene0, 4, 1, color, lighting={**light, "shadows": True})
    st, _ = lit.reset(torch.Generator(device=dev).manual_seed(94))
    reset_launches()
    plain_img = lit.sensor_observations(st)["color"]
    shadow_img = shadowed.sensor_observations(st)["color"]
    torch.cuda.synchronize()
    counts = all_launches()
    add(counts)
    check(sum(counts.values()) == 2, f"path O shadows: launches {counts}")
    darker = float((shadow_img < plain_img).any(1).float().mean())
    check(bool((shadow_img <= plain_img).all()) and darker > 0,
          f"path O shadows: a pixel brighter, or none darker ({darker})")
    spec = shadowed.sensor_kwargs[0]
    cpu_light = bake_lighting({**light, "shadows": True})
    one = render_camera(to_device(scene0, "cpu", None), st.dyn.pos[:1].cpu(), st.dyn.q[:1].cpu(),
                        spec, lighting=cpu_light)["color"]
    card_one = render_camera(scene0, st.dyn.pos[:1], st.dyn.q[:1], spec,
                             lighting=shadowed._baked_lighting)["color"]
    s_off = float((card_one.cpu() != one).any(1).float().mean())
    call = lambda: shadowed.sensor_observations(st)  # noqa: E731
    shadow_ms, lit_ms = cuda_ms(call, reps=5, warmup=1), cuda_ms(
        lambda: lit.sensor_observations(st), reps=5, warmup=1)
    print(f"phase 5 | path O shadows on O2's scene 0 (4 agents, 64x64 colour, "
          f"{scene0.triangles.shape[1]} triangles): {darker:.3f} of the pixels darker, none "
          f"brighter; card vs cpu (one camera) colour differs on {s_off:.3e} | render "
          f"{shadow_ms:.2f} ms with shadow rays, {lit_ms:.2f} ms without | {card}", flush=True)
    check(s_off <= COLOR_TOL, f"path O shadows: colour card vs cpu differs on {s_off}")
    for name, scene, sensors in (
            ("the render_backend 'grid' opt-out on O2's scene 0", scene0,
             [dict(O_SENSORS[0], render_backend="grid")]),
            ("a grid-only garage_simple_l_medium (bake_scenes)", None,
             [dict(O_SENSORS[0]), dict(O_SENSORS[1])])):
        if scene is None:
            from visfly_tpu_torch.envs import NavigationEnv

            t0 = time.perf_counter()
            baked = NavigationEnv(num_agent_per_scene=4, visual=True, device=dev,
                                  scene_kwargs={"path": "garage_simple_l_medium",
                                                "backend": "grid"})
            check(isinstance(baked.scene, SceneData) and not baked.scene.has_triangles,
                  "path O: the grid-only preset has triangles")
            scene = baked.scene
            print(f"phase 4 | path O: garage_simple_l_medium baked into a grid "
                  f"{tuple(scene.sdf.shape[1:])} in {time.perf_counter() - t0:.1f} s | {card}",
                  flush=True)
        env_g = o_twin(dev, scene, 4, 1, sensors)
        env_c = o_twin("cpu", scene, 4, 1, sensors)
        st, _ = env_g.reset(torch.Generator(device=dev).manual_seed(95))
        reset_launches()
        t0 = time.perf_counter()
        imgs = env_g.sensor_observations(st)
        torch.cuda.synchronize()
        g_s = time.perf_counter() - t0
        counts = all_launches()
        check(not any(counts.values()), f"path O grid render launched {counts}")
        imgs_c = env_c.sensor_observations(to_device(st, "cpu", torch.Generator()))
        d_flip, d_err = depth_off(imgs["depth"], imgs_c["depth"])
        hit = float((imgs["depth"] < MAX_DEPTH).float().mean())
        line = (f"phase 5 | path O {name}: 4 agents, {g_s * 1e3:.1f} ms a render, no kernel; "
                f"depth hits {hit:.3f} of pixels, card vs cpu max|d|={d_err:.3e} m on all but "
                f"{d_flip:.3e}")
        check(d_flip <= HIT_TOL and hit > 0.5, f"path O {name}: depth card vs cpu off on {d_flip}")
        if "color" in imgs:
            c_off = float((imgs["color"].cpu() != imgs_c["color"]).any(1).float().mean())
            line += f", colour differs on {c_off:.3e}"
            check(c_off <= COLOR_TOL, f"path O {name}: colour card vs cpu differs on {c_off}")
        print(line + f" | {card}", flush=True)
    print(f"phase 4 | path O: shadows, the grid opt-out and the grid-only preset "
          f"{time.perf_counter() - t_rest:.1f} s | {card}", flush=True)
    work.cleanup()


# path P, the policies users add: the torchvision-layout backbones at their
# published widths, the world model and its latent env, the depth
# autoencoder, the actor → PPO transplant and the data-parallel trainers
P1_ARCH = {"depth": {"backbone": "resnet18", "out": 128}, "state": {"mlp": [128, 64]}}
P1_LATENT = (64, 64)
# P1 fine-tunes a trunk of 11 M parameters: at BPTT's default 1e-3, Adam moves
# every weight by about the rate a step and the actions saturate within three
# updates (the gradient 0.52, 0.33, 0.002 on the CPU); 1e-4 keeps them inside
P1_LR = 1e-4
BACKBONE_NAMES = ("resnet18", "resnet34", "resnet50", "resnet101", "mobilenet_s",
                  "mobilenet_l", "efficientnet_s", "efficientnet_m", "efficientnet_l")
BACKBONE_ATOL, BACKBONE_RTOL = 2e-4, 1e-3  # tests/test_aux_subsystems.py:373


def torchvision_state(name, seed, in_scale=1.0):
    """A torchvision-layout state dict of backbone ``name`` drawn from
    ``seed``: convolutions fan-in normalised (half that in the residual
    trunks, ResNet and EfficientNetV2, whose 8-33 residual blocks would
    otherwise grow resnet101's features to 3e4, so that the card-vs-CPU
    comparison tests the graph and not float32 accumulation), the stem's
    besides times ``in_scale`` (1 / 20 for depth in metres up to 20,
    as a trunk trained on such depth would take it), BatchNorm γ = 1 + 0.1·N,
    β and μ 0.1·N, σ² = 0.5 + 0.1·|N|, squeeze-excite biases 0.1·N."""
    import torch

    from visfly_tpu_torch.policies.compact_backbones import (
        COMPACT_BACKBONES, EFFICIENTNET_V2, MOBILENET_V3, _make_divisible)
    from visfly_tpu_torch.policies.torch_backbones import (
        ARCH_STAGES, BOTTLENECK_ARCHS, BOTTLENECK_EXPANSION)

    g = torch.Generator().manual_seed(seed)
    sd = {}
    gain = 1.0 if name.startswith("mobilenet") else 0.5

    def conv(key, *shape):
        fan = 1
        for d in shape[1:]:
            fan *= d
        stem = key in ("conv1.weight", "features.0.0.weight")
        sd[key] = torch.randn(shape, generator=g) * (gain / fan ** 0.5 * (in_scale if stem else 1))

    def vec(key, c):
        sd[key] = torch.randn((c,), generator=g) * 0.1

    def cbn(c_key, bn, *shape):
        conv(f"{c_key}.weight", *shape)
        c = shape[0]
        sd[f"{bn}.weight"] = 1.0 + 0.1 * torch.randn((c,), generator=g)
        vec(f"{bn}.bias", c)
        vec(f"{bn}.running_mean", c)
        sd[f"{bn}.running_var"] = 0.5 + 0.1 * torch.randn((c,), generator=g).abs()

    if name in ARCH_STAGES:
        exp = BOTTLENECK_EXPANSION if name in BOTTLENECK_ARCHS else 1
        cbn("conv1", "bn1", 64, 3, 7, 7)
        cin = 64
        for stage, blocks in enumerate(ARCH_STAGES[name]):
            c = 64 * 2 ** stage
            for b in range(blocks):
                tp = f"layer{stage + 1}.{b}"
                if exp > 1:
                    cbn(f"{tp}.conv1", f"{tp}.bn1", c, cin, 1, 1)
                    cbn(f"{tp}.conv2", f"{tp}.bn2", c, c, 3, 3)
                    cbn(f"{tp}.conv3", f"{tp}.bn3", c * exp, c, 1, 1)
                else:
                    cbn(f"{tp}.conv1", f"{tp}.bn1", c, cin, 3, 3)
                    cbn(f"{tp}.conv2", f"{tp}.bn2", c, c, 3, 3)
                if (b == 0 and stage > 0) or cin != c * exp:
                    cbn(f"{tp}.downsample.0", f"{tp}.downsample.1", c * exp, cin, 1, 1)
                cin = c * exp
        return sd
    arch = COMPACT_BACKBONES[name][1]["arch"]
    if name.startswith("mobilenet"):
        cfg = MOBILENET_V3[arch]
        cbn("features.0.0", "features.0.1", cfg["stem"], 3, 3, 3)
        cin = cfg["stem"]
        for i, (k, e, out, use_se, _a, _s) in enumerate(cfg["blocks"]):
            f, j = f"features.{i + 1}.block", 0
            if e != cin:
                cbn(f"{f}.{j}.0", f"{f}.{j}.1", e, cin, 1, 1)
                j += 1
            cbn(f"{f}.{j}.0", f"{f}.{j}.1", e, 1, k, k)
            j += 1
            if use_se:
                sq = _make_divisible(e // 4)
                conv(f"{f}.{j}.fc1.weight", sq, e, 1, 1)
                vec(f"{f}.{j}.fc1.bias", sq)
                conv(f"{f}.{j}.fc2.weight", e, sq, 1, 1)
                vec(f"{f}.{j}.fc2.bias", e)
                j += 1
            cbn(f"{f}.{j}.0", f"{f}.{j}.1", out, e, 1, 1)
            cin = out
        nf = len(cfg["blocks"]) + 1
    else:
        cfg = EFFICIENTNET_V2[arch]
        cbn("features.0.0", "features.0.1", cfg["stem"], 3, 3, 3)
        cin = cfg["stem"]
        for si, (btype, e, k, _s0, out, layers) in enumerate(cfg["stages"]):
            for li in range(layers):
                f = f"features.{si + 1}.{li}.block"
                if btype == "fused" and e == 1:
                    cbn(f"{f}.0.0", f"{f}.0.1", out, cin, k, k)
                elif btype == "fused":
                    cbn(f"{f}.0.0", f"{f}.0.1", cin * e, cin, k, k)
                    cbn(f"{f}.1.0", f"{f}.1.1", out, cin * e, 1, 1)
                else:
                    x, sq = cin * e, max(1, cin // 4)
                    cbn(f"{f}.0.0", f"{f}.0.1", x, cin, 1, 1)
                    cbn(f"{f}.1.0", f"{f}.1.1", x, 1, k, k)
                    conv(f"{f}.2.fc1.weight", sq, x, 1, 1)
                    vec(f"{f}.2.fc1.bias", sq)
                    conv(f"{f}.2.fc2.weight", x, sq, 1, 1)
                    vec(f"{f}.2.fc2.bias", x)
                    cbn(f"{f}.3.0", f"{f}.3.1", out, x, 1, 1)
                cin = out
        nf = len(cfg["stages"]) + 1
    cbn(f"features.{nf}.0", f"features.{nf}.1", cfg["head"], cin, 1, 1)
    return sd


def loaded_backbone(name, seed):
    """Backbone ``name`` on the CPU with the folded weights of
    ``torchvision_state(name, seed)``, through the port's loader."""
    import torch

    from visfly_tpu_torch.policies.compact_backbones import (
        convert_torch_efficientnet_v2, convert_torch_mobilenet_v3)
    from visfly_tpu_torch.policies.extractors import backbone
    from visfly_tpu_torch.policies.torch_backbones import convert_torch_resnet

    sd = torchvision_state(name, seed)
    with torch.device("meta"):  # the loader's weights replace any drawn ones
        net = backbone(name)
    if name.startswith("resnet"):
        folded = convert_torch_resnet(sd, name)
    elif name.startswith("mobilenet"):
        folded = convert_torch_mobilenet_v3(sd, net.arch)
    else:
        folded = convert_torch_efficientnet_v2(sd, net.arch)
    net.load_state_dict(folded, assign=True)
    return net.eval()


def p1_env(device, n=64):
    """P1's env: path F's, at ``n`` agents, in the primitive garage."""
    return visual_grad_env(device, {"path": "garage_simple_l_medium", "trace_steps": TRACE_STEPS},
                           {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}, n=n)


def rel_err(a, b):
    """max |a − b| over max |b|."""
    return float((a.detach().cpu() - b.detach().cpu()).abs().max()
                 / b.detach().cpu().abs().max().clamp(min=1e-30))


def p_bptt_rank(mesh, visual, n_global, seed):
    """P5 on one rank: path E's BPTT update (HoverEnv, H = 32) or P1's env
    with path F's CNN policy (H = 8), for this rank's block of ``n_global``
    agents; one warm-up update from ``seed``'s state, then one timed → loss,
    parameters, positions after the warm-up and the timed update, ms, and the
    kernels' launches in this process."""
    import torch

    from visfly_tpu_torch.algos import BPTT
    from visfly_tpu_torch.envs import HoverEnv, NavigationEnv2
    from visfly_tpu_torch.parallel import make_rank_env, shard_train_state

    reset_launches()
    if visual:
        env = make_rank_env(
            NavigationEnv2, mesh, n_global, visual=True, requires_grad=True,
            scene_kwargs={"path": "garage_simple_l_medium", "trace_steps": TRACE_STEPS},
            sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": list(RES)}],
            random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
                {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
            dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03}, max_episode_steps=256,
            device=mesh.device)
        tr = BPTT(env, horizon=8, policy_kwargs=VISUAL_POLICY)
    else:
        env = make_rank_env(HoverEnv, mesh, n_global, visual=False, requires_grad=True,
                            dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03},
                            max_episode_steps=256, device=mesh.device)
        tr = BPTT(env, horizon=32)
    st = tr.init(torch.Generator(device=mesh.device).manual_seed(seed))
    if mesh.size > 1 or mesh.backend == "nccl":
        st = shard_train_state(st, mesh, tr)
    st, m0 = tr.update(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, m = tr.update(st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return {"loss": [float(m0["actor_loss"]), float(m["actor_loss"])],
            "grad_norm": float(m["grad_norm"]),
            "params": torch.cat([p.detach().flatten().cpu() for p in tr.actor.parameters()]),
            "pos": st.env_state.dyn.pos.detach().cpu(), "ms": ms, "launches": all_launches(),
            "steps": tr.H * 2, "device": str(mesh.device)}


def p_ranks(mesh, seed):
    """P5's legs on one rank, E's then F's."""
    return {"hover": p_bptt_rank(mesh, False, 128, seed),
            "visual": p_bptt_rank(mesh, True, 64, seed + 1)}


def policies_path(dev, card, launches):
    """Path P (sub-paths P1-P5, see the module docstring); adds each
    sub-path's launches to ``launches`` and checks them against its renders."""
    import copy

    import torch

    from visfly_tpu_torch.algos import BPTT, PPO
    from visfly_tpu_torch.core.math_utils import full_fp32_matmul
    from visfly_tpu_torch.envs import NavigationEnv
    from visfly_tpu_torch.parallel import run_ranks
    from visfly_tpu_torch.policies import EXTRACTOR_ALIASES, actor_to_policy_params
    from visfly_tpu_torch.policies.autoencoder import collect_depth_frames, train_autoencoder
    from visfly_tpu_torch.policies.torch_backbones import apply_pretrained
    from visfly_tpu_torch.policies.world_model import create_world_model

    full_fp32_matmul()
    t_path = time.perf_counter()

    def count(name, want):
        counts = all_launches()
        expect = {k: 0 for k in counts}
        expect.update(want)
        check(counts == expect, f"{name}: kernel launches {counts} != expected {expect}")
        for k, v in counts.items():
            launches[k] += v
        return {k: v for k, v in counts.items() if v}

    # P1: visual BPTT through resnet18, its torchvision weights folded in
    tr1 = BPTT(p1_env(dev), horizon=8, learning_rate=P1_LR,
               policy_kwargs={"net_arch": P1_ARCH, "latent_dim": P1_LATENT})
    reset_launches()
    st1 = tr1.init(torch.Generator(device=dev).manual_seed(300))
    depth_weights = torchvision_state("resnet18", 301, 1.0 / MAX_DEPTH)
    apply_pretrained(tr1.actor, {"depth_extractor": depth_weights})
    before = snapshot(tr1)
    st1, m = tr1.update(st1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        st1, m = tr1.update(st1)
    torch.cuda.synchronize()
    ms1 = (time.perf_counter() - t0) / 2 * 1e3
    used = count("P1", {"trace_analytic": 1 + tr1.H * 3})
    check_trained("P1", tr1, st1, m, before, "actor_loss", dev)
    print(f"phase 4 | path P1 (visual BPTT through resnet18, folded torchvision weights): "
          f"{used} launches in 3 updates | {ms1:.1f} ms an update ({tr1.env.num_envs} agents, "
          f"H={tr1.H}, 64x64 depth; loss {float(m['actor_loss']):.4f}, gradient norm "
          f"{float(m['grad_norm']):.4f}) | {card}", flush=True)

    # the actor's forward and its first gradient, card vs CPU, at 8 agents and
    # H = 4: the first action reaches a reward through the motors from the
    # third step on, so at H = 2 the gradient is exactly zero
    env8 = p1_env(dev, 8)
    tr8 = BPTT(env8, horizon=4, policy_kwargs={"net_arch": P1_ARCH, "latent_dim": P1_LATENT})
    reset_launches()
    st8 = tr8.init(torch.Generator(device=dev).manual_seed(302))
    apply_pretrained(tr8.actor, {"depth_extractor": depth_weights})
    tr8c = BPTT(p1_env("cpu", 8), horizon=4,
                policy_kwargs={"net_arch": P1_ARCH, "latent_dim": P1_LATENT})
    tr8c.build({k: v.cpu() for k, v in st8.obs.items()})
    tr8c.actor.load_state_dict({k: v.cpu() for k, v in tr8.actor.state_dict().items()})
    with torch.no_grad():
        fwd = [rel_err(a, b) for a, b in zip(
            tr8.actor.head(tr8.actor.latent(tr8.actor.extractor(st8.obs))),
            tr8c.actor.head(tr8c.actor.latent(tr8c.actor.extractor(
                {k: v.cpu() for k, v in st8.obs.items()}))))]
    noise = torch.randn((4, 8, 4), generator=torch.Generator().manual_seed(303))
    grads, losses, depth_off = [], [], []
    for t, state, obs, eps in (
            (tr8, st8.env_state, st8.obs, noise.to(dev)),
            (tr8c, to_device(st8.env_state, "cpu", torch.Generator().manual_seed(0)),
             {k: v.cpu() for k, v in st8.obs.items()}, noise)):
        loss, (_, last_obs, _, metrics) = t._rollout_loss(state, obs, None, (), eps)
        loss.backward()
        check(not bool(metrics[1].any()), "P1 card vs cpu: an agent was done within H = 4")
        losses.append(float(loss.detach()))
        depth_off.append(last_obs["depth"].detach().cpu())
        grads.append({n: p.grad.detach().cpu() for n, p in t.actor.named_parameters()})
    count("P1 card vs cpu", {"trace_analytic": 1 + tr8.H})  # the card's reset and H steps
    g_rel = max(rel_err(g, grads[1][n]) for n, g in grads[0].items())
    g_zero = [n for n, g in grads[1].items() if not bool(g.abs().max() > 0)]
    check(not g_zero, f"P1 card vs cpu: no gradient reached {g_zero}")
    px = int(((depth_off[0] - depth_off[1]).abs() > T_TOL).sum())
    print(f"phase 5 | path P1 card vs cpu (8 agents, H=4, same parameters, state and noise): "
          f"actor forward (mean, log-std) max relative difference {max(fwd):.3e}, |d loss| "
          f"{abs(losses[0] - losses[1]):.3e} (relative {abs(losses[0] - losses[1]) / abs(losses[1]):.3e}), "
          f"first gradient max relative difference {g_rel:.3e}, last depth off by > {T_TOL} m "
          f"on {px} pixels", flush=True)
    check(max(fwd) <= GRAD_TOL, f"P1 actor forward card vs cpu {max(fwd)} > {GRAD_TOL}")
    check(abs(losses[0] - losses[1]) <= GRAD_TOL * abs(losses[1]), "P1 loss card vs cpu")
    check(g_rel <= GRAD_TOL, f"P1 first gradient card vs cpu {g_rel} > {GRAD_TOL}")

    # the nine backbones at 256 x 1 x 64 x 64 on the card, each held to its
    # CPU forward on 8 of the images
    x = torch.rand((N_AGENTS, 1, *RES), generator=torch.Generator().manual_seed(304))
    xd = x.to(dev)
    for i, name in enumerate(BACKBONE_NAMES):
        net = loaded_backbone(name, 310 + i)
        with torch.no_grad():
            ref = net(x[:8])
            net_d = copy.deepcopy(net).to(dev)
            out = net_d(xd)
            ms = cuda_ms(lambda: net_d(xd), reps=5, warmup=1)
        err = (out[:8].cpu() - ref).abs()
        bad = int((err > BACKBONE_ATOL + BACKBONE_RTOL * ref.abs()).sum())
        print(f"phase 4 | path P1 backbone {name}: forward of {N_AGENTS}x1x64x64 depth "
              f"{ms:.2f} ms, {tuple(out.shape[1:])} features, card vs cpu on 8 images max "
              f"|d| {float(err.max()):.3e} (of max |y| {float(ref.abs().max()):.3e}), {bad} "
              f"past atol {BACKBONE_ATOL} + rtol {BACKBONE_RTOL} | {card}", flush=True)
        check(bool(torch.isfinite(out).all()) and bad == 0, f"P1 backbone {name} card vs cpu")
        del net, net_d

    # P4: P1's trained actor into a PPO policy of the same net_arch
    ppo = PPO(tr1.env, n_steps=32, n_epochs=2,
              policy_kwargs={"net_arch": P1_ARCH, "pi_layers": list(P1_LATENT),
                             "vf_layers": [64, 64]})
    reset_launches()
    st4 = ppo.init(torch.Generator(device=dev).manual_seed(320))
    ppo.policy.load_state_dict(actor_to_policy_params(tr1.actor, ppo.policy))
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with torch.no_grad():
        mean, _, _ = ppo.policy(st4.obs)
        pre = tr1.actor.head.mu(tr1.actor.latent(tr1.actor.extractor(st4.obs)))
    torch.backends.cudnn.deterministic = cudnn
    check(torch.equal(mean, pre), "P4: the policy's mean is not the actor's")
    vf = {n: p.detach().clone() for n, p in ppo.policy.named_parameters()
          if "mlp_vf" in n or "value" in n}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st4, m4 = ppo.update(st4)
    torch.cuda.synchronize()
    ms4 = (time.perf_counter() - t0) * 1e3
    moved = [n for n, p in ppo.policy.named_parameters() if n in vf and not torch.equal(p, vf[n])]
    check(sorted(moved) == sorted(vf), f"P4: value branch did not move: {set(vf) - set(moved)}")
    check(bool(torch.isfinite(m4["loss"])), "P4: PPO loss not finite")
    used = count("P4", {"trace_analytic": 1 + 2 * ppo.n_steps})
    print(f"phase 4 | path P4 (BPTT actor -> PPO): mean equal to the actor's pre-tanh mean "
          f"bitwise on {tr1.env.num_envs} agents; one PPO update ({ppo.n_steps} steps, "
          f"{ppo.n_epochs} epochs) {used} launches, {ms4:.1f} ms, loss {float(m4['loss']):.4f}, "
          f"mlp_vf and value moved | {card}", flush=True)
    del ppo, st4, tr8, tr8c, st8

    # P2: the depth leg's env with a world model
    env2 = bench_env(dev)
    _, obs = env2.reset(torch.Generator(device=dev).manual_seed(330))
    world = create_world_model(obs, deter_dim=128, stoch_dim=32)
    sps = {}
    for label in ("without", "with"):
        if label == "with":
            env2.initialize_latent(128, 32, world)
        _, out, sps[label], counts, dt = drive(env2, 331, 1, CHUNK,
                                               lambda steps: {"trace_analytic": 1 + steps})
        for k, v in counts.items():
            launches[k] += v
    check(out.obs["deter"].shape == (N_AGENTS, 128) and out.obs["stoch"].shape == (N_AGENTS, 32),
          "P2: latent shapes")
    check(bool(out.obs["deter"].abs().max() > 0), "P2: the latents did not move")
    reset_launches()
    state2, obs2 = env2.reset(torch.Generator(device=dev).manual_seed(332))
    a2 = torch.rand((N_AGENTS, 4), generator=torch.Generator(device=dev).manual_seed(333),
                    device=dev) * 0.6 - 0.3
    state2, out2 = env2.step(state2, a2)
    # done agents: the first 16 at their last step, stepped without the auto-reset
    state2 = state2._replace(step_count=torch.where(
        torch.arange(N_AGENTS, device=dev) < 16, env2.max_episode_steps - 1,
        state2.step_count).to(state2.step_count.dtype))
    gen_state = state2.gen.get_state()
    latent_in = state2.latent
    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the replay below holds the step bitwise
    state3, out3 = env2.step(state2, a2, is_test=True)
    done = out3.done
    check(bool(done[:16].all()), "P2: the agents at their last step are not done")
    g = torch.Generator(device=dev)
    g.set_state(gen_state)
    plain_obs = {k: v for k, v in out3.obs.items() if k not in ("deter", "stoch")}
    zeroed = [torch.where(done[:, None], torch.zeros_like(x), x) for x in latent_in]
    with torch.no_grad():
        stoch, deter = world.step(a2, zeroed[1], zeroed[0], plain_obs, g)
    torch.backends.cudnn.deterministic = cudnn
    check(torch.equal(out3.obs["deter"], deter) and torch.equal(out3.obs["stoch"], stoch),
          "P2: done agents' latents were not zeroed before the update")
    world_cpu = copy.deepcopy(world).cpu()
    with torch.no_grad():
        s_card, d_card = world.step(a2, *latent_in[::-1], plain_obs, deterministic=True)
        s_cpu, d_cpu = world_cpu.step(a2.cpu(), *(x.cpu() for x in latent_in[::-1]),
                                      {k: v.cpu() for k, v in plain_obs.items()},
                                      deterministic=True)
        recon = world.decode(out3.obs["deter"], out3.obs["stoch"])
    lat_err = max(float((s_card.cpu() - s_cpu).abs().max()),
                  float((d_card.cpu() - d_cpu).abs().max()))
    check(tuple(recon.shape) == tuple(out3.obs["state"].shape), "P2: decode's shape")
    print(f"phase 5 | path P2 card vs cpu: deter/stoch after one deterministic posterior step "
          f"max |d| {lat_err:.3e}; the 16 done agents' latents zeroed before the update "
          f"(bitwise); decode {tuple(recon.shape)}", flush=True)
    check(lat_err <= OBS_TOL, f"P2 latents card vs cpu {lat_err} > {OBS_TOL}")
    count("P2 card vs cpu", {"trace_analytic": 3})  # the reset and two steps
    print(f"phase 4 | path P2 (world-model env): {sps['with']:.1f} env steps/s with the world "
          f"model (deter 128, stoch 32), {sps['without']:.1f} without ({N_AGENTS} agents, 64x64 "
          f"depth, 1 timed chunk of {CHUNK}) | {card}", flush=True)
    del env2, world, world_cpu

    # P2's PPO update: path G's recipe, the latent keys and depth
    env_g = NavigationEnv(device=dev, **CLUTTERED_FLIGHT)
    _, obs_g = env_g.reset(torch.Generator(device=dev).manual_seed(340))
    env_g.initialize_latent(128, 32, create_world_model(obs_g, deter_dim=128, stoch_dim=32))
    arch = dict(EXTRACTOR_ALIASES["LatentCombineExtractor"], depth={"cnn": 128})
    # 32 steps of the recipe's 256
    kw = dict(PPO_TUNED, n_steps=32, policy_kwargs=dict(PPO_TUNED["policy_kwargs"], net_arch=arch))
    tr_l = PPO(env_g, **kw)
    reset_launches()
    st_l = tr_l.init(torch.Generator(device=dev).manual_seed(341))
    before = snapshot(tr_l)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_l, m_l = tr_l.update(st_l)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    used = count("P2 PPO", {"trace_analytic": 1 + 2 * tr_l.n_steps})
    check_trained("P2 PPO", tr_l, st_l, m_l, before, "loss", dev)
    check({"deter", "stoch", "depth", "state"} <= set(st_l.obs), "P2 PPO: observation keys")
    print(f"phase 4 | path P2 (PPO_tuned on cluttered_flight with the latents): {used} "
          f"launches in 1 update | {dt * 1e3:.1f} ms an update ({env_g.num_envs} agents x "
          f"{tr_l.n_steps} steps); loss {float(m_l['loss']):.4f}, gradient norm "
          f"{float(m_l['grad_norm']):.4f} | {card}", flush=True)
    del tr_l, st_l, env_g

    # P3: the depth autoencoder on frames from B1
    env3 = bench_env(dev)
    reset_launches()
    frames = collect_depth_frames(env3, 4096, torch.Generator(device=dev).manual_seed(350))
    used = count("P3", {"trace_analytic": 1 + 4096 // N_AGENTS})
    check(tuple(frames.shape) == (4096, 1, *RES) and float(frames.min()) >= 0
          and float(frames.max()) <= 1, "P3: frames")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = train_autoencoder(frames, latent_dim=64, batch_size=128, n_steps=200,
                                      log_interval=0,
                                      generator=torch.Generator(device=dev).manual_seed(351))
    torch.cuda.synchronize()
    ms3 = (time.perf_counter() - t0) / 200 * 1e3
    first, last = sum(losses[:20]) / 20, sum(losses[-20:]) / 20
    check(last < first, f"P3: the MSE did not fall ({first} -> {last})")
    print(f"phase 4 | path P3 (depth autoencoder): {used} launches collecting 4096 frames | "
          f"{ms3:.2f} ms a step (latent 64, batch 128, 200 steps); MSE of the first 20 steps "
          f"{first:.5f}, of the last 20 {last:.5f} | {card}", flush=True)
    # one Adam step card vs CPU, from the same parameters and batch, cuDNN deterministic
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    idx = torch.randint(0, 4096, (1, 128), generator=torch.Generator().manual_seed(352))
    model_cpu = copy.deepcopy(model).cpu()
    _, l_card = train_autoencoder(frames, n_steps=1, log_interval=0, model=model,
                                  batch_idx=idx)
    _, l_cpu = train_autoencoder(frames.cpu(), n_steps=1, log_interval=0, model=model_cpu,
                                 batch_idx=idx)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    pa = torch.cat([p.detach().flatten().cpu() for p in model.parameters()])
    pb = torch.cat([p.detach().flatten() for p in model_cpu.parameters()])
    p_l2 = float(torch.linalg.vector_norm(pa - pb) / torch.linalg.vector_norm(pb))
    print(f"phase 5 | path P3 card vs cpu (one Adam step, same parameters and batch): |d loss| "
          f"{abs(l_card[0] - l_cpu[0]):.3e}, parameters l2 relative difference {p_l2:.3e}",
          flush=True)
    check(abs(l_card[0] - l_cpu[0]) <= 1e-5, "P3 loss card vs cpu")
    check(p_l2 <= GRAD_TOL, f"P3 parameters card vs cpu {p_l2} > {GRAD_TOL}")
    del env3, frames, model, model_cpu

    # P5: data parallel in separate processes, two gloo ranks on the one card
    # and one NCCL rank, against one process
    single = {"hover": p_bptt_rank(_one_rank(dev), False, 128, 360),
              "visual": p_bptt_rank(_one_rank(dev), True, 64, 361)}
    for name, legs in (("gloo x 2", run_ranks(p_ranks, 2, 360, backend="gloo", device=dev,
                                               timeout=600)),
                       ("nccl x 1", run_ranks(p_ranks, 1, 360, backend="nccl", device=dev,
                                               timeout=600))):
        for leg, want in single.items():
            outs = [r[leg] for r in legs]
            d_loss = max(abs(a - b) / abs(b) for o in outs for a, b in zip(o["loss"], want["loss"]))
            pa = outs[0]["params"]
            p_l2 = float(torch.linalg.vector_norm(pa - want["params"])
                         / torch.linalg.vector_norm(want["params"]))
            pos = torch.cat([o["pos"] for o in outs])
            d_pos = float((pos - want["pos"]).abs().max())
            same = all(torch.equal(o["params"], pa) for o in outs)
            renders = 1 + outs[0]["steps"] if leg == "visual" else 0
            for r, o in enumerate(outs):
                want_l = {"trace_analytic": renders} if renders else {}
                got = {k: v for k, v in o["launches"].items() if v}
                check(got == want_l, f"P5 {name} {leg} rank {r}: launches {got} != {want_l}")
                for k, v in o["launches"].items():
                    launches[k] += v
            print(f"phase 5 | path P5 {name} {leg} ({o['device']}): loss relative difference "
                  f"{d_loss:.3e}, parameters l2 {p_l2:.3e}, positions max |d| {d_pos:.3e}, ranks "
                  f"{'equal' if same else 'DIFFER'}; {max(o['ms'] for o in outs):.1f} ms an "
                  f"update (one process: {want['ms']:.1f}); B1 launches a rank "
                  f"{outs[0]['launches']['trace_analytic']} | {card}", flush=True)
            check(d_loss <= 1e-5, f"P5 {name} {leg}: loss {d_loss} > 1e-5")
            check(p_l2 <= GRAD_TOL, f"P5 {name} {leg}: parameters {p_l2} > {GRAD_TOL}")
            check(d_pos <= 1e-5, f"P5 {name} {leg}: positions {d_pos} > 1e-5")
            check(same, f"P5 {name} {leg}: the ranks' parameters differ")
    for leg, want in single.items():
        for k, v in want["launches"].items():
            launches[k] += v
    print(f"phase 4 | path P: {time.perf_counter() - t_path:.1f} s | {card}", flush=True)


Q_STUDENT_MARGIN = 0.15  # the student's success may trail the teacher's by this much


@contextlib.contextmanager
def recorded(cls):
    """While open, every trainer of ``cls`` records its parameters after
    ``init`` (``rec["before"]``) and its last update's metrics
    (``rec["metrics"]``, ``rec["updates"]``): what ``check_trained`` needs of
    a run that an entry point drives."""
    rec = {"before": None, "metrics": None, "updates": 0}
    init, update = cls.init, cls.update

    def init_(self, *args, **kwargs):
        st = init(self, *args, **kwargs)
        rec["before"] = snapshot(self)
        return st

    def update_(self, *args, **kwargs):
        st, m = update(self, *args, **kwargs)
        rec["metrics"], rec["updates"] = m, rec["updates"] + 1
        return st, m

    cls.init, cls.update = init_, update_
    try:
        yield rec
    finally:
        cls.init, cls.update = init, update


def _q1_process(path):
    """Q1 in a process of its own, beside paths E-P: ``reproduce.run_row
    ("navigation2")`` in full at seed 42 on the card, checked as path G's
    trainer is; the trained state saved to ``path`` (``.pt``) for Q2, the
    numbers to ``path.json``, the output to ``path.log``."""
    sys.path.insert(0, REPO)
    import torch

    from visfly_tpu_torch.algos import BPTT
    from visfly_tpu_torch.examples import reproduce

    dev = torch.device("cuda", 0)
    with open(path + ".log", "w", buffering=1) as log, contextlib.redirect_stdout(log), \
            contextlib.redirect_stderr(log):
        reset_launches()
        t0 = time.perf_counter()
        with recorded(BPTT) as rec:
            r = reproduce.run_row("navigation2", reproduce.ROWS["navigation2"], seed=42, device=dev)
        row_s = time.perf_counter() - t0
        counts = all_launches()
        check(not any(counts.values()), f"Q1: launched {counts}")
        check(r["n_updates"] == 162 and rec["updates"] == 162,
              f"Q1: {r['n_updates']} updates ({rec['updates']} run), not 500,000 // (96 x 32)")
        tr, m = r["model"], rec["metrics"]
        check_trained("Q1", tr, r["state"], m, rec["before"], "actor_loss", dev)
        teacher = tr.save(r["state"], path)
    with open(path + ".json", "w") as f:
        json.dump({"success": r["success"], "reward": r["reward"], "train_s": r["train_s"],
                   "n_updates": r["n_updates"], "row_s": row_s, "agents": tr.env.num_envs,
                   "H": tr.H, "loss": float(m["actor_loss"]), "teacher": teacher}, f)


def start_q1():
    """Start Q1's process (spawned, daemonic: it ends with the smoke) →
    (the process, its temporary directory, the path its files share)."""
    import multiprocessing

    tmp = tempfile.TemporaryDirectory(prefix="visfly_q1_")
    path = os.path.join(tmp.name, "navigation2_bptt_seed42")
    proc = multiprocessing.get_context("spawn").Process(target=_q1_process, args=(path,),
                                                        daemon=True)
    proc.start()
    return proc, tmp, path


def published_results_path(dev, card, launches, q1):
    """Path Q, the published results through the port's example scripts: Q1
    the navigation2 row of ``reproduce.py`` in full (its process, started
    before path E, joined here), Q2 the distillation on Q1's teacher, loaded
    from its checkpoint as the script loads one, Q3 the landing2 and racing2
    rows cut to one update, Q4 ``train_imported_mesh`` cut to one update and
    a 32-step evaluation."""
    import torch

    from visfly_tpu_torch.algos import BPTT, PPO
    from visfly_tpu_torch.examples import distill_vision, reproduce, train_imported_mesh
    from visfly_tpu_torch.run import resolve

    t_path = time.perf_counter()

    # Q1: the row in full at its pinned seed; no camera, so no kernel
    proc, tmp, path = q1
    proc.join(timeout=900)
    alive = proc.is_alive()
    if alive:
        proc.kill()
        proc.join()
    with open(path + ".log") as f:
        tail = f.read().splitlines()[-12:]
    check(not alive and proc.exitcode == 0,
          f"Q1's process {'still running after 900 s' if alive else f'exit {proc.exitcode}'}: "
          + "\n".join(tail))
    with open(path + ".json") as f:
        r = json.load(f)
    spec = reproduce.ROWS["navigation2"]
    print(f"phase 4 | path Q1 (reproduce.py navigation2, BPTT, seed 42, in full, in its own "
          f"process beside paths E-P): no kernel launches | eval success {r['success']:.4f} "
          f"(claim {spec['claim']} ± {spec['tol']}: bar {spec['claim'] - spec['tol']:.2f}), "
          f"reward {r['reward']:.4f}; train {r['train_s']:.1f} s, "
          f"{r['train_s'] / r['n_updates'] * 1e3:.1f} ms an update ({r['agents']} agents, "
          f"H={r['H']}, {r['n_updates']} updates; last loss {r['loss']:.4f}); row "
          f"{r['row_s']:.1f} s; joined {time.perf_counter() - t_path:.1f} s after path P | "
          f"{card}", flush=True)
    check(reproduce.passes(spec, r["success"]),
          f"Q1: eval success {r['success']} misses the row's bar")

    # Q2: the distillation at the script's defaults on Q1's teacher, loaded
    # from its checkpoint; B1 once a render: the reset, 6 × 96 collection
    # steps, and each evaluation's reset and steps
    reset_launches()
    t0 = time.perf_counter()
    out = distill_vision.main(["--teacher", r["teacher"]], device=dev)
    tmp.cleanup()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rounds, t_stats, s_stats = out["rounds"], out["teacher"], out["student"]
    for i, rd in enumerate(rounds):
        print(f"phase 4 | path Q2 round {i}: beta {rd['beta']:.2f}, dataset {rd['dataset']}, "
              f"loss {rd['first_loss']:.5f} → {rd['loss']:.5f}, {rd['seconds']:.1f} s | {card}",
              flush=True)
    counts = all_launches()
    want = {k: 0 for k in counts}
    want["trace_analytic"] = 1 + 6 * 96 + (1 + t_stats["steps"]) + (1 + s_stats["steps"])
    check(counts == want, f"Q2: kernel launches {counts} != expected {want}")
    launches["trace_analytic"] += counts["trace_analytic"]
    print(f"phase 4 | path Q2 (distill_vision.py --teacher <Q1's checkpoint>, 96 agents, 64x64 "
          f"depth, 6 rounds x 96 steps, 40 epochs): {{'trace_analytic': "
          f"{counts['trace_analytic']}}} "
          f"launches = 1 + 6 x 96 + (1 + {t_stats['steps']}) + (1 + {s_stats['steps']}) | "
          f"teacher success {t_stats['eval/success_rate']:.4f} (reward "
          f"{t_stats['eval/ep_rew_mean']:.4f}), student {s_stats['eval/success_rate']:.4f} "
          f"(reward {s_stats['eval/ep_rew_mean']:.4f}); {dt:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.1f} GiB | {card}", flush=True)
    check(len(rounds) == 6 and rounds[-1]["dataset"] == 6 * 96 * 96, "Q2: rounds or dataset")
    check(all(math.isfinite(rd["loss"]) for rd in rounds), "Q2: a loss is not finite")
    check(rounds[-1]["loss"] < rounds[0]["loss"],
          f"Q2: last round's loss {rounds[-1]['loss']} not below the first's {rounds[0]['loss']}")
    check(s_stats["eval/success_rate"] >= t_stats["eval/success_rate"] - Q_STUDENT_MARGIN,
          f"Q2: student success {s_stats['eval/success_rate']} more than {Q_STUDENT_MARGIN} "
          f"below the teacher's {t_stats['eval/success_rate']}")
    del out

    # Q3: the landing2 and racing2 rows through the same run_row, one update
    for name in ("landing2", "racing2"):
        spec = reproduce.ROWS[name]
        _, _, env_config, alg_config = resolve(name, spec["algo"])
        n_env = env_config["env"]["num_agent_per_scene"]
        n_steps = alg_config["algorithm"]["n_steps"]
        reset_launches()
        t0 = time.perf_counter()
        with recorded(PPO) as rec:
            r = reproduce.run_row(name, spec, seed=42, device=dev,
                                  cut={"total_timesteps": n_env * n_steps})
        dt = time.perf_counter() - t0
        counts = all_launches()
        check(not any(counts.values()), f"Q3 {name}: launched {counts}")
        check(r["n_updates"] == rec["updates"] == 1, f"Q3 {name}: {rec['updates']} updates")
        check_trained(f"Q3 {name}", r["model"], r["state"], rec["metrics"], rec["before"],
                      "loss", dev)
        if spec.get("metric") == "gates":
            check(r["success"] == int(r["success"]) and 0 <= r["success"] <= 4
                  and 0 <= r["sto_min"] <= r["sto_mean"] <= 4, f"Q3 {name}: gates {r}")
            what = (f"min gates an agent {r['success']:.0f}, mean {r['reward']:.2f} "
                    f"(deterministic replay); stochastic min {r['sto_min']:.0f}, mean "
                    f"{r['sto_mean']:.2f}")
        else:
            check(0.0 <= r["success"] <= 1.0, f"Q3 {name}: success {r['success']}")
            what = f"eval success {r['success']:.4f}, reward {r['reward']:.4f}"
        print(f"phase 4 | path Q3 (reproduce.py {name}, PPO, one update): no kernel launches | "
              f"{what}; loss {float(rec['metrics']['loss']):.4f}; train {r['train_s'] * 1e3:.1f} "
              f"ms an update ({n_env} agents x {n_steps} steps); row {dt:.1f} s | {card}",
              flush=True)
        del r

    # Q4: the imported garage, one update and a 32-step evaluation; no camera
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="visfly_q4_") as tmp, recorded(BPTT) as rec:
        out = train_imported_mesh.train(timesteps=96 * 32, device=dev, save_dir=tmp,
                                        eval_steps=32)
        check(os.path.isfile(out["checkpoint"]), "Q4: no checkpoint")
        dt = time.perf_counter() - t0
    counts = all_launches()
    check(not any(counts.values()), f"Q4: launched {counts}")
    tr = out["trainer"]
    check(rec["updates"] == 1 and tr.env.scene.triangles.shape[1] == 360,
          f"Q4: {rec['updates']} updates, {tr.env.scene.triangles.shape[1]} triangles")
    check_trained("Q4", tr, out["state"], rec["metrics"], rec["before"], "actor_loss", dev)
    stats = out["stats"]
    check(0.0 <= stats["success_rate"] <= 1.0 and math.isfinite(stats["mean_return"]),
          f"Q4: evaluation {stats['success_rate']}, {stats['mean_return']}")
    print(f"phase 4 | path Q4 (train_imported_mesh.py, 24-pillar garage OBJ, 360 triangles, "
          f"grid backend, one update): no kernel launches | train {out['train_s'] * 1e3:.1f} ms "
          f"an update (96 agents, H=32); TestBase 32 steps at 48 agents: success "
          f"{stats['success_rate']:.4f}, return {stats['mean_return']:.4f}; {dt:.1f} s | {card}",
          flush=True)
    print(f"phase 4 | path Q: {time.perf_counter() - t_path:.1f} s | {card}", flush=True)


def r_leg(mesh, name, seed):
    """:func:`_r_leg` with cuDNN's deterministic algorithms. The default ones
    differ from run to run in the last bits; over R4's ten epochs PPO's
    clipped ratios once grew that to 1.9e-3 of the loss against one process
    (PERF.md §6), where deterministic runs repeat to the bit."""
    import torch

    cudnn = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _r_leg(mesh, name, seed)
    finally:
        torch.backends.cudnn.deterministic = cudnn


def _r_leg(mesh, name, seed):
    """Path R's leg ``name`` on ``mesh``'s rank (one process where the mesh
    is ``_one_rank``'s): R1 SHAC on ``cluttered_flight`` (one update), R2 APG
    on ``navigation2`` (two, the second timed), R3 SAC on ``navigation2`` (two
    collecting env steps, one training step cut to one gradient step, then
    two training steps of the file's 32, the second timed), R4 the recurrent
    PPO_tuned on ``cluttered_flight`` cut to 32 steps (one update) → loss,
    parameters and positions after the checked update (R3's first training
    step; the parameters and loss after its last beside them as ``drift``),
    ms, launches, ring bytes, whether every tensor of the state is on the
    card."""
    import torch

    from visfly_tpu_torch.algos import APG, PPO, SAC, SHAC, buffers
    from visfly_tpu_torch.envs import NavigationEnv, NavigationEnv2
    from visfly_tpu_torch.parallel import make_rank_env, shard_train_state

    def env_of(cls, kw):
        kw = dict(kw)
        return make_rank_env(cls, mesh, kw.pop("num_agent_per_scene"), device=mesh.device, **kw)

    reset_launches()
    if name == "R1":
        tr = SHAC(env_of(NavigationEnv, dict(CLUTTERED_FLIGHT, **SHAC_CLUTTERED_ENV)),
                  **SHAC_CLUTTERED)
    elif name == "R2":
        tr = APG(env_of(NavigationEnv2, NAVIGATION2), **APG_NAV2)
    elif name == "R3":
        tr = SAC(env_of(NavigationEnv2, dict(NAVIGATION2, **SAC_NAV2_ENV)),
                 **dict(SAC_NAV2, learning_starts=R_SAC_COLLECT * SAC_NAV2_ENV[
                     "num_agent_per_scene"]))
    else:
        tr = PPO(env_of(NavigationEnv, CLUTTERED_FLIGHT), **dict(
            PPO_TUNED, n_steps=32, policy_kwargs=dict(PPO_TUNED["policy_kwargs"],
                                                      recurrent=True)))
    st = tr.init(torch.Generator(device=mesh.device).manual_seed(seed))
    if mesh.size > 1 or mesh.backend == "nccl":
        st = shard_train_state(st, mesh, tr)
    nets = [getattr(tr, k) for k in ("actor", "critic", "critic_target", "policy")
            if getattr(tr, k, None) is not None]

    def params():
        return torch.cat([p.detach().flatten().cpu() for net in nets for p in net.parameters()]
                         + ([tr.log_alpha.detach().reshape(1).cpu()] if name == "R3" else []))

    drift = None
    if name == "R3":
        for _ in range(R_SAC_COLLECT):
            st, m = tr.step_and_train(st, train=False)
        # the checked step: one gradient step from states equal to the one
        # process's; 64 more steps of Adam and bootstrapped targets grow the
        # rounding of the sharded sums (PERF.md §6), which "drift" shows
        tr.gradient_steps = 1
        st, m = tr.step_and_train(st, train=True)
        checked = (float(m["critic_loss"]), float(m["grad_norm"]), params(),
                   st.env_state.dyn.pos.detach().cpu())
        tr.gradient_steps = SAC_NAV2["gradient_steps"]
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = tr.step_and_train(st, train=True)
        drift = (float(m["critic_loss"]), params())
    else:
        for _ in range(2 if name == "R2" else 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = tr.update(st)
        loss_key = {"R1": "actor_loss", "R2": "loss", "R4": "loss"}[name]
        checked = (float(m[loss_key]), float(m["grad_norm"]), params(),
                   st.env_state.dyn.pos.detach().cpu())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    loss, grad_norm, p, pos = checked
    return {"loss": loss, "grad_norm": grad_norm, "params": p, "pos": pos, "drift": drift,
            "ms": ms, "launches": all_launches(),
            "on_card": all(t.device == mesh.device for t in tensors_of(tuple(st))),
            "ring_bytes": buffers.nbytes(st.buffer) if name == "R3" else 0,
            "agents": tr.env.num_agent, "device": str(mesh.device)}


def r_ranks(mesh, seed):
    """Path R's legs on one rank, in order."""
    return {name: r_leg(mesh, name, seed + i) for i, name in enumerate(R_LEGS)}


def scale_out_path(dev, card, launches):
    """Path R: data parallelism for SHAC, APG, SAC and the recurrent PPO at
    their repo configurations' widths, two gloo ranks on the one card and a
    world-size-1 NCCL group, each leg against one process from the same seed;
    adds the launches of every process to ``launches``."""
    import torch

    from visfly_tpu_torch.parallel import run_ranks

    t_path = time.perf_counter()
    single = {name: r_leg(_one_rank(dev), name, 370 + i) for i, name in enumerate(R_LEGS)}
    groups = (("gloo x 2", run_ranks(r_ranks, 2, 370, backend="gloo", device=dev, timeout=600)),
              ("nccl x 1", run_ranks(r_ranks, 1, 370, backend="nccl", device=dev, timeout=600)))
    for name, want in single.items():
        renders = R_LEGS[name]
        got = {k: v for k, v in want["launches"].items() if v}
        check(got == ({"trace_analytic": renders} if renders else {}),
              f"R {name} one process: launches {got}")
        check(want["on_card"], f"R {name} one process: state tensors off the card")
        for k, v in want["launches"].items():
            launches[k] += v
        for group, legs in groups:
            outs = [r[name] for r in legs]
            d_loss = max(abs(o["loss"] - want["loss"]) / abs(want["loss"]) for o in outs)
            pa = outs[0]["params"]
            p_l2 = float(torch.linalg.vector_norm(pa - want["params"])
                         / torch.linalg.vector_norm(want["params"]))
            d_pos = float((torch.cat([o["pos"] for o in outs]) - want["pos"]).abs().max())
            same = all(torch.equal(o["params"], pa) for o in outs)
            for r, o in enumerate(outs):
                got = {k: v for k, v in o["launches"].items() if v}
                check(got == ({"trace_analytic": renders} if renders else {}),
                      f"R {name} {group} rank {r}: launches {got}, {renders} renders")
                check(o["on_card"], f"R {name} {group} rank {r}: state tensors off the card")
                for k, v in o["launches"].items():
                    launches[k] += v
            ring = ""
            if name == "R3":
                d_drift = max(abs(o["drift"][0] - want["drift"][0]) / abs(want["drift"][0])
                              for o in outs)
                p_drift = float(torch.linalg.vector_norm(outs[0]["drift"][1] - want["drift"][1])
                                / torch.linalg.vector_norm(want["drift"][1]))
                check(all(torch.equal(o["drift"][1], outs[0]["drift"][1]) for o in outs),
                      f"R3 {group}: the ranks' parameters differ after 65 gradient steps")
                ring = (f"; after 64 more gradient steps: loss relative difference "
                        f"{d_drift:.3e}, parameters l2 {p_drift:.3e}, ranks equal; ring bytes a "
                        f"rank {', '.join(str(o['ring_bytes']) for o in outs)} (one process "
                        f"{want['ring_bytes']})")
            print(f"phase 4 | path {name} {group} ({outs[0]['agents']} agents a rank, "
                  f"{o['device']}): loss relative difference {d_loss:.3e}, parameters l2 "
                  f"{p_l2:.3e}, positions max |d| {d_pos:.3e}, ranks "
                  f"{'equal' if same else 'DIFFER'}; {max(o['ms'] for o in outs):.1f} ms "
                  f"(one process: {want['ms']:.1f}); B1 launches a rank "
                  f"{outs[0]['launches']['trace_analytic']}{ring} | {card}", flush=True)
            # PPO's loss is a difference of terms of order 1 (R4: ~1e-2), so its
            # rounding is held as tests/test_torch_parallel.py holds PPO's metrics
            check(all(abs(o["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]) + 1e-6
                      for o in outs), f"R {name} {group}: loss {d_loss} > 1e-5 (+ 1e-6)")
            check(p_l2 <= GRAD_TOL, f"R {name} {group}: parameters {p_l2} > {GRAD_TOL}")
            check(d_pos <= 1e-5, f"R {name} {group}: positions {d_pos} > 1e-5")
            check(same, f"R {name} {group}: the ranks' parameters differ")
            if name == "R3" and group == "gloo x 2":
                check(all(o["ring_bytes"] < 0.51 * want["ring_bytes"] for o in outs),
                      "R3: a rank holds more than its share of the ring and one step")
    print(f"phase 4 | path R: {time.perf_counter() - t_path:.1f} s | {card}", flush=True)


def user_scripts_path(dev, card, launches):
    """Path S: the debugging and demo scripts, each once through ``main`` as
    a user runs it, at its defaults, its files in a temporary directory."""
    import numpy as np
    import torch

    from visfly_tpu_torch.examples import debug_obs, habitat_dataset_demo, vision_grad_probe

    t_path = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="visfly_scripts_") as tmp:
        # S1: 4 agents, 3 cameras, 40 steps, the frames and the 480x640 view
        reset_launches()
        t0 = time.perf_counter()
        out = debug_obs.main(["--out", os.path.join(tmp, "obs")], device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        used = {k: v for k, v in all_launches().items() if v}
        want = {"trace_analytic": 1 + 40 + 1, "trace_analytic_kid": 2 * (1 + 40 + 1) + 1}
        check(used == want, f"S1 debug_obs: launches {used} != {want}")
        check(len(out["files"]) == 7 and all(os.path.getsize(f) > 0 for f in out["files"]),
              "S1: frames not written")
        check(out["view"].shape == (480, 640, 3) and bool(np.isfinite(out["frames"]["depth"])
                                                          .all()), "S1: frames malformed")
        for k, v in used.items():
            launches[k] += v
        print(f"phase 4 | path S1 (debug_obs): {used} launches | depth "
              f"[{out['frames']['depth'].min():.2f}, {out['frames']['depth'].max():.2f}] m, "
              f"semantic ids {len(np.unique(out['frames']['semantic']))}; {dt:.1f} s | {card}",
              flush=True)

        # S2: the dataset written, two decomposed scenes (B1), a swap, the grid reload
        reset_launches()
        t0 = time.perf_counter()
        out = habitat_dataset_demo.main([os.path.join(tmp, "habitat")], device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        used = {k: v for k, v in all_launches().items() if v}
        tri = sum(v for k, v in used.items() if k.startswith("tri_"))
        check(used.get("trace_analytic") == 1 and tri == 1 and len(used) == 2,
              f"S2 habitat demo: launches {used}")
        check(out["same_shape"] and out["changed"], "S2: the swap changed no scene")
        check(bool(torch.isfinite(out["obs_exact"]["depth"]).all()), "S2: exact depth")
        for k, v in used.items():
            launches[k] += v
        print(f"phase 4 | path S2 (habitat_dataset_demo): {used} launches | "
              f"{out['env_exact'].scene.triangles.shape[1]} packed triangles, centre depth "
              f"{float(out['obs_exact']['depth'][0, 0, 16, 16]):.3f} m; {dt:.1f} s | {card}",
              flush=True)

    # S3: per-term gradient norms, 16 agents, H = 16, 64x64 depth, both settings
    reset_launches()
    t0 = time.perf_counter()
    out = vision_grad_probe.main([], device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    used = {k: v for k, v in all_launches().items() if v}
    check(used == {"trace_analytic": 2 * (1 + vision_grad_probe.H)},
          f"S3 vision_grad_probe: launches {used}")
    for flag, norms in out.items():
        check(norms["TOTAL"] > 0 and all(math.isfinite(v) for k, v in norms.items()
                                         if not k.startswith("cos")),
              f"S3 grad_collision={flag}: norms {norms}")
    check(out[False]["col_dis"] == 0.0, "S3: a detached query gave col_dis a gradient")
    for k, v in used.items():
        launches[k] += v
    print(f"phase 4 | path S3 (vision_grad_probe): {used} launches | TOTAL "
          f"{out[False]['TOTAL']:.3e} / {out[True]['TOTAL']:.3e}, col_dis 0 / "
          f"{out[True]['col_dis']:.3e} (detached / grad_collision); {dt:.1f} s | {card}",
          flush=True)
    print(f"phase 4 | path S: {time.perf_counter() - t_path:.1f} s | {card}", flush=True)


T1_STEPS = 100
T_ITERS = 20  # tri_bench's default
T3_ITERS = 3


def t1_fps(dev, card, launches):
    """T1: ``fps_test.main`` with four scenes and the imported OBJ, 200
    agents, ``--steps 100``; each env's launches counted around its
    ``measure`` (reset, the warm-up chunk and the timed steps)."""
    import torch

    from visfly_tpu_torch.examples import fps_test

    per_env = {}
    measure = fps_test.measure

    def counted(env, steps, label):
        reset_launches()
        fps = measure(env, steps, label)
        torch.cuda.synchronize()
        per_env[label] = {k: v for k, v in all_launches().items() if v}
        return fps

    fps_test.measure = counted
    t0 = time.perf_counter()
    try:
        rates = fps_test.main(["--steps", str(T1_STEPS), "--scenes", "4", "--mesh"], device=dev)
    finally:
        fps_test.measure = measure
    dt = time.perf_counter() - t0
    check(len(rates) == 5 and list(rates) == list(per_env), f"T1: envs {list(rates)}")
    # one render at the reset and one a step: the warm-up chunk and the timed ones
    renders = 1 + fps_test.CHUNK + T1_STEPS
    for label, used in per_env.items():
        want = {} if label == "physics-only" else {"trace_analytic": renders}
        check(used == want, f"T1 {label}: launches {used} != {want}")
        check(math.isfinite(rates[label]) and rates[label] > 0, f"T1 {label}: {rates[label]}")
        for k, v in used.items():
            launches[k] += v
    print(f"phase 4 | path T1 (fps_test --steps {T1_STEPS} --scenes 4 --mesh, 200 agents): "
          + "; ".join(f"{label} {rates[label]:.1f} agent steps/s, {per_env[label] or 'no kernel'}"
                      for label in rates)
          + f"; {dt:.1f} s | {card}", flush=True)


def t_check_line(name, lv):
    c = lv["check"]
    return (f"{name} T={lv['T']} cap={lv['cap']} block {lv['block']} ({lv['tier']}): "
            f"{lv['ms']:.3f} ms a frame batch, {lv['cam_fps']:.1f} cam-fps, "
            f"{lv['mray_s']:.1f} Mray/s, prepass {lv['prepass_ms']:.3f} ms, kernel "
            f"{lv['kernel_ms']:.3f} ms; check on {c['cams']} cameras: hit mismatches "
            f"{c['hit_mismatches']} of {c['rays']}, depth err max {c['depth_err_max']:.3e} m, "
            f"untied id mismatches {c['untied_id_mismatches']}; {c['rays_past_cap']} rays on "
            f"tiles past the cap; on the others {c['hit_mismatches_within_cap']}, "
            f"{c['depth_err_max_within_cap']:.3e} m, {c['untied_id_mismatches_within_cap']}")


def t_within_cap(name, c):
    """The check's rays of the tiles within the cap held to ``agree``'s
    limits of the brute force."""
    n = c["rays"] - c["rays_past_cap"]
    check(n > 0, f"{name}: every tile past the cap")
    check(c["depth_err_max_within_cap"] <= T_TOL,
          f"{name}: depth err {c['depth_err_max_within_cap']} > {T_TOL} within the cap")
    check(c["hit_mismatches_within_cap"] <= HIT_TOL * n,
          f"{name}: {c['hit_mismatches_within_cap']} hit mismatches of {n} within the cap")
    check(c["untied_id_mismatches_within_cap"] <= HIT_TOL * n,
          f"{name}: {c['untied_id_mismatches_within_cap']} id mismatches of {n} within the cap")


def t2_tri_bench(dev, card, launches):
    """T2: ``tri_bench.main`` at its defaults (256 cameras at 64×64, levels
    2, 3 and 4, 20 iterations) with ``--check``; the frame batch and the
    kernel alone each launch once a call, the check once a level."""
    from visfly_tpu_torch.examples import tri_bench

    reset_launches()
    t0 = time.perf_counter()
    out = tri_bench.main(["--levels", "2", "3", "4", "--check"], device=dev)
    dt = time.perf_counter() - t0
    used = {k: v for k, v in all_launches().items() if v}
    per_level = 2 * (1 + T_ITERS) + 1
    tiers = {lv["level"]: lv["tier"] for lv in out["levels"]}
    check(tiers == {2: "tri_trace_tile_sv", 3: "tri_trace_camsoup", 4: "tri_trace_camsoup"},
          f"T2: tiers {tiers}")
    want = {"tri_trace_tile_sv": per_level, "tri_trace_camsoup": 2 * per_level}
    check(used == want, f"T2: launches {used} != {want}")
    for k, v in used.items():
        launches[k] += v
    for lv in out["levels"]:
        c = lv["check"]
        print(f"phase 4 | path T2 {t_check_line('tri_bench', lv)} | {card}", flush=True)
        check(all(math.isfinite(lv[k]) and lv[k] > 0 for k in ("ms", "prepass_ms", "kernel_ms")),
              f"T2 level {lv['level']}: times")
        t_within_cap(f"T2 level {lv['level']}", c)
    print(f"phase 4 | path T2: {used} launches; {dt:.1f} s | {card}", flush=True)
    return out


def t2_kernel_at_92160(dev, card, errs, timing):
    """The per-camera kernel (B6) on T2's level-4 plan, 92,160 triangles at
    the default cap and 1,048,576 rays, against its plain version (its
    stats give the bound), with its time and the prepass's."""
    import torch

    from visfly_tpu_torch.examples import tri_bench
    from visfly_tpu_torch.render import default_tri_cap, pack_triangles
    from visfly_tpu_torch.render.tri_kernel import tri_first_hit, tri_first_hit_reference
    from visfly_tpu_torch.render.tri_trace import plan_tiles

    tris = torch.as_tensor(pack_triangles(*tri_bench.load_garage(4))[None], device=dev)
    T = tris.shape[1]
    cap = default_tri_cap(T)
    o_c, d_c = tri_bench.batch_rays(256, RES[1], dev)
    plan = plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap, RES[1], RES[0] * RES[1])
    args = (tris, plan.lists, plan.origins_c, plan.dirs_c, MAX_DEPTH, plan.form,
            plan.origin_tiles)
    stats = {}
    got = tri_first_hit(*args)
    t0 = time.perf_counter()
    want = tri_first_hit_reference(*args, stats=stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = agree(f"tri_trace_camsoup at {T} triangles (cap {cap}) vs plain", got, want)
    errs["tri_trace_camsoup"] = max(errs["tri_trace_camsoup"], err)
    ms = cuda_ms(lambda: tri_first_hit(*args))
    dev_ms = device_ms(lambda: tri_first_hit(*args))
    prepass_ms = cuda_ms(lambda: plan_tiles(tris, o_c, d_c, MAX_DEPTH, cap, RES[1],
                                            RES[0] * RES[1]), reps=5, warmup=1)
    n_rays = o_c.shape[2]
    b_ms, b_by, by_bytes = tri_bound_ms(plan.form, stats, n_rays, plan.lists)
    print(f"phase 4 | path T2 tri_trace_camsoup at {T} triangles, {n_rays} rays, cap {cap} "
          f"({plan.lists.lb.shape[-1]} stages, {stats['tests'] / n_rays:.1f} tests a ray): "
          f"kernel {ms:.4f} ms (device {dev_ms:.4f}, queued), plain {plain_ms:.2f} ms (once), "
          f"bound {b_ms:.4f} ms by {b_by} (bytes {by_bytes:.4f}), share {b_ms / dev_ms:.4f} "
          f"on the device; prepass {prepass_ms:.3f} ms | {card}", flush=True)
    timing["tri_trace_camsoup"]["ms_92160"] = ms
    timing["tri_trace_camsoup"]["device_ms_92160"] = dev_ms
    timing["tri_trace_camsoup"]["bound_ms_92160"] = b_ms


def t3_exact(dev, card, launches):
    """T3: level 4 on 8 cameras with ``--cap 92160 --check`` (lists that hold
    the whole mesh): the default body, the three variants and block sizes 64
    and 256 held to the brute force with ``agree``'s limits, and the two
    block sizes also to the default one."""
    from visfly_tpu_torch.examples import tri_bench

    base = ["--levels", "4", "--cams", "8", "--cap", "92160", "--check", "--iters",
            str(T3_ITERS)]
    runs = {"scalar": [], "merged": ["--variant", "merged"], "mx": ["--variant", "mx"],
            "wl": ["--variant", "wl"], "cluster 64": ["--cluster", "64"],
            "cluster 256": ["--cluster", "256"]}
    counted = {"scalar": "tri_trace_camsoup", "merged": "tri_trace_camsoup_merged",
               "mx": "tri_trace_camsoup_mx", "wl": "tri_trace_worklist",
               "cluster 64": "tri_trace_camsoup", "cluster 256": "tri_trace_camsoup"}
    blocks = {"wl": 16, "cluster 64": 64, "cluster 256": 128}  # 256: two stages of 128
    t0 = time.perf_counter()
    results = {}
    for name, extra in runs.items():
        reset_launches()
        lv = tri_bench.main(base + extra, device=dev)["levels"][0]
        used = {k: v for k, v in all_launches().items() if v}
        want = {counted[name]: 2 * (1 + T3_ITERS) + 1}
        check(used == want, f"T3 {name}: launches {used} != {want}")
        check(lv["T"] == 92160 and lv["cap"] == 92160 and lv["block"] == blocks.get(name, 128),
              f"T3 {name}: T {lv['T']}, cap {lv['cap']}, block {lv['block']}")
        for k, v in used.items():
            launches[k] += v
        c = lv["check"]
        print(f"phase 4 | path T3 {t_check_line(name, lv)} | {card}", flush=True)
        check(c["rays_past_cap"] == 0, f"T3 {name}: {c['rays_past_cap']} rays past cap = T")
        agree(f"T3 {name} at 92160 triangles, cap 92160, vs the brute force", c["got"], c["want"],
              lv["tris"], c["rays_c"])
        results[name] = lv
    ref = results["scalar"]
    for name in ("cluster 64", "cluster 256"):
        agree(f"T3 {name} vs the default block size", results[name]["check"]["got"],
              ref["check"]["got"], ref["tris"], ref["check"]["rays_c"])
    print(f"phase 4 | path T3: {time.perf_counter() - t0:.1f} s | {card}", flush=True)


def bench_scripts_path(dev, card, launches, errs, timing):
    """Path T: the two benchmark scripts through their ``main``, and the
    per-camera kernel at 92,160 triangles."""
    t_path = time.perf_counter()
    t1_fps(dev, card, launches)
    t2_tri_bench(dev, card, launches)
    t2_kernel_at_92160(dev, card, errs, timing)
    t3_exact(dev, card, launches)
    print(f"phase 4 | path T: {time.perf_counter() - t_path:.1f} s | {card}", flush=True)


# path U: the XLA render route (``render_backend: "xla"``), plain PyTorch
U_MODES = {"analytic": {}, "march float32": {"trace_mode": "march", "render_dtype": "float32"},
           "march bfloat16": {"trace_mode": "march"}}
U_CHECK_AGENTS = 2
U_BF16_P99 = 0.03  # m: the JAX docstring's p99 bound of its bfloat16 march
U_BF16_SPREAD = 0.01  # m: the card's p99 against the CPU's on the same rays
U_RAY_FLIPS = 2 / 1024  # share of pixels whose hit may differ (the render parity allowance)


def xla_sensors(extra):
    return [dict({"uuid": "depth", "sensor_type": "depth", "render_backend": "xla"}, **extra)]


def busy_ms(fn):
    """The card's busy milliseconds in one call of ``fn`` after a warm-up:
    the sum of ``torch.profiler``'s kernel rows, and how many kernels it
    traced. For a render of hundreds of launches, which :func:`device_ms`
    cannot queue behind one spin."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    check(busy > 0, "torch.profiler recorded no device time")
    return busy, sum(e.count for e in events)


def point_rays(env, state):
    """The point-major rays (1, N·H·W, 3) the XLA route traces."""
    from visfly_tpu_torch.render import camera_rays

    spec = env.sensor_kwargs[0]
    n, hw = env.num_agent, spec["resolution"][0] * spec["resolution"][1]
    o, d, _ = camera_rays(spec, state.dyn.pos, state.dyn.q)
    return o[:, None].expand(n, hw, 3).reshape(1, n * hw, 3), d.reshape(1, n * hw, 3)


def bf16_error(env, o, d):
    """|Δt| of the bfloat16 march (40 steps) against a float32 256-step
    trace of the same rays where the latter hits, and both traces."""
    import torch

    from visfly_tpu_torch.render import trace_grouped

    t, hit = trace_grouped(env.scene, o, d, n_steps=TRACE_STEPS)
    t_ref, hit_ref = trace_grouped(env.scene, o, d, n_steps=256, compute_dtype=torch.float32)
    return (t - t_ref).abs()[hit_ref], t, hit


def quantile(x, p):
    import torch

    return float(torch.quantile(x.float().cpu(), p))


def xla_route_path(dev, card, launches, env_k, state_k, sps_k, f_ms):
    """Path U: the depth leg's env with ``render_backend: "xla"`` in its three
    modes beside the kernel route (U1: the depth leg's own env ``env_k``, its
    state and env steps/s in this call), and path F's visual BPTT on it
    (U2). The route launches no kernel."""
    import torch

    from visfly_tpu_torch.algos import BPTT
    from visfly_tpu_torch.render import prepare_kernel_scene, trace_analytic, trace_grouped

    def u1_line(name, env, state, what, sps):
        render = lambda: env.sensor_observations(state)  # noqa: E731
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = cuda_ms(render, reps=5, warmup=1)
        busy, n_k = busy_ms(render)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        print(f"phase 4 | path U1 ({name}): {what} | {sps:.1f} env steps/s ({env.num_agent} "
              f"agents, 64x64 depth) | a render {ev:.3f} ms (CUDA events around the call), device "
              f"busy {busy:.3f} ms over {n_k} kernels (torch.profiler), its peak memory {peak:.2f} "
              f"GiB above the resident | {card}", flush=True)

    u1_line("kernel route, B1: the depth leg", env_k, state_k, "its launches counted there",
            sps_k)
    for mode, extra in U_MODES.items():
        env = bench_env(dev, xla_sensors(extra))
        state, out, sps, counts, _ = drive(env, 91, 1, CHUNK, lambda steps: {})
        check(not any(counts.values()), f"path U1 {mode}: launched {counts}")
        depth = out.obs["depth"]
        check(tuple(depth.shape) == (N_AGENTS, 1, *RES), f"path U1 {mode}: depth shape")
        check(bool(((depth >= 0) & (depth <= MAX_DEPTH)).all()), f"path U1 {mode}: depth range")
        check(float((depth < MAX_DEPTH).float().mean()) > 0.5, f"path U1 {mode}: no hits")
        u1_line(f"XLA route, {mode}, speed {sps / sps_k:.3f} of the kernel route's", env, state,
                f"no kernel launches in {CHUNK * 2} steps", sps)

        # card vs CPU on the same state, 2 agents
        env_c = bench_env(dev, xla_sensors(extra), n=U_CHECK_AGENTS)
        env_cpu = bench_env("cpu", xla_sensors(extra), n=U_CHECK_AGENTS)
        st_c, _ = env_c.reset(torch.Generator(device=dev).manual_seed(92))
        for i in range(4):
            a = torch.rand((U_CHECK_AGENTS, 4), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(93 + i)) * 0.6 - 0.3
            st_c, _ = env_c.step(st_c, a)
        st_cpu = to_device(st_c, "cpu", torch.Generator().manual_seed(0))
        d_card = env_c.sensor_observations(st_c)["depth"].cpu()
        d_cpu = env_cpu.sensor_observations(st_cpu)["depth"]
        diff = (d_card - d_cpu).abs()
        flips = float(((d_card < MAX_DEPTH) != (d_cpu < MAX_DEPTH)).float().mean())
        if mode != "march bfloat16":
            off = diff > T_TOL
            share = float(off.float().mean())
            print(f"phase 5 | path U1 ({mode}) card vs cpu, {U_CHECK_AGENTS} agents: depth "
                  f"max|d|={float(diff[~off].max()):.3e} m on all but {int(off.sum())} of "
                  f"{diff.numel()} pixels (share {share:.3e})", flush=True)
            check(share <= HIT_TOL, f"path U1 {mode}: depth card vs cpu off by > {T_TOL} m on "
                                    f"{share} of pixels")
            continue
        # the bfloat16 march: the same statistics on both devices
        err_card, _, _ = bf16_error(env_c, *point_rays(env_c, st_c))
        err_cpu, _, _ = bf16_error(env_cpu, *point_rays(env_cpu, st_cpu))
        spread = abs(quantile(err_card, 0.99) - quantile(err_cpu, 0.99))
        err_full, _, _ = bf16_error(env, *point_rays(env, state))
        print(f"phase 5 | path U1 (march bfloat16) card vs cpu, {U_CHECK_AGENTS} agents: depth "
              f"p50 / p99 |d| {quantile(diff, 0.5):.3e} / {quantile(diff, 0.99):.3e} m, hits differ on "
              f"{flips:.3e} of pixels; |t - t(float32, 256 steps)| p99 {quantile(err_card, 0.99):.4f} m "
              f"on the card, {quantile(err_cpu, 0.99):.4f} m on the cpu; at {N_AGENTS} agents on the "
              f"card p50 / p90 / p99 {quantile(err_full, 0.5):.4f} / {quantile(err_full, 0.9):.4f} / "
              f"{quantile(err_full, 0.99):.4f} m (the JAX docstring's bound {U_BF16_P99} m)", flush=True)
        check(quantile(diff, 0.99) <= U_BF16_P99, "path U1 bfloat16: card vs cpu p99 past 3 cm")
        check(flips <= U_RAY_FLIPS, f"path U1 bfloat16: hits card vs cpu differ on {flips}")
        check(spread <= U_BF16_SPREAD, f"path U1 bfloat16: p99 card {quantile(err_card, 0.99)} vs cpu "
                                       f"{quantile(err_cpu, 0.99)}")

    # the analytic XLA route against B1 on the same state, 1,048,576 rays
    o, d = point_rays(env_k, state_k)
    t_x, hit_x = trace_grouped(env_k.scene, o, d, n_steps=TRACE_STEPS, mode="analytic")
    o_c, d_c = camera_rays_of(env_k, state_k)
    t_b, hit_b = trace_analytic(prepare_kernel_scene(env_k.scene), o_c, d_c, MAX_DEPTH)[:2]
    # the XLA route adds one residual evaluation: a ray past 1e-3 m counts as
    # a mismatch, as a silhouette pixel does card vs CPU
    dt = (t_x - t_b).abs()
    off = (hit_x != hit_b) | ((hit_x & hit_b) & (dt > T_TOL))
    share = float(off.float().mean())
    print(f"phase 5 | path U1 analytic XLA route vs B1 on {o.shape[1]} rays: max|dt| "
          f"{float(dt[~off].max()):.3e} m where both hit on all but {int(off.sum())} rays "
          f"(share {share:.3e}; hits differ on {int((hit_x != hit_b).sum())}, largest |dt| "
          f"{float(dt[hit_x & hit_b].max()):.3e} m)", flush=True)
    check(share <= HIT_TOL, f"path U1: the analytic XLA route and B1 differ on {share} of rays")

    # U2: path F's visual BPTT on the XLA route (analytic)
    env_f = visual_grad_env(dev, {"path": "garage_simple_l_medium", "trace_steps": TRACE_STEPS},
                            {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]},
                            extra={"render_backend": "xla"})
    tr = BPTT(env_f, horizon=8, policy_kwargs=VISUAL_POLICY)
    reset_launches()
    st = tr.init(torch.Generator(device=dev).manual_seed(94))
    st, m = tr.update(st)
    before = snapshot(tr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, m = tr.update(st)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = all_launches()
    check(not any(counts.values()), f"path U2 launched {counts}")
    check_trained("path U2", tr, st, m, before, "actor_loss", dev)
    print(f"phase 4 | path U2 (visual BPTT, XLA route, analytic): no kernel launches in 2 "
          f"updates | {ms:.1f} ms an update beside path F's kernel route {f_ms:.1f} ({env_f.num_envs}"
          f" agents, H=8, 64x64 depth; loss {float(m['actor_loss']):.4f}, gradient norm "
          f"{float(m['grad_norm']):.4f}) | {card}", flush=True)


def _one_rank(dev):
    """The single process's place: no group, one rank."""
    from visfly_tpu_torch.parallel import Mesh

    return Mesh(0, 1, "none", dev)


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

    t_smoke = time.perf_counter()

    def clock(after):
        print(f"clock | {time.perf_counter() - t_smoke:.1f} s after {after}", flush=True)

    # 2. build every kernel from the checkout's sources
    from visfly_tpu_torch.build import build_all

    t0 = time.perf_counter()
    for name, (secs, log) in build_all().items():
        regs = [line.split("Used")[1].split(",")[0].strip() for line in log.splitlines()
                if "Used" in line]
        what = f"ptxas: {', '.join(regs)}" if regs else log.strip().splitlines()[-1]
        print(f"phase 2 | built {name} in {secs:.1f} s | {what}", flush=True)
    print(f"phase 2 | build total {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. every kernel mode vs its plain version on the card
    from visfly_tpu_torch.render import cone_warm_start, prepare_kernel_scene

    env_d = bench_env(dev)
    env_a = landing_env(dev)
    env_b = bench_env(dev, SUITE)
    env_c = hover_env(dev)
    state_b, _ = env_b.reset(torch.Generator(device=dev).manual_seed(0))
    state_a, _ = env_a.reset(torch.Generator(device=dev).manual_seed(0))
    ks_b, ks_a = prepare_kernel_scene(env_b.scene), prepare_kernel_scene(env_a.scene)
    o_b, d_b = camera_rays_of(env_b, state_b)
    o_a, d_a = camera_rays_of(env_a, state_a)
    g = torch.Generator(device=dev).manual_seed(1)
    r = 1 << 20
    o_rand = (torch.rand((3, 1, r), generator=g, device=dev)
              * torch.tensor([19.0, 11.0, 4.5], device=dev)[:, None, None]
              + torch.tensor([-1.5, -5.5, 0.25], device=dev)[:, None, None]).contiguous()
    d_rand = torch.randn((3, 1, r), generator=g, device=dev)
    d_rand = (d_rand / torch.linalg.vector_norm(d_rand, dim=0, keepdim=True)).contiguous()
    objects = (state_b.dyn.pos[None], torch.full((1, N_AGENTS), 0.15, device=dev))
    ks_dyn = prepare_kernel_scene(env_b.scene, objects)

    # the warm start path B gives the packed march: one cone per 8×8 pixels
    # of each camera, as render_camera computes it
    spec_tile = env_b.sensor_kwargs[3]
    q_b = state_b.dyn.q

    def cone_t_init(objs):
        def t_init(o):
            origins = o[:, 0, ::RES[0] * RES[1]].T.contiguous()  # (N, 3): one per camera
            return cone_warm_start(env_b.scene, spec_tile, spec_tile["tile"], origins, q_b, 1,
                                   objs, TRACE_STEPS, MAX_DEPTH)
        return t_init

    random_t_init = lambda o: (torch.rand((1, o.shape[2]), device=dev,  # noqa: E731
                                          generator=torch.Generator(device=dev).manual_seed(2))
                               * 2.0)
    cases = [
        ("path B camera rays of 256 reset agents", ks_b, o_b, d_b, cone_t_init(None), RES[1]),
        ("path A camera rays of 256 reset agents", ks_a, o_a, d_a, random_t_init, RES[1]),
        ("1M random rays", ks_b, o_rand, d_rand, random_t_init, None),
        ("path B camera rays with 256 dynamic capsules", ks_dyn, o_b, d_b,
         cone_t_init(objects), RES[1]),
    ]
    errs = {m: 0.0 for m in KERNELS}
    for case, ks, o, d, t_init, img_w in cases:
        for mode, (kernel, plain) in kernel_modes(t_init, img_w).items():
            errs[mode] = max(errs[mode], compare(mode, case, kernel, plain, ks, o, d))
        analytic_phase(case, ks, o, d, img_w, errs, card)
    # the culled march's rows on every tile of path B's cameras
    from visfly_tpu_torch.render.trace_kernel import cull_rows

    for case, ks, o, d, _, img_w in (cases[0], cases[3]):
        cull_counts(case, ks, o, d, img_w, card)

    # times at the shapes and arguments the main path gives each mode: B1 and
    # the marches on path B's rays, the id kernel on path A's
    from visfly_tpu_torch.render import trace_march

    timing = {}
    ti_b = cone_t_init(None)(o_b)  # the prepass is plain PyTorch, not the kernel: outside
    op_b, dp_b = packed(o_b), packed(d_b)  # and so is the layout change
    modes_b = kernel_modes(lambda o: ti_b, RES[1])
    plan_b = cull_rows(ks_b, o_b, d_b, MAX_DEPTH, RES[1])
    plan_a = cull_rows(ks_a, o_a, d_a, MAX_DEPTH, RES[1])
    for mode, (kernel, plain) in modes_b.items():
        ks, o, d, plan = ((ks_a, o_a, d_a, plan_a) if mode == "trace_analytic_kid"
                          else (ks_b, o_b, d_b, plan_b))
        if mode == "trace_march_packed":
            call = lambda: trace_march(ks, op_b, dp_b, ti_b, max(8, TRACE_STEPS // 2),  # noqa
                                       MAX_DEPTH, packed=True, img_w=RES[1])
        else:
            call = lambda: kernel(ks, o, d)  # noqa: E731
        ms = cuda_ms(call)
        dev_ms = device_ms(call)
        march = "march" in mode
        plain_ms = cuda_ms(lambda: plain(ks, o, d), reps=3 if march else 20,
                           warmup=1 if march else 3)
        stats = {}
        if march:
            plain(ks, o, d, stats=stats)
        analytic = mode.startswith("trace_analytic")
        b_ms, b_by = bound_ms(mode, ks, o.shape[2], stats,
                              plan if mode in ("trace_march", "trace_analytic",
                                               "trace_analytic_kid") else None, o)
        timing[mode] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by)
        evals = ""
        if analytic:
            old_ms, old_by = bound_ms(mode, ks, o.shape[2], o=o, old=True)
            evals = f" (old yardstick: {old_ms:.4f} ms by {old_by})"
        if march:
            plan = plan_b if mode == "trace_march" else None
            old_ms = march_ops(ks, stats, plan, per_eval_rows=True) / PEAK_FP32_PER_S * 1e3
            evals = (f", {stats['sdf_evals'] / o.shape[2]:.2f} SDF evaluations a ray (bound with "
                     f"the row constants at every evaluation: {old_ms:.4f} ms)")
        print(f"phase 3 | {mode} at {o.shape[2]} rays: kernel {ms:.4f} ms (CUDA events around "
              f"the call; on the device {dev_ms:.4f} ms, queued), plain {plain_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}{evals}, share {b_ms / ms:.4f} (device {b_ms / dev_ms:.4f})"
              f" | {card}", flush=True)
    # the id's cost beside B1 on the same rays (path B's semantic sensor)
    kid_call = lambda: modes_b["trace_analytic_kid"][0](ks_b, o_b, d_b)  # noqa: E731
    kid_b = cuda_ms(kid_call)
    kid_dev = device_ms(kid_call)
    kb_ms, kb_by = bound_ms("trace_analytic_kid", ks_b, o_b.shape[2], plan=plan_b, o=o_b)
    old_ms, old_by = bound_ms("trace_analytic_kid", ks_b, o_b.shape[2], o=o_b, old=True)
    print(f"phase 3 | trace_analytic_kid on path B's rays: kernel {kid_b:.4f} ms (on the device "
          f"{kid_dev:.4f} ms, queued) beside trace_analytic's {timing['trace_analytic']['ms']:.4f} ms "
          f"({timing['trace_analytic']['device_ms']:.4f}), bound {kb_ms:.4f} ms by {kb_by} "
          f"(old yardstick: {old_ms:.4f} ms by {old_by}), share {kb_ms / kid_b:.4f} (device "
          f"{kb_ms / kid_dev:.4f}) | {card}", flush=True)
    gradient_phase(ks_b, o_b, d_b, g)
    clock("phase 3's trace kernels")

    # the triangle kernel on path D's meshes: one OBJ per size, loaded as a
    # user would load it; the envs serve phases 4 and 5 as well
    mesh_dir = tempfile.TemporaryDirectory(prefix="visfly_garage_")
    envs_d = {}
    for level, (n_tris, sensors) in PATH_D.items():
        t0 = time.perf_counter()
        obj = write_obj(os.path.join(mesh_dir.name, f"garage_{level}.obj"), *garage_mesh(level))
        env_m = mesh_env(dev, {"path": obj, "backend": "grid"}, sensors)
        envs_d[level] = env_m
        check(env_m.scene.triangles.shape == (1, n_tris, 9),
              f"garage level {level}: {tuple(env_m.scene.triangles.shape)} triangles")
        print(f"phase 3 | garage level {level}: {n_tris} triangles, SDF grid "
              f"{tuple(env_m.scene.sdf.shape[1:])}, loaded and baked in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        state_m, _ = env_m.reset(torch.Generator(device=dev).manual_seed(0))
        triangle_phase(level, env_m, state_m, card, errs, timing)
        if level == 3:
            variant_phase(env_m, state_m, card, errs, timing)
    mesh_dir.cleanup()
    clock("phase 3")

    # 4. the paths
    launches = {m: 0 for m in all_launches()}

    def report(name, env, sps, counts, dt, steps, what):
        used = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            launches[k] += v
        print(f"phase 4 | {name}: {used or 'no kernel'} launches in {steps} steps | "
              f"{sps:.1f} env steps/s ({env.num_agent} agents, {what}, timed {dt:.3f} s) | {card}",
              flush=True)

    # depth leg: one render at the reset and one a step
    n_chunks = 2
    state_d, out, sps, counts, dt = drive(env_d, 0, n_chunks, CHUNK,
                                          lambda steps: {"trace_analytic": 1 + steps})
    sps_d = sps
    depth = out.obs["depth"]
    check(tuple(depth.shape) == (N_AGENTS, 1, *RES), f"depth shape {tuple(depth.shape)}")
    check(bool(((depth >= 0) & (depth <= MAX_DEPTH)).all()), "depth outside [0, 20]")
    report("depth leg", env_d, sps, counts, dt, CHUNK * (n_chunks + 1), "64x64 depth")

    # path A: one render at the reset, two a step (before the reward, after
    # the auto-reset)
    n_chunks = 2
    state_a, out, sps, counts, dt = drive(env_a, 10, n_chunks, CHUNK,
                                          lambda steps: {"trace_analytic_kid": 1 + 2 * steps})
    color = out.obs["color"]
    check(tuple(color.shape) == (N_AGENTS, 3, *RES) and color.dtype == torch.uint8,
          f"colour {tuple(color.shape)} {color.dtype}")
    check(bool(state_a.aux.seen.any()), "no agent of path A ever saw the pad")
    check(bool((out.obs["target"].abs() <= 0.5).all()), "pad centre outside the image")
    check(10 < float(color.float().mean()) < 250, "colour image is blank")
    report("path A (colour landing)", env_a, sps, counts, dt, CHUNK * (n_chunks + 1),
           f"64x64 colour twice a step, pad seen by {int(state_a.aux.seen.sum())}")

    # path B: every sensor renders once at the reset and once a step
    n_chunks = 2
    state_b, out, sps, counts, dt = drive(
        env_b, 20, n_chunks, CHUNK, lambda steps: {m: 1 + steps for m in SUITE_MODES.values()})
    report("path B (sensor suite)", env_b, sps, counts, dt, CHUNK * (n_chunks + 1),
           "4 sensors of 64x64")
    images = env_b.sensor_observations(state_b)  # outside the counted run
    sem = images["semantic"]
    check(tuple(sem.shape) == (N_AGENTS, 1, *RES) and sem.dtype == torch.uint8,
          f"semantic {tuple(sem.shape)} {sem.dtype}")
    check(int(sem.max()) <= int(env_b.scene.semantic.max()), "semantic id outside the table")
    check(len(torch.unique(sem)) > 1, "semantic image is blank")
    for k in ("depth_march", "depth_nocull", "depth_tile"):
        dm = images[k]
        check(tuple(dm.shape) == (N_AGENTS, 1, *RES) and dm.dtype == torch.float32, f"{k} shape")
        check(bool(((dm >= 0) & (dm <= MAX_DEPTH)).all()), f"{k} outside [0, 20]")
    # the marches agree with each other where they converge: the median pixel
    med = [float((images[k] - images["depth_march"]).abs().median())
           for k in ("depth_nocull", "depth_tile")]
    check(max(med) < 1e-2, f"march sensors disagree: median |d| {med}")

    # path C: state only
    n_chunks = 1
    _, out, sps, counts, dt = drive(env_c, 30, n_chunks, 125, lambda steps: {})
    report("path C (physics leg)", env_c, sps, counts, dt, 125 * (n_chunks + 1),
           "no scene, 8 substeps")

    # path D: every sensor renders once at the reset and once a step, through
    # the kernel use its mesh size and resolution select
    states_d = {}
    for level, (n_tris, sensors) in PATH_D.items():
        n_chunks = 2
        env_m = envs_d[level]
        states_d[level], out, sps, counts, dt = drive(
            env_m, 50 + level, n_chunks, CHUNK,
            lambda steps: {mode: 1 + steps for mode in sensors.values()})
        depth = out.obs["depth"]
        check(tuple(depth.shape) == (N_AGENTS, 1, *RES), f"path D depth {tuple(depth.shape)}")
        check(bool(((depth >= 0) & (depth <= MAX_DEPTH)).all()), "path D depth outside [0, 20]")
        # a closed garage has no background, but a tile at its cap gives up
        # its farthest triangles (2% of the pixels at 5,760 triangles)
        check(float((depth < MAX_DEPTH).float().mean()) > 0.9, "path D: too much background")
        report(f"path D (mesh, {n_tris} triangles)", env_m, sps, counts, dt,
               CHUNK * (n_chunks + 1), " + ".join(f"{h}x{w} depth" for h, w in
                                                  (MESH_SENSORS[u] for u in sensors)))

    # path D with the variants of the per-camera tier: the 23,040-triangle
    # scene again, three 64×64 sensors that differ in ``tri_variant`` only
    env_v = mesh_env(dev, {"data": envs_d[3].scene}, VARIANT_SENSORS, variants=True)
    n_chunks = 1
    _, out, sps, counts, dt = drive(
        env_v, 60, n_chunks, CHUNK,
        lambda steps: {mode: 1 + steps for _, mode in VARIANT_SENSORS.values()})
    depth = out.obs["depth"]
    check(tuple(depth.shape) == (N_AGENTS, 1, *RES), f"variants depth {tuple(depth.shape)}")
    check(float((depth < MAX_DEPTH).float().mean()) > 0.9, "variants: too much background")
    report("path D (mesh, 23040 triangles, variants merged + mx + wl)", env_v, sps, counts, dt,
           CHUNK * (n_chunks + 1), "3 sensors of 64x64 depth")

    # the diagnostics, through the library functions chip_profile.py's `probe`
    # and `floor` commands print from
    from visfly_tpu_torch.render import default_tri_cap, knockout_trace, stage_stats

    env_m, state_m = envs_d[3], states_d[3]
    tris = env_m.scene.triangles
    cap = default_tri_cap(tris.shape[1])
    o48, d48, w48, _ = mesh_camera_rays(env_m, state_m, 1)
    o64, d64, w64, cam64 = mesh_camera_rays(env_m, state_m, 0)
    reset_launches()
    st = stage_stats(tris, o48, d48, MAX_DEPTH, cap, w48)
    for body in (True, False):
        for pin in (False, True):
            t = knockout_trace(tris, o64, d64, MAX_DEPTH, cap, w64, cam64, body=body,
                               pin_stage=pin)
            check(bool(torch.isfinite(t).all()), "knock-out output not finite")
    torch.cuda.synchronize()
    counts = all_launches()
    want = {k: 0 for k in counts}
    want.update({"tri_trace_probe": 1, "tri_trace_knockout": 3, "tri_trace_camsoup_merged": 1})
    check(counts == want, f"diagnostics launched {counts}, expected {want}")
    # the list walk's count sums a tile's blocks
    check(0 < st["mean"] <= st["n_stage"] * (1024 // st["block_rays"]),
          f"stages executed {st['mean']}")
    for k, v in counts.items():
        launches[k] += v
    print(f"phase 4 | diagnostics: { {k: v for k, v in counts.items() if v} } launches; stages "
          f"executed a tile mean {st['mean']:.2f} of {st['n_stage']}, summed over blocks of "
          f"{st['block_rays']} rays | {card}", flush=True)

    clock("the depth leg, paths A-D and the diagnostics")
    # path Q1 trains in a process of its own while paths E-P run
    q1 = start_q1()
    # path E: the gradient leg; no kernel
    from visfly_tpu_torch.algos import BPTT

    def report_bptt(name, trainer, ms, sps, counts, m, n_updates, what):
        used = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            launches[k] += v
        print(f"phase 4 | {name}: {used or 'no kernel'} launches in {n_updates + 1} updates | "
              f"{ms:.1f} ms an update, {sps:.1f} agent steps/s ({trainer.env.num_envs} agents, "
              f"H={trainer.H}, {what}; loss {float(m['actor_loss']):.4f}, gradient norm "
              f"{float(m['grad_norm']):.4f}) | {card}", flush=True)

    tr_e = BPTT(hover_grad_env(dev), horizon=32)
    ms, sps, counts, m = drive_bptt(tr_e, 70, 2, lambda steps: {})
    report_bptt("path E (BPTT, hover)", tr_e, ms, sps, counts, m, 2, "state only")

    # path F: visual BPTT, one render at the reset and one a step, through the
    # analytic kernel in the primitive scene and the merged per-camera kernel
    # in the 23,040-triangle mesh; the backward pass launches no kernel
    f_ms = {}
    for name, env_f, mode in (
            ("primitive scene", visual_grad_env(
                dev, {"path": "garage_simple_l_medium", "trace_steps": TRACE_STEPS},
                {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}), "trace_analytic"),
            ("mesh, 23040 triangles, merged", visual_grad_env(
                dev, {"data": envs_d[3].scene}, {"mean": [8.0, 0.0, 1.75], "half": [7.0, 3.0, 0.5]},
                "merged"), "tri_trace_camsoup_merged")):
        tr_f = BPTT(env_f, horizon=8, policy_kwargs=VISUAL_POLICY)
        ms, sps, counts, m = drive_bptt(tr_f, 80, 2, lambda steps: {mode: 1 + steps})
        conv = tr_f.actor.extractor.extractors["depth_extractor"].conv[0].weight
        check(conv.grad is not None and float(conv.grad.abs().max()) > 0,
              f"path F ({name}): no gradient reached the CNN")
        report_bptt(f"path F (visual BPTT, {name})", tr_f, ms, sps, counts, m, 2,
                    "64x64 depth")
        f_ms[name] = ms

    clock("paths E and F")
    xla_route_path(dev, card, launches, env_d, state_d, sps_d, f_ms["primitive scene"])
    clock("path U")
    tr_g, st_g = training_paths(dev, card, launches)
    clock("paths G-J")
    experiment_layer_path(dev, card, launches, errs, timing, tr_g, st_g)
    clock("path N")
    del tr_g, st_g
    swarm_and_zoo_paths(dev, card, launches)
    clock("paths K-M")
    scene_ingest_path(dev, card, launches)
    clock("path O")
    policies_path(dev, card, launches)
    clock("path P")
    published_results_path(dev, card, launches, q1)
    clock("path Q")
    scale_out_path(dev, card, launches)
    clock("path R")
    user_scripts_path(dev, card, launches)
    clock("path S")
    bench_scripts_path(dev, card, launches, errs, timing)
    clock("path T")

    # 5. one step from the same state, card vs CPU plain path
    out_gpu, out_cpu, s_err = card_vs_cpu(env_d, bench_env("cpu"), state_d, 40)
    # the two devices' float32 dynamics differ in the last ulps, so a pixel on
    # a silhouette may see another object: such pixels count as mismatches
    diff = (out_gpu.obs["depth"].cpu() - out_cpu.obs["depth"]).abs()
    off = diff > T_TOL
    d_flip = float(off.float().mean())
    print(f"phase 5 | depth leg card vs cpu: depth max|d|={float(diff[~off].max()):.3e} m on "
          f"all but {int(off.sum())} of {diff.numel()} pixels (silhouette share {d_flip:.3e}, "
          f"largest {float(diff.max()):.3f} m) | state max|d|={s_err:.3e}", flush=True)
    check(d_flip <= HIT_TOL, f"depth card vs cpu off by > {T_TOL} m on {d_flip} of pixels")

    env_m = envs_d[0]
    env_m_cpu = mesh_env("cpu", {"data": env_m.scene}, PATH_D[0][1])
    out_gpu, out_cpu, s_err = card_vs_cpu(env_m, env_m_cpu, states_d[0], 42)
    diff = (out_gpu.obs["depth"].cpu() - out_cpu.obs["depth"]).abs()
    off = diff > T_TOL
    d_flip = float(off.float().mean())
    print(f"phase 5 | path D (360 triangles) card vs cpu: depth max|d|="
          f"{float(diff[~off].max()):.3e} m on all but {int(off.sum())} of {diff.numel()} "
          f"pixels (silhouette share {d_flip:.3e}) | state max|d|={s_err:.3e}", flush=True)
    check(d_flip <= HIT_TOL, f"path D depth card vs cpu off by > {T_TOL} m on {d_flip} of pixels")

    out_gpu, out_cpu, s_err = card_vs_cpu(env_a, landing_env("cpu"), state_a, 41)
    px_off = (out_gpu.obs["color"].cpu() != out_cpu.obs["color"]).any(dim=1)
    c_flip = float(px_off.float().mean())
    t_err = float((out_gpu.obs["target"].cpu() - out_cpu.obs["target"]).abs().max())
    print(f"phase 5 | path A card vs cpu: colour differs on {int(px_off.sum())} of "
          f"{px_off.numel()} pixels ({c_flip:.3e}) | pad centre max|d|={t_err:.3e} | "
          f"state max|d|={s_err:.3e}", flush=True)
    check(c_flip <= COLOR_TOL, f"colour card vs cpu differs on {c_flip} of pixels")
    check(t_err <= 1e-3, f"pad centre card vs cpu {t_err} > 1e-3")

    d_loss, g_rel = bptt_card_vs_cpu(dev)
    print(f"phase 5 | path E card vs cpu (8 agents, H=4, same parameters, state and noise): "
          f"|d loss|={d_loss:.3e}, gradient max relative difference {g_rel:.3e}", flush=True)
    check(d_loss <= 1e-5, f"BPTT loss card vs cpu {d_loss} > 1e-5")
    check(g_rel <= GRAD_TOL, f"BPTT gradient card vs cpu {g_rel} > {GRAD_TOL}")

    d_loss, g_rel, p_l2, p_elem, worst, n_past = ppo_card_vs_cpu(dev)
    print(f"phase 5 | path G card vs cpu (PPO, 8 agents, 4 steps, 2 epochs of 2 minibatches, "
          f"same parameters, state, noise and permutations): |d loss|={d_loss:.3e}, first "
          f"gradient max relative difference {g_rel:.3e}, parameters after the update: l2 "
          f"relative difference {p_l2:.3e}, elementwise {p_elem:.3e} of the largest entry "
          f"at {worst} ({n_past} elements past 1e-4 of it)", flush=True)
    check(d_loss <= 1e-5, f"PPO loss card vs cpu {d_loss} > 1e-5")
    check(g_rel <= GRAD_TOL, f"PPO gradient card vs cpu {g_rel} > {GRAD_TOL}")
    check(p_l2 <= GRAD_TOL, f"PPO parameters card vs cpu {p_l2} > {GRAD_TOL} (l2)")

    noise_phase(dev, card)
    clock("phase 5")

    for mode in KERNELS:
        check(launches[mode] > 0, f"no main path launched {mode}")
    check(launches["tri_trace_tile_cluster"] == 0,
          "a path walked the tile tiers' lists with the cluster walk")
    check(launches["tri_trace_list_cluster"] == 0,
          "a path walked the merged or worklist tier's lists with the cluster walk")
    check(launches["tri_trace_probe_cluster"] == launches["tri_trace_knockout_cluster"] == 0,
          "a path ran a diagnostic on the cluster walk")
    print(json.dumps({
        "kernels": [{
            "name": mode, "route": "cuda", "source": KERNELS[mode][0],
            "replaces": KERNELS[mode][1], "launches": launches[mode],
            "max_abs_err": errs[mode], **timing[mode], "library_ms": None,
        } for mode in KERNELS],
        "note": "ms is CUDA events around each kernel's call (median of 20), as in every "
                "earlier run; device_ms (trace modes only) is the kernel's own time on the "
                "card from torch.profiler; trace_analytic (B1, "
                "path B's camera rays) and trace_analytic_kid (B1-kid, path A's) cull each "
                "tile, and their bounds count the rows that meet a tile and a one-origin "
                "tile's origin terms once (its launches include path G's and path K's training "
                "runs, 2 a step, path N's resume, runner and evaluation, and path L's depth); "
                "trace_analytic_kid's include path N's global views and path L's "
                "colour; "
                "trace_march (the per-tile cull, B2), trace_march_nocull (B3a) and "
                "trace_march_packed (B3b) are instantiations of one march kernel, timed on path "
                "B's camera rays; B2's bound counts the rows its tiles evaluate; tri_trace_tile_sv "
                "and tri_trace_tile_mt are the two bodies of B4, tri_trace_camsoup_merged "
                "(B7a) and tri_trace_worklist (B7c) the merged output and the CSR lists, and "
                "tri_trace_probe (B8a, the stage count over the soup's 48x48 lists) and "
                "tri_trace_knockout (B8b, body off and the stage walked) flags of the "
                "same list walk, tri_tile.cu (device_ms by queued events, and for B8a and B8b "
                "the cluster walk's at k = 1 beside it; bound on the tests of "
                "each tile's real slots that the list walk's votes ran); the other "
                "tri_trace_* modes are flags and list modes of one source, tri_trace.cu (soup "
                "B5, camsoup B6, camsoup_mx B7b "
                "with a kernel of its own on the tensor cores (its device_ms from "
                "torch.profiler; its bound counts its TF32 products at the tensor rate)), "
                "timed without their prepass at 360 (tile) and 23,040 "
                "(all others) triangles, at the split the wrapper picks (mx "
                "at 1 block a tile); launches add up the depth leg, paths A-S and the "
                "diagnostics (path O: B1, B1-kid on the decomposed habitat scenes, camsoup on "
                "the exact textured ones, its times in its phase 3 lines; path P: B1 on P1-P5, "
                "P5's counted in each rank's process and returned; path Q: B1 in Q2's "
                "distillation, 1 + 6 x 96 for the reset and the DAgger collection and 1 + n "
                "for each of its two evaluations of n steps; path R: B1 on R1 and R4, counted "
                "in each process; path S: B1 and B1-kid in debug_obs, B1 and the triangle "
                "kernel in the habitat demo, B1 in the gradient probe; path T: B1 in "
                "fps_test's four visual envs, tile_sv and camsoup in tri_bench's levels 2-4, "
                "camsoup, camsoup_merged, camsoup_mx and worklist in its exact checks at 92,160 "
                "triangles; camsoup's *_92160 keys are its time and bound on tri_bench's "
                "level-4 plan, 1,048,576 rays); library_ms is null "
                "because no single PyTorch call computes a first hit"}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
