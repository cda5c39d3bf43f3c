"""Data parallelism over the agent axis with ``torch.distributed``
(counterpart of ``visfly_tpu/parallel/mesh.py``).

The JAX package shards one logical program over a device mesh. Here each
rank is a process with an env of its own that holds a contiguous block of
the agents of one larger env (``env.global_rows``):

* **who owns what**: with ``num_scene`` ≥ the world size a rank owns whole
  scenes (a preset's scenes are seeded as the larger env seeds them);
  otherwise the one scene's agents are split, which is refused for envs
  whose agents of a scene are coupled (the swarm envs aggregate done and
  success per scene, ``envs/multi.py``);
* **draws**: every draw of the env (spawns, reset clocks, ``drag_random``,
  IMU and sensor noise, a world model's prior and posterior noise,
  ``CatchEnv``'s balls) and of the trainers (action noise, minibatch
  permutations, SAC's sample indices and per-sample noise) is made as the
  one larger env and trainer would make it, from generators seeded alike on
  every rank, and sliced to the rank's rows; so the ranks together compute
  what one process computes, up to float reassociation;
* **scenes**: a rank that owns whole scenes gets a preset's seeds or a
  dataset's files as the larger env would put them at those indices, at
  every rotation too;
* **parameters** are broadcast from rank 0 (``shard_train_state``);
* **gradients** are all-reduced before the global-norm clip: as a mean where
  the loss is a mean over equal shards (BPTT, APG, SHAC's actor and each of
  its critic steps over the flattened H × N batch), as a sum of each rank's
  share of a minibatch's mean where a minibatch drawn over the whole batch
  falls unevenly on the ranks (PPO, flat or recurrent; SAC's critic, actor
  and temperature, each rank holding its agents' part of one global replay
  ring, ``algos/buffers.py``); PPO normalises advantages with the
  minibatch's global mean and standard deviation and stops on the global
  KL; every metric is the global one.

Every trainer of ``algos/`` is data-parallel (``shard_train_state`` raises
for a trainer it does not know). The backend is an argument: ``"nccl"``
where each rank has a card of its own (rank r on ``cuda:r``), ``"gloo"`` on
the CPU or for several ranks on one card (NCCL refuses two ranks on one
device). :func:`run_ranks` starts the ranks as processes that meet through a
``file://`` store in a temporary directory; a missing backend raises, there
is no fallback to one process.
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor


class Mesh(NamedTuple):
    """This process's place in the group: ``rank`` of ``size``, the
    backend, and the device its tensors live on."""

    rank: int
    size: int
    backend: str
    device: torch.device


def make_mesh(world_size: int, rank: int, init_method: str, backend: str = "nccl",
              device: Any = None) -> Mesh:
    """Join the process group of ``world_size`` ranks at ``init_method``
    (``file://<path>`` or ``tcp://localhost:<port>``) as ``rank``. The device
    defaults to ``cuda:<rank>`` for NCCL and the CPU for gloo."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this build of torch")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("the NCCL backend is not available in this build of torch")
    if device is None:
        device = f"cuda:{rank}" if backend == "nccl" else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    return Mesh(rank, world_size, backend, device)


def rows_of(mesh: Mesh, n: int) -> Tuple[int, int]:
    """This rank's block (start, stop) of ``n`` agents split evenly."""
    if n % mesh.size:
        raise ValueError(f"{n} agents do not split evenly over {mesh.size} ranks")
    per = n // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def make_rank_env(env_cls, mesh: Mesh, num_agent_per_scene: int = 1, num_scene: int = 1,
                  **kwargs):
    """This rank's env of ``env_cls(num_agent_per_scene, num_scene,
    **kwargs)``: whole scenes where there are at least as many scenes as
    ranks (a preset's seeded as the larger env seeds them, a dataset's the
    files its loader would put at those indices, at every rotation too),
    else a slice of the one scene's agents (refused for the swarm envs, whose
    agents of a scene are coupled)."""
    from ..envs.multi import MultiDroneGymEnv
    from ..scene.habitat_dataset import is_habitat_scene_path

    A, S, W = int(num_agent_per_scene), int(num_scene), mesh.size
    if S >= W:
        lo_scene, hi_scene = rows_of(mesh, S)
        scene_kw = dict(kwargs.get("scene_kwargs") or {})
        if W > 1 and "data" not in scene_kw:
            path = str(scene_kw.get("path", ""))
            dataset = bool(path) and (os.path.isdir(path) or is_habitat_scene_path(path))
            if lo_scene and not dataset:  # a preset's scene i has the seed seed + i
                scene_kw["seed"] = scene_kw.get("seed", kwargs.get("seed", 42)) + lo_scene
            # a dataset's loader deals each batch of S files out by scene index,
            # and a rotation moves on by S scenes
            scene_kw["scenes_of"] = (lo_scene, S)
            kwargs["scene_kwargs"] = scene_kw
        env = env_cls(num_agent_per_scene=A, num_scene=hi_scene - lo_scene, **kwargs)
        lo = lo_scene * A
    else:
        if S != 1:
            raise ValueError(f"{S} scenes over {W} ranks: a rank owns whole scenes, or a "
                             "slice of the agents of one scene")
        if issubclass(env_cls, MultiDroneGymEnv):
            raise ValueError(f"{env_cls.__name__} couples the agents of a scene: split it by "
                             "scenes, at least one a rank")
        lo, hi = rows_of(mesh, A)
        env = env_cls(num_agent_per_scene=hi - lo, num_scene=1, **kwargs)
    env.global_rows = (lo, lo + env.num_agent, A * S)
    return env


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce_(x: Tensor, mesh: Optional[Mesh], op: str = "sum") -> Tensor:
    """``x`` summed (or averaged, ``op="mean"``) over the ranks, in place."""
    if mesh is None:
        return x
    dist.all_reduce(x, op=dist.ReduceOp.SUM)
    if op == "mean":
        x.div_(mesh.size)
    return x


def all_reduce_grads_(params, mesh: Optional[Mesh], op: str = "sum") -> None:
    """Every parameter's gradient reduced over the ranks, flattened into one
    collective. A parameter that has no gradient on this rank (its share of
    a batch was empty) adds zeros, and has the reduced gradient afterwards
    wherever some rank had one."""
    params = list(params)
    if mesh is None or not params:
        return
    had = [p.grad is not None for p in params]
    parts = [(p.grad if h else torch.zeros_like(p)).reshape(-1) for p, h in zip(params, had)]
    flat = torch.cat(parts + [parts[0].new_tensor(had)])
    flat = all_reduce_(flat, mesh, op)
    n = len(params)
    for p, part, some in zip(params, flat[:-n].split([p.numel() for p in params]),
                             flat[-n:].tolist()):
        if some:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            p.grad.copy_(part.view_as(p))


def gather_rows(x: Tensor, rows: Tuple[int, int, int], mesh: Optional[Mesh]) -> Tensor:
    """The larger env's (n, ...) tensor from every rank's block ``rows``
    (start, stop, n): each rank writes its block into zeros and the blocks
    are summed (gloo reduces CUDA tensors but does not gather them). Bool and
    integer tensors come back in their dtype."""
    if mesh is None:
        return x
    lo, hi, n = rows
    full = torch.zeros((n, *x.shape[1:]), dtype=torch.float64, device=x.device)
    full[lo:hi] = x.to(torch.float64)
    return all_reduce_(full, mesh).to(x.dtype)


# ---------------------------------------------------------------------------
# the JAX package's sharding helpers
# ---------------------------------------------------------------------------


def shard_batch_pytree(tree: Any, mesh: Mesh, batch_size: int) -> Any:
    """This rank's block of every tensor of ``tree`` (NamedTuples, tuples,
    dicts) along its first axis of length ``batch_size``; tensors without
    such an axis, generators and other leaves pass through."""
    lo, hi = rows_of(mesh, batch_size)

    def place(x):
        if isinstance(x, Tensor):
            for axis, dim in enumerate(x.shape):
                if dim == batch_size:
                    return x.narrow(axis, lo, hi - lo).clone()
            return x
        if isinstance(x, tuple):
            parts = [place(v) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        return x

    return place(tree)


def replicate_pytree(tree: Any, mesh: Mesh) -> Any:
    """Every tensor of ``tree`` overwritten, in place, with rank 0's."""
    def walk(x):
        if isinstance(x, Tensor):
            with torch.no_grad():
                dist.broadcast(x.data, src=0)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return tree


def shard_train_state(st: Any, mesh: Mesh, trainer) -> Any:
    """Make ``trainer`` (a BPTT, PPO, SHAC, APG or SAC over a
    ``make_rank_env`` env, whose state ``st`` is already this rank's block of
    the larger env's) data parallel over ``mesh``: every parameter set of the
    state (the actor or policy, a critic and its target, SAC's ``log_alpha``)
    broadcast from rank 0, the gradients and metrics reduced over the ranks
    from now on. Returns the state."""
    from ..algos import APG, BPTT, PPO, SAC, SHAC

    if not isinstance(trainer, (BPTT, PPO, SHAC, APG, SAC)):
        raise TypeError(f"{type(trainer).__name__} is not a trainer shard_train_state knows: "
                        "BPTT, PPO, SHAC, APG and SAC are")
    if trainer.env.global_rows[2] != mesh.size * trainer.env.num_agent:
        raise ValueError("the trainer's env holds no block of a larger env: build it with "
                         "make_rank_env")
    params = [list(getattr(st, f).values()) for f in st._fields if f.endswith("params")]
    if isinstance(trainer, SAC):
        params.append(st.log_alpha)
    replicate_pytree(params, mesh)
    trainer.set_mesh(mesh)
    return st


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


def _rank_main(rank: int, fn: Callable, world_size: int, backend: str, device, tmp: str,
               args: tuple) -> None:
    torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    mesh = make_mesh(world_size, rank, f"file://{os.path.join(tmp, 'store')}", backend, device)
    try:
        out = fn(mesh, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, *args, backend: str = "gloo", device=None,
              timeout: float = 600.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world_size`` fresh processes (spawned),
    one a rank, meeting through a ``file://`` store in a temporary directory;
    ``fn`` must be importable by name. Returns each rank's result, in rank
    order. A rank that raises fails the call with its traceback; past
    ``timeout`` seconds every rank is killed and TimeoutError raised."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="visfly_ranks_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, world_size, backend, device, tmp, args),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]


def dryrun_multichip(n_devices: int, backend: str = "gloo", device=None,
                     timeout: float = 600.0) -> List[dict]:
    """The counterpart of ``__graft_entry__.dryrun_multichip``: one BPTT
    update of ``HoverEnv`` (4 agents a rank, H = 4), one of a visual
    ``NavigationEnv`` (2 agents a rank, 16×16 depth, H = 3) and one SHAC
    update of the ``HoverEnv`` (H = 4, 2 critic steps) over ``n_devices``
    ranks; each loss finite, each gradient non-zero, and the parameters
    after the update equal on every rank. Returns each rank's metrics."""
    outs = run_ranks(_dryrun_rank, n_devices, backend=backend, device=device, timeout=timeout)
    for name in ("hover", "visual", "shac"):
        for o in outs:
            m = o[name]
            if not (torch.isfinite(torch.tensor(m["loss"])) and m["grad_norm"] > 0):
                raise AssertionError(f"dryrun {name}: loss {m['loss']}, grad {m['grad_norm']}")
        if any(not torch.equal(o[name]["params"], outs[0][name]["params"]) for o in outs):
            raise AssertionError(f"dryrun {name}: the ranks' parameters differ")
    return outs


def _dryrun_rank(mesh: Mesh) -> dict:
    from ..algos import BPTT, SHAC
    from ..envs import HoverEnv, NavigationEnv

    out = {}
    dyn = {"dt": 0.02, "ctrl_dt": 0.02, "action_type": "bodyrate"}
    env = make_rank_env(HoverEnv, mesh, 4 * mesh.size, visual=False, requires_grad=True,
                        dynamics_kwargs=dyn, max_episode_steps=16, device=mesh.device)
    venv = make_rank_env(
        NavigationEnv, mesh, 2 * mesh.size, visual=True, requires_grad=True,
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 1.0, 0.5]}}]}},
        scene_kwargs={"path": "garage_simple_l_medium", "scene_gen_kwargs": {"n_obstacles": 4}},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 16]}],
        dynamics_kwargs=dict(dyn, dt=0.03, ctrl_dt=0.03), max_episode_steps=16,
        device=mesh.device)
    for name, e, h, latent in (("hover", env, 4, (32, 32)), ("visual", venv, 3, (16, 16)),
                               ("shac", env, 4, (32, 32))):
        kw = dict(horizon=h, policy_kwargs={"latent_dim": latent})
        tr = SHAC(e, gradient_steps=2, **kw) if name == "shac" else BPTT(e, **kw)
        st = shard_train_state(tr.init(), mesh, tr)
        st, m = tr.update(st)
        nets = [tr.actor] + ([tr.critic, tr.critic_target] if name == "shac" else [])
        out[name] = {"loss": float(m["actor_loss"]), "grad_norm": float(m["grad_norm"]),
                     "params": torch.cat([p.detach().flatten().cpu()
                                          for net in nets for p in net.parameters()])}
    return out
