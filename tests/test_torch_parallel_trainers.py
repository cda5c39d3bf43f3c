"""Data parallelism for every trainer of ``visfly_tpu_torch/algos/`` and every
scene source (``visfly_tpu_torch/parallel``) on the CPU: two gloo ranks,
each a process with the agents of its block, against one process with all
of them, as ``tests/test_torch_parallel.py`` holds BPTT and the flat PPO.

Every rank draws what the one process draws (spawns, clocks, drag, sensor
and IMU noise, world-model noise, action noise, permutations, SAC's sample
indices and per-sample noise) and slices it, so the sharded runs compute the
same numbers up to float reassociation: losses within 1e-5 relative,
parameters within 1e-4 in the l2 norm, positions within 1e-5, and every
metric equal on the ranks. All legs run in one group of processes (one
spawn), after the one-process references.
"""
import json
import os

import numpy as np
import pytest
import torch

from visfly_tpu_torch.algos import APG, BPTT, PPO, SAC, SHAC
from visfly_tpu_torch.algos import buffers
from visfly_tpu_torch.envs import HoverEnv, NavigationEnv
from visfly_tpu_torch.parallel import make_rank_env, run_ranks, shard_train_state
from visfly_tpu_torch.policies.world_model import create_world_model

torch.set_num_threads(1)

RANKS = 2
N = 16  # agents of the whole batch
LIMIT = 420.0  # seconds the group of processes may take
DYN = {"dt": 0.02, "ctrl_dt": 0.02, "action_type": "bodyrate"}
SPAWN = {"state_generator": {"class": "Uniform", "kwargs": [
    {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 1.0, 0.5]}}]}}
DEPTH16 = [{"uuid": "depth", "sensor_type": "depth", "resolution": [16, 16]}]
SMALL = {"latent_dim": (16, 16)}


def hover(**kw):
    return {"visual": False, "dynamics_kwargs": DYN, "max_episode_steps": 16, "device": "cpu",
            **kw}


def visual_nav(**kw):
    return dict(visual=True, device="cpu",
                scene_kwargs={"path": "garage_simple_l_medium",
                              "scene_gen_kwargs": {"n_obstacles": 4}},
                sensor_kwargs=DEPTH16, random_kwargs=SPAWN,
                dynamics_kwargs=dict(DYN, dt=0.03, ctrl_dt=0.03), max_episode_steps=16, **kw)


def make_env(cls, mesh, agents, num_scene=1, **kw):
    """The whole env on one process (``mesh`` None), else the rank's block."""
    if mesh is None:
        return cls(num_agent_per_scene=agents, num_scene=num_scene, **kw)
    return make_rank_env(cls, mesh, agents, num_scene, **kw)


def flat(*parts):
    return torch.cat([p.detach().flatten() for part in parts
                      for p in (part.parameters() if hasattr(part, "parameters") else [part])])


def result(st, loss, params, metrics, **extra):
    out = {"loss": float(loss), "params": params, "pos": st.env_state.dyn.pos.detach().clone(),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    out.update(extra)
    return out


def start(tr, mesh):
    st = tr.init()
    return st if mesh is None else shard_train_state(st, mesh, tr)


# ---------------------------------------------------------------------------
# the legs: each runs on one process (mesh None) or on a rank
# ---------------------------------------------------------------------------


def leg_shac_hover(mesh, _data):
    env = make_env(HoverEnv, mesh, N, requires_grad=True, **hover())
    tr = SHAC(env, horizon=4, gradient_steps=2, seed=5, policy_kwargs=SMALL)
    st = start(tr, mesh)
    for _ in range(2):
        st, m = tr.update(st)
    return result(st, m["actor_loss"], flat(tr.actor, tr.critic, tr.critic_target), m,
                  global_step=st.global_step)


def leg_shac_visual(mesh, _data):
    env = make_env(NavigationEnv, mesh, N // 2, 2, requires_grad=True, **visual_nav())
    tr = SHAC(env, horizon=3, gradient_steps=2, seed=6, policy_kwargs=SMALL)
    st = start(tr, mesh)
    st, m = tr.update(st)
    return result(st, m["actor_loss"], flat(tr.actor, tr.critic, tr.critic_target), m)


def leg_apg(mesh, _data):
    env = make_env(HoverEnv, mesh, N, requires_grad=True, **hover())
    tr = APG(env, horizon=4, seed=7, policy_kwargs=SMALL)
    st = start(tr, mesh)
    for _ in range(2):
        st, m = tr.update(st)
    return result(st, m["loss"], flat(tr.actor), m, global_step=st.global_step)


SAC_RING = 40  # not a multiple of N: a ring row's agent changes from lap to lap


def leg_sac(mesh, _data):
    """Two steps of collection, then three with two gradient steps each: 80
    writes into the 40-row ring, so it wraps twice, mid-batch."""
    env = make_env(HoverEnv, mesh, N, **hover())
    tr = SAC(env, buffer_size=SAC_RING, batch_size=24, gradient_steps=2, learning_starts=0,
             seed=8, policy_kwargs=SMALL)
    st = start(tr, mesh)
    for i in range(5):
        st, m = tr.step_and_train(st, train=i >= 2)
    return result(st, m["critic_loss"], flat(tr.actor, tr.critic, tr.critic_target,
                                              tr.log_alpha), m,
                  ring_rows=st.buffer.rewards.shape[0], ring_bytes=buffers.nbytes(st.buffer),
                  writes=st.buffer.writes, global_step=st.global_step)


def leg_recurrent_ppo(mesh, _data):
    """Four minibatches of four agents' whole sequences, two epochs, two
    updates (the second ends every episode: a truncation bootstrap)."""
    env = make_env(HoverEnv, mesh, N, **hover())
    tr = PPO(env, n_steps=8, batch_size=32, n_epochs=2, seed=9,
             policy_kwargs={"recurrent": True, "hidden_dim": 16, "pi_layers": (16,),
                            "vf_layers": (16,)})
    st = start(tr, mesh)
    for _ in range(2):
        st, m = tr.update(st)
    return result(st, m["loss"], flat(tr.policy), m)


def leg_recurrent_bptt(mesh, _data):
    env = make_env(HoverEnv, mesh, N, requires_grad=True, **hover())
    tr = BPTT(env, horizon=4, seed=10,
              policy_kwargs={"recurrent": True, "hidden_dim": 16, "latent_dim": (16,)})
    st = start(tr, mesh)
    for _ in range(2):
        st, m = tr.update(st)
    return result(st, m["actor_loss"], flat(tr.actor), m)


NOISE = {"depth": {"model": "RedwoodDepthNoiseModel",
                   "kwargs": {"noise_multiplier": 1.0, "lateral_prob": 0.5}},
         "IMU": {"model": "GaussianNoiseModel", "kwargs": {"mean": 0.0, "std": 0.01}}}


def leg_noisy(mesh, _data):
    """One scene split by agents; Redwood depth noise (its per-pixel
    neighbour pick included), IMU noise, ``drag_random`` and wind, with
    episodes of 3 steps so that the auto-resets draw drag and clocks."""
    env = make_env(NavigationEnv, mesh, N, requires_grad=True, **{
        **visual_nav(), "max_episode_steps": 3,
        "random_kwargs": {**SPAWN, "noise_kwargs": NOISE},
        "dynamics_kwargs": dict(DYN, dt=0.03, ctrl_dt=0.03, drag_random=0.3,
                                wind_settings=["0.5 + 0.2*sin(x)", "0*x", "0.1 + 0*x"])})
    tr = BPTT(env, horizon=4, seed=11, policy_kwargs=SMALL)
    st = start(tr, mesh)
    for _ in range(2):
        st, m = tr.update(st)
    return result(st, m["actor_loss"], flat(tr.actor), m,
                  drag=st.env_state.dyn.linear_drag.detach().clone())


def leg_world_model(mesh, _data):
    """PPO over a ``HoverEnv`` whose latents a world model updates by its
    posterior, prior and posterior noise drawn from the env's generator."""
    env = make_env(HoverEnv, mesh, N, **hover(max_episode_steps=6))
    _, obs = env.reset(torch.Generator().manual_seed(0))
    world = create_world_model(obs, deter_dim=8, stoch_dim=8,
                               generator=torch.Generator().manual_seed(12))
    env.initialize_latent(8, 8, world=world)
    tr = PPO(env, n_steps=8, n_epochs=2, batch_size=32, seed=13,
             policy_kwargs={"pi_layers": (16, 16), "vf_layers": (16, 16)})
    st = start(tr, mesh)
    for _ in range(2):
        st, m = tr.update(st)
    return result(st, m["loss"], flat(tr.policy), m,
                  stoch=st.env_state.latent[1].detach().clone())


def leg_habitat(mesh, data):
    """Two scenes of a three-scene habitat dataset, one a rank; a BPTT
    update, the scenes rotated (``reset_scenes``: the loader's next batch),
    another update."""
    env = make_env(NavigationEnv, mesh, N // 2, 2, requires_grad=True, **{
        **visual_nav(), "scene_kwargs": {"path": data},
        "random_kwargs": {"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 0.5, 0.5]}}]}},
        "target": [7.0, 0.0, 1.0]})
    tr = BPTT(env, horizon=3, seed=14, policy_kwargs=SMALL)
    st = start(tr, mesh)
    names = [[s.name for s in env._scene_specs]]
    st, m0 = tr.update(st)
    st = st._replace(env_state=env.reset_scenes(st.env_state))
    names.append([s.name for s in env._scene_specs])
    st, m = tr.update(st)
    return result(st, m["actor_loss"], flat(tr.actor), m, first_loss=float(m0["actor_loss"]),
                  scenes=names)


LEGS = {name[4:]: fn for name, fn in dict(globals()).items() if name.startswith("leg_")}


def _rank_legs(mesh, data):
    torch.set_num_threads(1)
    return {name: fn(mesh, data) for name, fn in LEGS.items()}


def write_dataset(root):
    """A garage stage and a crate, three scenes (``tests/test_torch_habitat.py``'s
    layout, in the habitat frame)."""
    for d in ("configs/stages", "configs/objects", "configs/scenes", "meshes"):
        os.makedirs(os.path.join(root, d), exist_ok=True)

    def cuboids(path, boxes):
        lines, faces, base = [], [], 0
        for c, h in boxes:
            c, h = np.asarray(c, float), np.asarray(h, float)
            for sx in (-1, 1):
                for sy in (-1, 1):
                    for sz in (-1, 1):
                        p = c + h * np.array([sx, sy, sz])
                        lines.append(f"v {p[0]} {p[1]} {p[2]}")
            for a, b, cc, d in [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
                                (0, 2, 6, 4), (1, 5, 7, 3)]:
                faces.append(f"f {base + a + 1} {base + b + 1} {base + cc + 1}")
                faces.append(f"f {base + a + 1} {base + cc + 1} {base + d + 1}")
            base += 8
        with open(os.path.join(root, path), "w") as f:
            f.write("\n".join(lines + faces) + "\n")

    def write(path, obj):
        with open(os.path.join(root, path), "w") as f:
            json.dump(obj, f)

    t = 0.2
    cuboids("meshes/garage.obj", [([0.0, -t / 2, -4.0], [3 + t, t / 2, 4 + t]),
                                  ([-(3 + t / 2), 1.5, -4.0], [t / 2, 1.5, 4 + t]),
                                  ([+(3 + t / 2), 1.5, -4.0], [t / 2, 1.5, 4 + t]),
                                  ([0.0, 1.5, t / 2], [3 + t, 1.5, t / 2]),
                                  ([0.0, 1.5, -(8 + t / 2)], [3 + t, 1.5, t / 2])])
    cuboids("meshes/cube.obj", [([0, 0, 0], [0.3, 0.3, 0.3])])
    write("configs/stages/garage.stage_config.json", {"render_asset": "../../meshes/garage.obj"})
    write("configs/objects/cube.object_config.json", {"render_asset": "../../meshes/cube.obj"})
    for i, x in enumerate((0.0, 1.0, -1.0)):
        write(f"configs/scenes/garage_{i}.scene_instance.json", {
            "stage_instance": {"template_name": "garage"},
            "object_instances": [{"template_name": "cube", "translation": [x, 1.0, -4.0 - i],
                                  "rotation": [1.0, 0.0, 0.0, 0.0]}]})
    write("test.scene_dataset_config.json", {
        "stages": {"paths": {".json": ["configs/stages/*.json"]}},
        "objects": {"paths": {".json": ["configs/objects/*.json"]}},
        "scene_instances": {"paths": {".json": ["configs/scenes/*.json"]}}})
    return os.path.join(root, "configs", "scenes")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("habitat_ranks")))


@pytest.fixture(scope="module")
def single(data):
    """Every leg on one process (this one), before the ranks start: the
    habitat leg builds the native baker here, not in two ranks at once."""
    return {name: fn(None, data) for name, fn in LEGS.items()}


@pytest.fixture(scope="module")
def ranks(single, data):
    return run_ranks(_rank_legs, RANKS, data, timeout=LIMIT)


def l2_rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def check(single, ranks, name):
    want, outs = single[name], [r[name] for r in ranks]
    assert abs(outs[0]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"]), (
        outs[0]["loss"], want["loss"])
    for o in outs:
        assert o["loss"] == outs[0]["loss"] and o["metrics"] == outs[0]["metrics"]
        assert torch.equal(o["params"], outs[0]["params"])
    for k, v in want["metrics"].items():
        assert np.isclose(outs[0]["metrics"][k], v, rtol=1e-5, atol=1e-6), (k, outs[0][
            "metrics"][k], v)
    assert l2_rel(outs[0]["params"], want["params"]) <= 1e-4
    pos = torch.cat([o["pos"] for o in outs])
    torch.testing.assert_close(pos, want["pos"], atol=1e-5, rtol=0)
    return want, outs


@pytest.mark.parametrize("name", ["shac_hover", "shac_visual"])
def test_shac_sharded_matches_unsharded(single, ranks, name):
    want, outs = check(single, ranks, name)
    if name == "shac_hover":  # steps count the whole batch's agents
        assert want["global_step"] == outs[0]["global_step"] == 2 * 4 * N


def test_apg_sharded_matches_unsharded(single, ranks):
    want, outs = check(single, ranks, "apg")
    assert want["global_step"] == outs[0]["global_step"] == 2 * 4 * N


def test_sac_sharded_ring_wraps_and_matches_unsharded(single, ranks):
    """Auto-entropy on, a 40-row ring of 16 agents a step that wrapped twice:
    each rank holds its agents' rows of the last ⌈40 / 16⌉ steps, half the
    ring and half a step."""
    want, outs = check(single, ranks, "sac")
    assert want["metrics"]["alpha"] != 1.0  # the temperature stepped
    assert want["writes"] == outs[0]["writes"] == 5 * N
    assert want["ring_rows"] == SAC_RING
    assert all(o["ring_rows"] == 3 * (N // RANKS) for o in outs)
    assert all(o["ring_bytes"] < 0.61 * want["ring_bytes"] for o in outs)
    assert want["global_step"] == outs[0]["global_step"] == 5 * N


def test_recurrent_ppo_sharded_matches_unsharded(single, ranks):
    want, _ = check(single, ranks, "recurrent_ppo")
    assert want["metrics"]["ep_len_mean"] == 16.0


def test_recurrent_bptt_sharded_matches_unsharded(single, ranks):
    check(single, ranks, "recurrent_bptt")


def test_noise_drag_and_wind_sharded_match_unsharded(single, ranks):
    """Sensor and IMU noise, drag and reset clocks: the ranks slice the
    whole batch's draws, so the run is the one process's."""
    want, outs = check(single, ranks, "noisy")
    drag = torch.cat([o["drag"] for o in outs])
    assert torch.equal(drag, want["drag"])
    assert len(torch.unique(want["drag"][:, 0])) > 1  # redrawn per agent at a reset


def test_world_model_latent_env_sharded_matches_unsharded(single, ranks):
    want, outs = check(single, ranks, "world_model")
    stoch = torch.cat([o["stoch"] for o in outs])
    torch.testing.assert_close(stoch, want["stoch"], atol=1e-5, rtol=0)
    assert float(want["stoch"].abs().max()) > 0


def test_habitat_dataset_split_by_scenes_matches_unsharded(single, ranks):
    """Each rank's scenes are the files the one env's loader puts at its
    indices, before and after the rotation."""
    want, outs = check(single, ranks, "habitat")
    assert abs(outs[0]["first_loss"] - want["first_loss"]) <= 1e-5 * abs(want["first_loss"])
    for i in range(2):
        assert [o["scenes"][i][0] for o in outs] == want["scenes"][i]
    assert want["scenes"][0] != want["scenes"][1]


def test_chip_smoke_path_r_runs_the_published_configs():
    """Path R1's settings equal ``alg_cfgs/cluttered_flight/SHAC.yaml`` (its
    algorithm and env sections) on ``env_cfgs/cluttered_flight.yaml``; R4 is
    ``PPO_tuned.yaml`` with the recurrent policy, one minibatch of the 48
    agents' 32-step sequences; R3's ring of 500,000 rows splits over two
    ranks of 32 agents into 7,813 steps of each rank's rows."""
    import yaml

    import chip_smoke

    exps = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "visfly_tpu", "exps")
    with open(os.path.join(exps, "alg_cfgs", "cluttered_flight", "SHAC.yaml")) as f:
        shac = yaml.safe_load(f)
    assert chip_smoke.SHAC_CLUTTERED == shac["algorithm"]
    assert chip_smoke.SHAC_CLUTTERED_ENV == shac["env"]
    env = HoverEnv(num_agent_per_scene=48, device="cpu")
    tr = PPO(env, **dict(chip_smoke.PPO_TUNED, n_steps=32, policy_kwargs=dict(
        chip_smoke.PPO_TUNED["policy_kwargs"], recurrent=True)))
    assert tr.recurrent and (tr.n_minibatches, tr.batch_size) == (1, 48 * 32)
    obs = {"state": torch.zeros(32, 13)}
    buf = buffers.create(chip_smoke.SAC_NAV2["buffer_size"], obs, 4, rows=(32, 64, 64))
    assert buf.rewards.shape[0] == 7813 * 32 and buffers.capacity(buf) == 500_000


def test_rank_rotation_follows_the_larger_env(tmp_path):
    """A rank that owns scenes 2 and 3 of four holds the one env's scenes 2
    and 3, of a preset and of a directory of scene files, before and after
    ``reset_scenes`` (rules only: no group joined)."""
    from visfly_tpu_torch.parallel import Mesh
    from visfly_tpu_torch.scene.scene import generate_scene_dataset

    generate_scene_dataset(str(tmp_path), "garage_simple_l_medium", 6, seed=3)
    mesh = Mesh(1, RANKS, "gloo", torch.device("cpu"))

    def key(spec):
        return [sorted((k, np.asarray(v).tolist()) for k, v in p.items())
                for p in spec.primitives]

    for path in ("garage_simple_l_medium", str(tmp_path)):
        kw = {**visual_nav(), "scene_kwargs": {"path": path}}
        one = NavigationEnv(num_agent_per_scene=2, num_scene=4, **kw)
        rank = make_rank_env(NavigationEnv, mesh, 2, 4, **kw)
        for _ in range(2):
            assert [key(s) for s in rank._scene_specs] == [key(s) for s in one._scene_specs[2:]]
            assert key(one._scene_specs[0]) != key(one._scene_specs[2])
            one.reset_scenes()
            rank.reset_scenes()
