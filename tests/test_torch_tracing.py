"""The port's spans and counters (``visfly_tpu_torch/utils/profiling.py``)
in a tiny ``MultiNavigationEnv`` step (2 scenes × 3 drones, 16×16 depth, the
terminal observation's render too): with no profiler no span reaches the
profiler and no counter is made; under a CPU profiler every span of the
step is emitted, nested as the layers are, and the counters equal their
values worked out by hand; the step's outputs are bitwise equal with tracing
on and off."""
import pytest
import torch

from visfly_tpu_torch import envs
from visfly_tpu_torch.render import sphere_trace
from visfly_tpu_torch.utils import profiling

torch.set_num_threads(2)

S, N, H, W, K = 2, 3, 16, 16, 84
SPANS = ("env.dynamics", "env.collision", "env.reward", "env.auto_reset", "env.spawn",
         "render.sensors", "render.scene_trace", "render.object_hits")


@pytest.fixture(scope="module")
def env():
    e = envs.MultiNavigationEnv(
        device="cpu", num_agent_per_scene=N, num_scene=S, seed=42, visual=True,
        max_episode_steps=256, scene_kwargs={"path": "garage_crossing", "trace_steps": 32},
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 2.0, 1.0]}}]}},
        sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [H, W]}],
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate",
                         "ctrl_delay": True})
    e.terminal_obs_in_info = True
    return e


def _action(i):
    g = torch.Generator().manual_seed(100 + i)
    return torch.rand((S * N, 4), generator=g) * 0.6 - 0.3


def _steps(env, n, traced):
    """``n`` steps from a fresh reset; each traced step under a CPU profiler."""
    state, _obs = env.reset(torch.Generator().manual_seed(3))
    outs, profs = [], []
    for i in range(n):
        if traced:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
                state, out = env.step(state, _action(i))
            profs.append(p)
        else:
            state, out = env.step(state, _action(i))
        outs.append(out)
    return state, outs, profs


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, torch.Generator):
        return [x.get_state()]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _flat(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


def test_no_profiler_calls_into_nothing(env, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "count", refuse)
    profiling.reset_counters()
    assert not profiling.tracing()
    assert profiling.span("env.dynamics") is profiling.span("render.sensors")
    _state, outs, _ = _steps(env, 1, traced=False)
    assert outs[0].obs["depth"].shape == (S * N, 1, H, W)
    assert profiling.counters() == {}


def test_a_step_emits_every_span_nested(env):
    _state, _outs, (prof,) = _steps(env, 1, traced=True)
    ranges = {}
    for e in prof.events():
        if e.name in SPANS:
            ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert set(ranges) == set(SPANS)
    # the step's query and the respawn's; the terminal observation and the
    # observation, each one trace and one mesh-hit pass
    counts = {k: len(v) for k, v in ranges.items()}
    assert counts == {"env.dynamics": 1, "env.collision": 2, "env.reward": 1,
                      "env.auto_reset": 1, "env.spawn": 1, "render.sensors": 2,
                      "render.scene_trace": 2, "render.object_hits": 2}

    def inside(child, parent):
        return all(any(p0 <= c0 and c1 <= p1 for p0, p1 in ranges[parent])
                   for c0, c1 in ranges[child])

    assert inside("env.spawn", "env.auto_reset")
    assert inside("render.object_hits", "render.sensors")
    assert inside("render.scene_trace", "render.sensors")
    (a0, a1), = ranges["env.auto_reset"]
    assert sum(a0 <= c0 and c1 <= a1 for c0, c1 in ranges["env.collision"]) == 1


def test_counters_equal_their_hand_values(env):
    state, _obs = env.reset(torch.Generator().manual_seed(3))
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state, out = env.step(state, _action(0))
        counts = profiling.counters()
    profiling.reset_counters()
    R = N * H * W
    assert counts["spawn.agents"] == S * N
    assert counts["reset.respawned"] == int(out.done.sum())
    # two renders, each every ray of a scene against every triangle of each
    # of its N posed templates
    assert counts["object_hits.tests"] == 2 * S * R * N * K
    assert 0 <= counts["object_hits.candidate_tests"] <= counts["object_hits.tests"]
    assert counts["object_hits.candidate_tests"] % K == 0


def test_object_hit_counters_by_hand():
    """One scene, one drone 5 m down the x axis (radius 1, a 2-triangle
    template), three rays from the origin: along +x (meets its sphere), along
    -x and along +y (miss): 3 · 2 tests, 2 on a candidate ray."""
    tri = torch.tensor([[0.0, -0.5, -0.5, 0.0, 0.5, -0.5, 0.0, 0.0, 0.5],
                        [0.0, -0.5, 0.5, 0.0, 0.5, 0.5, 0.0, 0.0, -0.5]])
    objects = (torch.tensor([[[5.0, 0.0, 0.0]]]), torch.tensor([[1.0]]), None,
               tri[None, None])
    o = torch.zeros((1, 3, 3))
    d = torch.tensor([[[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t, hit, _n, _c = sphere_trace._object_mesh_hits(objects, o, d, 20.0)
        counts = profiling.counters()
    profiling.reset_counters()
    assert counts == {"object_hits.tests": 6, "object_hits.candidate_tests": 2}
    assert hit.tolist() == [[True, False, False]] and float(t[0, 0]) == pytest.approx(5.0)


def test_outputs_are_bitwise_equal_with_tracing_on_and_off(env):
    off = _steps(env, 2, traced=False)
    on = _steps(env, 2, traced=True)
    profiling.reset_counters()
    a, b = _flat(off[:2]), _flat(on[:2])
    assert len(a) == len(b) > 20
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_counters_keep_device_values_until_read():
    profiling.reset_counters()
    profiling.count("a", 2)
    profiling.count("a", torch.tensor(3))
    profiling.count("b", torch.tensor([True, False, True]).sum())
    profiling.count("c", 5)
    assert isinstance(profiling._counts["a"], torch.Tensor)
    assert profiling.counters() == {"a": 5, "b": 2, "c": 5}
    profiling.reset_counters()
    assert profiling.counters() == {}
