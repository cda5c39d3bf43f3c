"""The spawn rejection of ``visfly_tpu_torch`` (``envs/randomization.py::
safe_sample``, ``envs/base.py::_spawn``), one batched pass over a try axis,
against the 16-round masked loop it replaced, kept here as the reference: the
loop's ``sample`` and rejection written out as they were, drawing from the
same generator. Every comparison is exact (``torch.equal``): the pass makes
the same draws in the same order, runs the same tests and keeps the same
try. Also its two device counters under a CPU ``torch.profiler``, and the
number of operations a spawn launches.
"""
import pytest
import torch

from visfly_tpu_torch import envs as tenvs
from visfly_tpu_torch.core import quaternion as quat
from visfly_tpu_torch.envs.randomization import RandomizerSpec, safe_sample
from visfly_tpu_torch.scene import point_is_collision
from visfly_tpu_torch.utils import profiling

torch.set_num_threads(1)

MAX_TRIES = 16


# -- the reference: the masked loop, as it was ---------------------------------

def _loop_yaw_pitch(vector):
    x, y, z = vector.unbind(-1)
    y_sign = torch.where(torch.sign(y) >= 0, 1.0, -1.0).to(vector.dtype)
    xy_norm = torch.linalg.vector_norm(vector[:, :2], dim=1)
    yaw = torch.arccos(torch.clamp(x / torch.clamp(xy_norm, min=1e-9), -1.0, 1.0)) * y_sign
    norm = torch.linalg.vector_norm(vector, dim=1)
    pitch = torch.arcsin(torch.clamp(z / torch.clamp(norm, min=1e-9), -1.0, 1.0))
    return yaw, pitch


def _loop_sample(spec, gen, n, target_pos=None, target_vel=None):
    dev = spec.pos_mean.device

    def unit(draw=torch.rand):
        return draw((n, 3), generator=gen, device=dev)

    def u(mean, half):
        return (2.0 * unit() - 1.0) * half + mean

    zeros = torch.zeros(n, device=dev)
    if spec.kind == "normal":
        def draw(mean, std):
            return (2.0 * unit(torch.randn) - 1.0) * std + mean

        pos = draw(spec.pos_mean, spec.pos_half)
        euler = draw(spec.ori_mean, spec.ori_half)
        vel = draw(spec.vel_mean, spec.vel_half)
        omega = draw(spec.omega_mean, spec.omega_half)
    elif spec.kind == "target_uniform":
        tp = (torch.zeros((n, 3), device=dev) if target_pos is None
              else target_pos.expand(n, 3))
        offset = (2.0 * unit() - 1.0) * spec.pos_half
        norm = torch.linalg.vector_norm(offset, dim=1, keepdim=True)
        one = torch.ones_like(norm)
        scale = torch.where(norm > spec.max_dis, spec.max_dis / norm, one)
        scale = torch.where(norm < spec.min_dis, spec.min_dis / torch.clamp(norm, min=1e-9),
                            scale)
        pos = offset * scale + tp
        yaw, _pitch = _loop_yaw_pitch(tp - pos)
        euler = torch.stack([zeros, zeros, yaw], dim=1) + (2.0 * unit() - 1.0) * spec.ori_half
        if target_vel is not None:
            vel = target_vel.expand(n, 3) + (2.0 * unit() - 1.0) * spec.vel_half
        else:
            vel = u(spec.vel_mean, spec.vel_half)
        omega = u(spec.omega_mean, spec.omega_half)
    else:
        half = (2.0 * unit() - 1.0) * spec.pos_half
        pos = spec.pos_mean + half
        if spec.heading:
            yaw, _pitch = _loop_yaw_pitch(-half)
            euler = (torch.stack([zeros, zeros, yaw], dim=1)
                     + (2.0 * unit() - 1.0) * spec.ori_half)
        else:
            euler = u(spec.ori_mean, spec.ori_half)
        vel = u(spec.vel_mean, spec.vel_half)
        omega = u(spec.omega_mean, spec.omega_half)
    q = quat.from_euler(euler[:, 0], euler[:, 1], euler[:, 2], order="zyx")
    return pos, q, vel, omega


def _loop_safe_sample(spec, gen, n, is_collision_fn=None, target_pos=None, target_vel=None):
    """The masked loop; also each agent's count of rejected rounds."""
    state = _loop_sample(spec, gen, n, target_pos, target_vel)
    redraws = torch.zeros((n,), dtype=torch.int64, device=spec.pos_mean.device)
    if is_collision_fn is None:
        return state, redraws
    for _ in range(MAX_TRIES):
        bad = is_collision_fn(state[0])
        redraws = redraws + bad
        redraw = _loop_sample(spec, gen, n, target_pos, target_vel)
        state = tuple(torch.where(bad[:, None], new, old) for new, old in zip(redraw, state))
    return state, redraws


def _loop_spawn(env, gen):
    """``env._spawn`` as the loop made it: one block a randomizer, the larger
    env's draws sliced to this env's rows, only those rows tested (in their
    agents' scenes for one block, in scene 0 for several)."""
    lo, hi, n = env.global_rows
    n_per = n // max(len(env.randomizers), 1)
    target = getattr(env, "target", None)
    outs = []
    for j, spec in enumerate(env.randomizers):
        a, b = max(lo, j * n_per), min(hi, (j + 1) * n_per)

        def fn(pos, a=a, b=b, j=j):
            bad = torch.zeros((pos.shape[0],), dtype=torch.bool, device=pos.device)
            if a < b:
                rows = slice(a - j * n_per, b - j * n_per)
                sid = (env.scene_ids if n_per == n
                       else torch.zeros((b - a,), dtype=torch.long, device=pos.device))
                bad[rows] = point_is_collision(env.scene, pos[rows], sid=sid, radius=1.0)
            return bad

        outs.append(_loop_safe_sample(spec, gen, n_per, fn if env.visual else None,
                                      target_pos=None if target is None else target[0])[0])
    return tuple(torch.cat(parts, dim=0)[lo:hi].to(env.dtype) for parts in zip(*outs))


# -- safe_sample ----------------------------------------------------------------

def _spec(kind, device=None):
    return RandomizerSpec.uniform(
        position={"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]},
        orientation={"mean": [0.0, 0.1, 0.0], "half": [0.1, 0.1, 0.5]},
        velocity={"mean": [0.2, 0.0, 0.0], "half": [0.2, 0.2, 0.2]},
        angular_velocity={"mean": [0.0, 0.0, 0.1], "half": [0.1, 0.1, 0.1]},
        kind="uniform" if kind == "heading" else kind.replace("_per_agent", ""),
        heading=kind == "heading", min_dis=1.0, max_dis=2.0, device=device)


def _targets(kind, n, device=None):
    if kind == "target_uniform":
        return torch.tensor([5.0, 0.0, 1.0], device=device), None
    if kind == "target_uniform_per_agent":
        g = torch.Generator().manual_seed(7)
        return (torch.rand((n, 3), generator=g).to(device) * 4.0,
                torch.rand((n, 3), generator=g).to(device) - 0.5)
    return None, None


REJECT = {
    "none": lambda pos: torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device),
    "half": lambda pos: torch.frac(torch.abs(pos[..., 1] * 5.0 + pos[..., 2] * 3.0)) < 0.5,
    "all": lambda pos: torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device),
}
KINDS = ["uniform", "heading", "normal", "target_uniform", "target_uniform_per_agent"]


@pytest.mark.parametrize("reject", list(REJECT))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [37, 72])
def test_safe_sample_equals_the_masked_loop(kind, reject, n):
    """Each randomizer kind, a test rejecting none, about half and all of
    the draws (all: every agent keeps its 17th, untested draw): the batched
    pass returns the loop's tensors and leaves the generator where the loop
    leaves it."""
    spec = _spec(kind)
    tp, tv = _targets(kind, n)
    g_loop, g_pass = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    want, redraws = _loop_safe_sample(spec, g_loop, n, REJECT[reject], tp, tv)
    got = safe_sample(spec, g_pass, n, is_collision_fn=REJECT[reject], target_pos=tp,
                      target_vel=tv)
    for name, g, w in zip(("pos", "q", "vel", "omega"), got, want):
        assert g.shape == w.shape and torch.equal(g, w), name
    assert torch.equal(g_loop.get_state(), g_pass.get_state())
    if reject == "half":  # the mix the case is for: some agents redraw, some not at once
        assert 0 < int((redraws > 0).sum()) < n and int((redraws == 0).sum()) > 0
    if reject == "all":
        assert (redraws == MAX_TRIES).all()


@pytest.mark.parametrize("kind", KINDS)
def test_safe_sample_without_a_test_draws_once(kind):
    """No collision test (a non-visual env): one sample, as ``sample`` and the
    loop make it."""
    spec = _spec(kind)
    tp, tv = _targets(kind, 37)
    g_loop, g_pass = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    want = _loop_sample(spec, g_loop, 37, tp, tv)
    got = safe_sample(spec, g_pass, 37, target_pos=tp, target_vel=tv)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(g_loop.get_state(), g_pass.get_state())


def _counted_reject(pos):
    """Even agents always rejected (each exhausts its tries), odd ones about
    half of the time."""
    even = torch.arange(pos.shape[-2]) % 2 == 0
    return even | REJECT["half"](pos)


def test_spawn_counters_equal_the_loops():
    """Under a CPU profiler ``spawn.redraws`` is the sum of the kept tries'
    indices and ``spawn.exhausted`` the agents rejected on all 16 tested
    tries, as the loop counts them; with no profiler neither is recorded."""
    spec, n = _spec("uniform"), 40
    _, redraws = _loop_safe_sample(spec, torch.Generator().manual_seed(11), n, _counted_reject)
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        safe_sample(spec, torch.Generator().manual_seed(11), n, is_collision_fn=_counted_reject)
    got = profiling.counters()
    assert got["spawn.redraws"] == int(redraws.sum())
    assert got["spawn.exhausted"] == int((redraws == MAX_TRIES).sum()) >= n // 2
    assert 0 < got["spawn.redraws"] - MAX_TRIES * got["spawn.exhausted"]
    profiling.reset_counters()
    safe_sample(spec, torch.Generator().manual_seed(11), n, is_collision_fn=_counted_reject)
    assert "spawn.redraws" not in profiling.counters()
    assert "spawn.exhausted" not in profiling.counters()


# -- the env's spawn ------------------------------------------------------------

S, A = 2, 3
CROSSING = {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 2.0, 1.0]}}
# half of it out of the scene's bounds or near its walls: many agents redraw
WIDE = {"position": {"mean": [1.0, 0.0, 1.5], "half": [4.0, 6.0, 3.0]},
        "orientation": {"mean": [0.0, 0.0, 0.0], "half": [0.2, 0.2, 3.0]}}


def _env(blocks, visual=True, num_scene=S):
    kwargs = [WIDE if j % 2 else CROSSING for j in range(blocks)]
    return tenvs.MultiNavigationEnv(
        device="cpu", num_agent_per_scene=A, num_scene=num_scene, visual=visual,
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": kwargs}},
        max_episode_steps=256, scene_kwargs={"path": "garage_crossing", "trace_steps": 32},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        sensor_kwargs=[{"sensor_type": "depth", "uuid": "depth", "resolution": [8, 8]}])


ENVS = {
    "one_block": lambda: _env(1),
    "two_blocks": lambda: _env(2),
    "split_one_block": lambda: _env(1),
    "split_two_blocks": lambda: _env(2),
    "not_visual": lambda: _env(2, visual=False),
}


@pytest.fixture(scope="module")
def envs():
    return {}


@pytest.mark.parametrize("case", list(ENVS))
def test_env_spawn_equals_the_masked_loop(case, envs):
    """A swarm env on the CPU (2 scenes × 3 drones of the crossing run):
    ``_spawn`` equals the loop's over one and two randomizer blocks (the
    second a wide box, where many draws are rejected), for an env holding
    the second half of a larger env's rows (``global_rows``, as a rank of
    ``parallel/mesh.py`` does), and without the rejection (not visual)."""
    env = envs.setdefault(case, ENVS[case]())
    if case.startswith("split"):
        env.global_rows = (A * S, 2 * A * S, 2 * A * S)
    for seed in (0, 1, 2):
        g_loop = torch.Generator().manual_seed(seed)
        g_pass = torch.Generator().manual_seed(seed)
        want = _loop_spawn(env, g_loop)
        got = env._spawn(g_pass)
        for name, g, w in zip(("pos", "q", "vel", "omega"), got, want):
            assert g.shape == w.shape == (env.num_agent, w.shape[-1]), name
            assert torch.equal(g, w), (case, seed, name)
        assert torch.equal(g_loop.get_state(), g_pass.get_state())


def _top_level_aten_ops(prof):
    """The profiler's ``aten::`` events with no ``aten::`` event above them:
    the operations the caller launched."""
    def top(e):
        p = e.cpu_parent
        while p is not None:
            if p.name.startswith("aten::"):
                return False
            p = p.cpu_parent
        return True

    return [e.name for e in prof.events() if e.name.startswith("aten::") and top(e)]


def test_env_spawn_launches_few_operations(envs):
    """The crossing run's spawn (one block, two scenes) issues under 300
    top-level operations a call, where the loop issued ~2,400: the count is
    fixed by the code, not by the draws."""
    env = envs.setdefault("one_block", ENVS["one_block"]())
    gen = torch.Generator().manual_seed(0)
    env._spawn(gen)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        env._spawn(gen)
    ops = _top_level_aten_ops(prof)
    profiling.reset_counters()
    assert 60 < len(ops) < 300, len(ops)
