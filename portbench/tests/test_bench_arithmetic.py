"""The benchmark's arithmetic against hand counts."""
import math

import pytest
import torch

from portbench import bounds, trace
from portbench.harness import Reservoir, p95, window_metrics


def test_rate_is_over_the_whole_window():
    m = window_metrics("step", 72, 300, 12.5, [1.0] * 300)
    assert m["env_steps_per_s"] == pytest.approx(72 * 300 / 12.5)
    assert window_metrics("sensor_observations", 1024, 40, 4.0, [])["frames_per_s"] == 10240


def test_p95_over_all_steps():
    assert p95(list(range(1, 101))) == 95
    gaps = [10.0] * 95 + [50.0, 60.0, 70.0, 80.0, 90.0]
    assert p95(gaps) == 10.0
    assert p95(gaps + [100.0]) == 50.0
    assert math.isnan(window_metrics("step", 1, 0, 1.0, [])["step_ms_p95"])


def test_idle_is_the_complement_of_the_union_of_overlapping_intervals():
    ivs = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.8), (5.0, 6.0)]
    assert trace.union_length(ivs) == pytest.approx(4.0)
    assert trace.gaps(ivs, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]
    dev = [("k1", 0.0, 2e6), ("k2", 1e6, 3e6), ("k1", 5e6, 6e6)]
    spans = [("window", -1e6, 7e6), ("env.step", 2.9e6, 5.5e6), ("consume", 5.5e6, 7e6)]
    b = trace.breakdown(dev, spans, (-1e6, 7e6))
    assert b["device_ops"] == [["k1", 3.0], ["k2", 2.0]]
    assert dict(b["idle_gaps"]) == {"env.step": 2.0, "none": 1.0, "consume": 1.0}


def test_reservoir_keeps_k_of_n_drawn_from_the_seed():
    def draw(seed):
        r = Reservoir(3, seed)
        for i in range(100):
            slot = r.wants()
            if slot is not None:
                r.put(slot, i)
        return sorted(r.items)

    assert draw(7) == draw(7) and len(draw(7)) == 3
    assert draw(7) != draw(8)


def _tile(width=32):
    """One tile of 1,024 rays: 32 rows of a 32-wide camera at the origin
    looking along +x with a 90° field."""
    u = torch.linspace(-1, 1, width)
    v = torch.linspace(1, -1, 1024 // width)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([torch.ones_like(uu), -uu, vv], -1).reshape(-1, 3)
    return torch.zeros(1, 3), (d / d.norm(dim=-1, keepdim=True))[None]


def test_a_triangle_is_needed_only_inside_the_tiles_wedge_and_reach():
    o, d = _tile()
    ahead = torch.tensor([[[5.0, -0.5, -0.5], [5.0, 0.5, -0.5], [5.0, 0.0, 0.5]]])
    behind = -ahead
    aside = ahead + torch.tensor([0.0, 30.0, 0.0])  # outside the wedge, inside the reach
    far = ahead + torch.tensor([40.0, 0.0, 0.0])  # past the far depth
    vis = bounds.visible(torch.cat([ahead, behind, aside, far]), o, d, 32, 20.0)
    assert vis.tolist() == [[True, False, False, False]]


def test_crossing_work_counts_rows_spheres_and_templates():
    from portbench.tests._fixture import cell

    ref = cell("crossing_tiny.rollout").reference("cpu")
    pos = torch.tensor([[1.0, -1.0, 1.5], [1.0, 0.0, 1.5], [1.0, 1.0, 1.5],
                        [1.0, 0.0, 1.0], [-3.0, 0.5, 2.0], [2.0, 0.0, 2.5]])
    q = torch.tensor([[1.0, 0, 0, 0]] * 6)
    ops, nbytes = ref.work(pos, q)
    from portbench.reference import geometry as G

    want = 0
    for c_ in range(6):
        s = c_ // 3
        o, dd, _ = G.camera_rays(ref.sensors[0], pos[c_:c_ + 1], q[c_:c_ + 1])
        planes = bounds.wedge_planes(dd, 32)[0]
        lo = o[0] + 20.0 * torch.clamp(dd[0].amin(0), max=0)
        hi = o[0] + 20.0 * torch.clamp(dd[0].amax(0), min=0)
        caps = 0
        for a, b, r in ref.scenes[s][2]:
            clo, chi = torch.minimum(a, b) - r, torch.maximum(a, b) + r
            corners = torch.stack([torch.stack([(clo, chi)[i][0], (clo, chi)[j][1], (clo, chi)[k][2]])
                                   for i in (0, 1) for j in (0, 1) for k in (0, 1)])
            if not (torch.all(lo <= chi) and torch.all(hi >= clo)):
                continue
            if any(bool(torch.all((corners - o[0]) @ p < 0)) for p in planes):
                continue
            caps += 1
        want += 1024 * (66 + 71 * caps) + 15 + 63 * caps
        for m in range(s * 3, s * 3 + 3):
            if m == c_:
                continue
            want += 1024 * 25
            e = pos[m] - o[0]
            for ray in dd[0]:
                b_ = float(e @ ray)
                disc = b_ * b_ - (float(e @ e) - 0.01)
                if disc > 0 and b_ + math.sqrt(disc) > 0:
                    want += 84 * 14
    assert ops == pytest.approx(want, rel=1e-12)
    assert nbytes == 6 * (28 + 1024 * 4) + 2 * (13 * 4 + 10 * 9 * 4) + 6 * 84 * 36
