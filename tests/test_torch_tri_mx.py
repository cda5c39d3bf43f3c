"""The matrix-form triangle kernel (``mode="mx"`` of
``visfly_tpu_torch/render/tri_kernel.py``, ``tri_trace_mx_kernel`` of
``csrc/tri_trace.cu``) as far as the CPU can hold it. The kernel takes the
three signed volumes on the tensor cores in TF32, each factor split into two
TF32 parts and three of the four products summed; its CUDA code runs only on
the card, where ``chip_smoke.py`` holds it against its plain version, its
split model and the brute force. Here:

- the split's plain model, ``tf32_split``: both parts keep 10 mantissa bits,
  ``|x − hi − lo| ≤ 2⁻²²·|x|``, odd in x to the bit, and 0, ±inf, NaN and
  ties as ``cvt.rna.tf32.f32`` gives them;
- the three-pass volumes (``sv_first_hit_tf32``) on the 2,304-triangle cube
  grid of ``test_torch_tri_variants.py``, moved 0, 20 and 40 m from the
  origin, against a float64 brute force within the smoke's 1e-3 m (and
  against the plain version of ``mode="mx"``, full float32, within 1e-4 m);
  one TF32 pass lands past 1e-3 m, which is why the kernel splits;
- the kernel's lane layout: a ray's best spread over the four lanes of a
  quad (lane ``c`` holds the columns ``2c`` and ``2c + 1`` of every eight
  triangles of the product's accumulators) and merged by (t, list position)
  gives the sequential walk's first strict minimum, ties included;
- the wrapper refuses what the kernel does not take.
"""
import numpy as np
import pytest
import torch

from test_torch_tri_trace import T, camera_rays, cube_grid
from visfly_tpu_torch.render import tri_kernel as tk
from visfly_tpu_torch.render import tri_trace as pt

torch.set_num_threads(1)

MAX_DEPTH = 20.0
T_TOL = 1e-3  # m: chip_smoke.py's limit for any kernel against its references
RES = 32


def _bits(x):
    return x.contiguous().view(torch.int32)


def _floats(seed, scale, n=20000):
    """Random float32 of both signs over six decades around ``scale``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n) * scale * 10.0 ** rng.uniform(-3, 3, n)
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_split_parts_are_tf32(scale):
    hi, lo = tk.tf32_split(_floats(0, scale))
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert int((_bits(part) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_split_error_bound(scale):
    """The rest of x beyond hi + lo is at most 2⁻²² of x, and lo at most
    2⁻¹¹ of it (hi is x rounded to nearest)."""
    x = _floats(1, scale)
    hi, lo = tk.tf32_split(x)
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert bool(((xd - hd - ld).abs() <= 2.0 ** -22 * xd.abs()).all())
    assert bool((ld.abs() <= 2.0 ** -11 * xd.abs()).all())
    assert float((ld != 0).double().mean()) > 0.99  # float32 values are rarely TF32


def test_split_is_odd_to_the_bit():
    """A shared edge's negated coefficients stay exact negations: the split of
    −x is that of x negated, bit for bit, zeros and exact TF32 values
    included."""
    x = torch.cat([_floats(2, 1.0), torch.tensor([0.0, 1.0, 0.75, 2.0 ** -20, 3.0e7])])
    for a, b in zip(tk.tf32_split(-x), tk.tf32_split(x)):
        assert torch.equal(_bits(a), _bits(-b))


def test_split_special_values():
    x = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                      3.4028234663852886e38])
    hi, lo = tk.tf32_split(x)
    assert torch.equal(_bits(hi[:4]), _bits(x[:4]))  # ±0 and ±inf stay, signs included
    assert torch.equal(_bits(lo[:2]), _bits(x[:2]))  # the rest of ±0 is ±0
    assert bool(torch.isnan(hi[4])) and bool(torch.isnan(lo[2:5]).all())  # inf − inf, NaN
    assert float(hi[5]) == float("inf")  # the largest float32 rounds up past the largest TF32


def test_split_rounds_to_nearest_ties_away():
    """rna: to the nearest TF32 value, a tie away from zero."""
    u = 2.0 ** -10  # a TF32 ulp at 1
    x = torch.tensor([1.0 + u / 2, -(1.0 + u / 2), 1.0 + u / 2 - 2.0 ** -23, 1.0 + 3 * u / 2,
                      1.0 + u / 2 + 2.0 ** -23], dtype=torch.float32)
    hi, lo = tk.tf32_split(x)
    assert hi.tolist() == [1.0 + u, -(1.0 + u), 1.0, 1.0 + 2 * u, 1.0 + u]
    # a tie's rest, half a TF32 ulp, is itself TF32: hi + lo is x
    exact = [0, 1, 3]
    assert (hi.double() + lo.double())[exact].tolist() == x.double()[exact].tolist()


@pytest.fixture(scope="module")
def grid_cases():
    """offset → (tris (T, 9), origin triple, dirs (R, 3), t64, hit64): the cube
    grid and one 32×32 camera moved together ``offset`` m along x and y, and
    the float64 brute force on the same float32 geometry."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)
    o_c, d_c = camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]], res=(RES, RES))
    d = T(d_c[:, 0].T)
    out = {}
    for off in (0.0, 20.0, 40.0):
        shift = np.asarray([off, off, 0.0], np.float32)
        tr = T((tris.reshape(-1, 3, 3) + shift).reshape(-1, 9))
        o = (o_c[:, 0, 0] + shift).astype(np.float32)
        o_rays = T(np.broadcast_to(o, d.shape))
        t64, hit64, _, _ = pt.tri_trace_brute(tr[None].double(), o_rays[None].double(),
                                              d[None].double(), MAX_DEPTH)
        out[off] = (tr, tuple(torch.tensor(x) for x in o), d, t64[0], hit64[0])
    return out


@pytest.mark.parametrize("offset", [0.0, 20.0, 40.0])
def test_three_pass_volumes_match_float64(offset, grid_cases):
    tr, o, d, t64, hit64 = grid_cases[offset]
    t, hit = tk.sv_first_hit_tf32(tr, o, d, MAX_DEPTH)
    assert torch.equal(hit, hit64) and float(hit.double().mean()) > 0.3
    assert float((t.double() - t64).abs()[hit].max()) <= T_TOL
    # the same function as the plain version of mode "mx" (full float32)
    o_c, d_c = (x.T[:, None].contiguous() for x in (torch.stack(o).expand_as(d), d))
    lists = pt.block_lists(tr[None], o_c, d_c, MAX_DEPTH, tr.shape[0], RES, False)
    t_p, hit_p, _ = tk.tri_first_hit(tr[None], lists, o_c, d_c, MAX_DEPTH, "sv_cam", 1, "mx")
    assert torch.equal(hit_p[0], hit)
    assert float((t_p[0] - t).abs()[hit].max()) <= 1e-4


@pytest.mark.parametrize("offset", [0.0, 40.0])
def test_one_tf32_pass_misses_the_limit(offset, grid_cases):
    tr, o, d, t64, hit64 = grid_cases[offset]
    t, hit = tk.sv_first_hit_tf32(tr, o, d, MAX_DEPTH, passes=1)
    both = hit & hit64
    assert float((t.double() - t64).abs()[both].max()) > 100 * T_TOL


def _first_strict_min(tk_row):
    best, pos = tk.BIG, -1
    for p, t in enumerate(tk_row):
        if t < best:
            best, pos = t, p
    return best, pos


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quad_merge_is_the_first_strict_minimum(seed):
    """Lane c of a quad walks the positions p with (p mod 8) // 2 == c in
    order with a strict less-than; the quad merges by (t, position), the
    smaller position winning a tie: the sequential walk's winner on rows full
    of exact ties."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, 6, size=(200, 3 * 128)).astype(np.float64)
    rows[rng.random(rows.shape) < 0.7] = tk.BIG  # slots that accept nothing
    for row in rows:
        lanes = []
        for c in range(4):
            best, pos = tk.BIG, -1
            for p in range(row.size):
                if (p % 8) // 2 == c and row[p] < best:
                    best, pos = row[p], p
            lanes.append((best, pos))
        t, p = lanes[0]
        for t2, p2 in lanes[1:]:
            if p2 >= 0 and (t2 < t or (t2 == t and p2 < p)):
                t, p = t2, p2
        assert (t, p) == _first_strict_min(row)


def _lists(chunk, start=None):
    """One scene of one tile whose padded list has two stages of ``chunk``
    triangles, one block a stage."""
    return tk.TileLists(torch.zeros((1, 1, 2), dtype=torch.int32),
                        torch.full((1, 1), 2, dtype=torch.int32), torch.zeros((1, 1, 2)),
                        chunk, chunk, start)


@pytest.mark.parametrize("case", ["chunk16", "split", "sv_tile", "worklist"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    tris = torch.zeros((1, 256, 9))
    o = torch.zeros((3, 1, tk.TILE))
    d = torch.ones((3, 1, tk.TILE))
    kw = dict(form="sv_cam", mode="mx")
    lists = _lists(32)
    match = {"chunk16": "multiple of 32", "split": "one block", "sv_tile": "per-camera",
             "worklist": "per-camera"}[case]
    if case == "chunk16":
        lists = _lists(16)
    elif case == "split":
        kw["split"] = 2
    elif case == "sv_tile":
        kw["form"] = "sv_tile"
    else:
        lists = tk.TileLists(torch.zeros((1, 2), dtype=torch.int32),
                             torch.full((1, 1), 2, dtype=torch.int32), torch.zeros((1, 2)), 32,
                             32, torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        tk.tri_first_hit(tris, lists, o, d, MAX_DEPTH, **kw)
    if case == "chunk16":  # a multiple of 32 passes the same checks
        t, hit, gid = tk.tri_first_hit(tris, _lists(32), o, d, MAX_DEPTH, **kw)
        assert not bool(hit.any()) and bool((t == MAX_DEPTH).all())
