"""The triangle kernel's split of a tile over a cluster of ``k`` blocks and
its deferred Möller–Trumbore division, through the plain version
(``visfly_tpu_torch/render/tri_kernel.py``), which walks, exchanges and
merges exactly as ``csrc/tri_trace.cu`` does.

- Every ``k`` gives the ``k = 1`` result: t and hit equal to the bit, ids
  equal where the ray hits (a miss keeps whatever id its walk last held), for
  both bodies and every list mode (padded per-triangle lists, block lists,
  the CSR worklist, the merged output), on a grid of cubes with a wall in
  front of part of it, so that the early-out and the exchange skip stages.
- The deferred division rejects only tests that the former formula rejects:
  on random and degenerate triangles the test equals the former formula to
  the bit, and its sign gate never rejects a quotient that rounds to ±0.
- The soup and per-camera tiers at the ``k`` the wrapper picks on an H100
  (132 SMs, 4 blocks an SM) still match ``visfly_tpu``, whose Pallas kernels
  run in interpret mode as in ``tests/test_torch_tri_trace.py``.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import visfly_tpu.render.tri_trace as jt
from test_torch_tri_trace import (T, _assert_matches_brute, assert_same_image,  # noqa: F401
                                  both_packages, camera_rays, comp, cube_grid, interpret_pallas,
                                  random_rays)
from visfly_tpu_torch.render import tri_kernel as tk
from visfly_tpu_torch.render import tri_trace as pt

torch.set_num_threads(1)

MAX_DEPTH = 20.0
RES = 32
# resident blocks of an H100 at 4 blocks an SM, for every cluster size
H100_SLOTS = {k: 132 * 4 for k in range(1, tk.MAX_SPLIT + 1)}


@pytest.fixture(scope="module")
def walled():
    """(tris, o_c, d_c): the 2,304-triangle cube grid and a wall below it,
    seen by two 32×32 cameras (2 tiles): one sees the cubes and the wall's top
    edge, the other, under the grid, only the wall."""
    v, f = cube_grid()
    wall = np.asarray([[0.5, -3, -6], [0.5, 3, -6], [0.5, 3, 0.0], [0.5, -3, 0.0]], np.float32)
    f = np.concatenate([f, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32) + len(v)])
    tris = T(pt.pack_triangles(np.concatenate([v, wall]), f)[None])
    o_c, d_c = (T(x) for x in camera_rays([[-2.03, 0.011, 1.017], [-0.5, 0.3, -3.0]],
                                          [[0, 0.013, 0.021], [0, 0.0, 0.1]], res=(RES, RES)))
    return tris, o_c, d_c


# list mode → (lists, form, origin_tiles, mode)
def lists_of(kind, tris, o_c, d_c):
    n_tris = tris.shape[1]
    if kind == "padded_mt":
        return pt.tile_lists(tris, o_c, d_c, MAX_DEPTH, 1024, None, False), "mt", 1, "scalar"
    if kind == "padded_sv":
        return pt.tile_lists(tris, o_c, d_c, MAX_DEPTH, 1024, RES, False), "sv_tile", 1, "scalar"
    blocks = pt.block_lists(tris, o_c, d_c, MAX_DEPTH, n_tris, RES, False)
    if kind == "block_mt":
        return blocks, "mt", 1, "scalar"
    if kind == "block_sv":
        return blocks, "sv_cam", 1, "scalar"
    if kind == "merged":
        return blocks, "sv_cam", 1, "merged"
    return (pt.worklist_lists(tris, o_c, d_c, MAX_DEPTH, n_tris, RES, False, 6), "sv_tile", 1,
            "scalar")


KINDS = ["padded_mt", "padded_sv", "block_mt", "block_sv", "merged", "csr"]


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_split_walk_gives_the_sequential_result(kind, k, walled):
    tris, o_c, d_c = walled
    lists, form, origin_tiles, mode = lists_of(kind, tris, o_c, d_c)
    s1, sk = {}, {}
    one = tk.tri_first_hit_reference(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                     stats=s1, mode=mode)
    out = tk.tri_first_hit_reference(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                     stats=sk, mode=mode, split=k)
    hit = one[1]
    assert torch.equal(out[0], one[0]) and torch.equal(out[1], one[1])
    assert torch.equal(out[2][hit], one[2][hit])
    assert 0.2 < float(hit.float().mean()) < 1.0
    # the same stages in all; the early-out skipped some, and the exchange
    # keeps the split within a round of the sequential walk
    padded = tk.padded_lists(lists)
    assert bool((s1["stages"] < padded.n_stage).any())
    assert bool((sk["stages"] <= torch.minimum(padded.n_stage, s1["stages"] + k)).all())
    # the wrapper on CPU tensors takes the same walk
    wrapped = tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles, mode,
                               count_stages=True, split=k)
    assert all(torch.equal(a, b) for a, b in zip(wrapped[:3], out))
    assert torch.equal(wrapped[3], sk["stages"])


@pytest.mark.parametrize("kind", ["block_mt", "block_sv"])
def test_split_merges_ties_by_list_position(kind, walled):
    """Lists that hold every block twice: each triangle is met at two list
    positions with the same t, in different blocks of the cluster for odd
    ``k``, and the first position's id wins as in the sequential walk."""
    tris, o_c, d_c = walled
    lists, form, origin_tiles, mode = lists_of(kind, tris, o_c, d_c)
    twice = lists._replace(ids=torch.cat([lists.ids, lists.ids], -1).contiguous(),
                           lb=torch.cat([lists.lb, lists.lb], -1).contiguous(),
                           n_stage=(lists.n_stage + lists.lb.shape[-1]).to(torch.int32))
    one = tk.tri_first_hit_reference(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles)
    for k in (1, 3):
        out = tk.tri_first_hit_reference(tris, twice, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                         split=k)
        assert torch.equal(out[0], one[0]) and torch.equal(out[2][one[1]], one[2][one[1]])


def _test_mt_former(rows, o, d):
    """The Möller–Trumbore test as the kernel computed it before the division
    was deferred: divide past the determinant gate, then test the signs."""
    a = tuple(rows[..., i, None] for i in (0, 1, 2))
    e1 = tuple(rows[..., i + 3, None] - rows[..., i, None] for i in range(3))
    e2 = tuple(rows[..., i + 6, None] - rows[..., i, None] for i in range(3))
    p = tk._cross(d, e2)
    det = tk._dot(e1, p)
    okd = det.abs() > 1e-9
    inv = 1.0 / torch.where(okd, det, 1.0)
    tv = tk._sub(o, a)
    u = tk._dot(tv, p) * inv
    q = tk._cross(tv, e1)
    v = tk._dot(d, q) * inv
    tk_ = tk._dot(e2, q) * inv
    ok = okd & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tk_ > 1e-4)
    return torch.where(ok, tk_, tk.BIG), okd


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deferred_division_equals_the_former_formula(seed):
    """Random triangles, slivers, triangles in the ray's plane and ones whose
    determinant sits at the 1e-9 gate, at scales from 1e-4 to 1e4 m."""
    rng = np.random.default_rng(seed)
    n, r = 512, 256
    rows = rng.normal(size=(n, 9)) * 10.0 ** rng.uniform(-4, 4, size=(n, 1))
    rows[:64, 6:9] = rows[:64, 0:3] + 1e-6 * rng.normal(size=(64, 3))  # slivers
    rows[64:96, 3:9] = rows[64:96, 0:3].repeat(2, 1)  # points
    rows[96:128, 2::3] = 0.0  # in the plane z = 0 of the rays below
    o = rng.normal(size=(3, 1, r)) * 3.0
    d = rng.normal(size=(3, 1, r))
    d[2, 0, :32] = 0.0
    d = d / np.linalg.norm(d, axis=0, keepdims=True)
    rows_t = torch.from_numpy(rows.astype(np.float32))[:, None, :]  # (n, 1, 9)
    o_t = tuple(torch.from_numpy(o.astype(np.float32)))
    d_t = tuple(torch.from_numpy(d.astype(np.float32)))
    # scale rows 128..160 so that |det| lands on the gate for ray 0
    det0 = tk._dot(tuple(rows_t[..., i + 3] - rows_t[..., i] for i in range(3)),
                   tk._cross(tuple(x[:, :1] for x in d_t),
                             tuple(rows_t[..., i + 6] - rows_t[..., i] for i in range(3))))
    scale = (1e-9 / det0[128:160].abs().clamp(min=1e-30)) ** 0.5
    rows_t[128:160] = rows_t[128:160] * scale[..., None].to(torch.float32)
    t_new, gate_new, divide = tk._test_mt(rows_t, o_t, d_t)
    t_old, gate_old = _test_mt_former(rows_t, o_t, d_t)
    assert torch.equal(t_new, t_old) and torch.equal(gate_new, gate_old)
    assert bool((divide <= gate_new).all()) and bool(((t_new < tk.BIG) <= divide).all())
    assert int(divide.sum()) < 0.5 * int(gate_new.sum())  # most tests no longer divide
    assert bool((t_new < tk.BIG).any())
    near = (det0[128:160].abs() * scale[:, 0] ** 2 - 1e-9).abs() < 1e-10
    assert bool(near.any())


def test_sign_gate_rejects_only_negative_quotients():
    """Over numerators and determinants from the smallest subnormal to the
    largest float, ±0, ±inf and NaN: where the gate says no, the former
    ``un · (1/det) >= 0`` is false, also where the quotient underflows."""
    mags = [0.0, 1.4e-45, 1e-40, 1.2e-38, 1e-30, 1e-20, 1e-9, 1.1e-9, 1e-3, 0.5, 1.0, 3.0, 8.0,
            1e5, 1e20, 1e30, 3.4e38, float("inf"), float("nan")]
    vals = torch.tensor([s * m for m in mags for s in (1.0, -1.0)], dtype=torch.float32)
    un, det = torch.meshgrid(vals, vals, indexing="ij")
    gated = det.abs() > 1e-9
    inv = 1.0 / torch.where(gated, det, 1.0)
    former = (un * inv >= 0.0) & gated
    passed = tk._mt_signs_pass(un, torch.zeros_like(un), det) & gated
    assert bool((former <= passed).all())
    # it does reject: a sign that differs at a magnitude past |det|·2⁻¹²⁵
    assert int((gated & ~passed).sum()) > 0.3 * int((gated & ~former).sum())
    # the underflow the gate must let through: −1e-42 · (1/1e5) rounds to −0
    un0, det0 = torch.tensor([-1e-42]), torch.tensor([1e5])
    assert float(un0 * (1.0 / det0)) == 0.0 and bool(tk._mt_signs_pass(un0, un0 * 0, det0))


@pytest.mark.parametrize("n_tiles,n_stage,per_sm,want", [
    (576, 45, 3, 2), (1024, 45, 5, 2), (1024, 45, 2, 1), (576, 4, 3, 2), (1024, 4, 5, 2),
    (1024, 2, 4, 2), (4, 18, 4, 8), (100_000, 45, 4, 1), (8, 1, 4, 1)])
def test_pick_split(n_tiles, n_stage, per_sm, want):
    """The least k whose grid fills the card SPLIT_ROUNDS times, capped at the
    list length and the cluster limit: B5's 576 tiles and B6's 1,024 of path D
    at 23,040 triangles on an H100 (3 and 5 blocks an SM, and at 2), B4's
    lists of at most 4 stages at 360 triangles, short lists, few tiles, many
    tiles."""
    slots = {k: 132 * per_sm for k in range(1, tk.MAX_SPLIT + 1)}
    assert tk.pick_split(n_tiles, n_stage, slots) == want


def test_wrapper_checks_the_split(walled):
    tris, o_c, d_c = walled
    lists, form, origin_tiles, _ = lists_of("block_sv", tris, o_c, d_c)
    with pytest.raises(ValueError, match="split"):
        tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles, split=9)
    with pytest.raises(ValueError, match="split"):
        tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles, split=0)
    with pytest.raises(ValueError, match="one block"):
        tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles, "mx", split=2)
    # on the CPU the wrapper walks as one block unless told otherwise; its
    # count is the list walk's, whose blocks take 512 of a tile's rays each
    s = {}
    plain = tk.tri_first_hit_reference(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                       stats=s, block_rays=tk.TILE_BLOCK_RAYS)
    *out, stages = tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                    count_stages=True)
    assert all(torch.equal(a, b) for a, b in zip(out, plain)) and torch.equal(stages, s["stages"])


def _at_card_split(tris, lists, o_c, d_c, *args, **kw):
    """The wrapper with the split it picks on an H100 for these lists."""
    tiles = lists.n_stage.numel()
    kw["split"] = tk.pick_split(tiles, lists.lb.shape[-1], H100_SLOTS)
    assert kw["split"] > 1
    return tk.tri_first_hit(tris, lists, o_c, d_c, *args, **kw)


def test_camera_soup_tier_at_the_card_split_matches_jax(interpret_pallas, monkeypatch):
    """The per-camera tier (``test_camera_soup_tier_matches_jax``) at the
    wrapper's split for an H100."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]])
    with mock.patch.object(pt, "tri_first_hit", _at_card_split):
        out_p, out_j = both_packages(tris, o_c, d_c, tris.shape[1] - 1, monkeypatch,
                                     cap=tris.shape[1], img_w=64, cam_rays=64 * 64)
    assert_same_image(out_p, out_j, tris, o_c, d_c, tol=1e-3)
    _assert_matches_brute(out_p, tris, o_c, d_c, tol=1e-3)


def test_soup_tier_at_the_card_split_matches_jax(interpret_pallas, monkeypatch):
    """The soup tier, Möller–Trumbore over block lists
    (``test_two_scenes_soup_tier_matches_jax``), at the wrapper's split for an
    H100, on two scenes."""
    v1, f1 = cube_grid(8, 8, 3)
    v2, f2 = cube_grid(8, 6, 3)
    p1, p2 = pt.pack_triangles(v1, f1), pt.pack_triangles(v2, f2)
    tris = np.zeros((2, max(len(p1), len(p2)), 9), np.float32)
    tris[0, :len(p1)] = p1
    tris[1, :len(p2)] = p2
    o1, d1 = random_rays(1024, seed=21, origin=(-4.0, 0.0, 1.0))
    o2, d2 = random_rays(1024, seed=22, origin=(-4.0, 0.0, 0.5))
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    with mock.patch.object(pt, "tri_first_hit", _at_card_split):
        out_p, out_j = both_packages(tris, comp(o), comp(d), tris.shape[1] - 1, monkeypatch,
                                     cap=tris.shape[1])
    assert_same_image(out_p, out_j, tris, comp(o), comp(d))
    _assert_matches_brute(out_p, tris, comp(o), comp(d))
    ref = jt.tri_trace_xla(jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(out_p[1].numpy(), np.asarray(ref[1]))


def test_count_stages_sums_the_blocks(walled):
    """The stage count of a split walk is the sum over a tile's blocks, and
    the B8a diagnostic's count is the list walk's, as the wrapper's without a
    split."""
    tris, o_c, d_c = walled
    lists, form, origin_tiles, _ = lists_of("block_mt", tris, o_c, d_c)
    *_, one = tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                               count_stages=True)
    st = pt.stage_stats(tris, o_c, d_c, MAX_DEPTH, None, RES)
    assert torch.equal(st["stages"], one)
    forced = lists._replace(lb=torch.zeros_like(lists.lb))
    for k in (2, 4):
        *_, all_k = tk.tri_first_hit(tris, forced, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                     count_stages=True, split=k)
        assert torch.equal(all_k, lists.n_stage)
