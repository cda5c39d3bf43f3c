"""B4, the tile tiers of the exact-triangle tracer (``render/tri_kernel.py``
and ``render/tri_trace.py``), on ragged lists, and what the host hands the
tile kernel (``csrc/tri_tile.cu``).

- The plain tile tiers, both bodies, against ``visfly_tpu``'s
  ``tri_trace_pallas`` in interpret mode on a scene whose camera tiles keep
  0, 64, 65, the cap's 128 and 1 triangles: an empty tile, a count on a stage
  boundary and one a slot past it, a tile at the cap, one triangle. Limits as
  ``tests/test_torch_tri_trace.py``: hit flags equal, |Δt| ≤ 1e-4 m, ids
  equal where the best t is unique.
- The routing rule (:func:`tile_route`): which calls go to the tile kernel
  and which to the cluster walk.
- The real counts and the tile order that ``tile_lists`` hands the kernel
  equal their definitions on per-triangle and cluster lists, and a plain
  walk of the tile kernel over them (rays in blocks of ``TILE_BLOCK_RAYS``,
  each with its own early-out vote, over the real slots only) equals
  ``tri_first_hit_reference`` to the bit: t and hit, and the id of every ray
  that hits.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import visfly_tpu.render.tri_trace as jt
from test_torch_tri_trace import (T, assert_same_image, camera_rays, cube_grid,  # noqa: F401
                                  interpret_pallas)
from visfly_tpu_torch.render import tri_kernel as tk
from visfly_tpu_torch.render import tri_trace as pt

torch.set_num_threads(1)

TILE = 1024
MAX_DEPTH = 10.0
CAP = 128  # two stages of 64
GROUPS = (0, 64, 65, 140, 1)  # triangles in front of each camera; 140 is past the cap
RAGGED = (0, 64, 65, CAP, 1)  # the real slots each camera's tile keeps


def ragged_scene(seed=0):
    """(tris (1, T, 9), o_c, d_c (3, 1, 5 · 1024)): five 32×32 cameras 100 m
    apart along y, looking along +x with a field of view of ±0.5 rad, each
    before its own group of ``GROUPS[g]`` small triangles between 2 and 9 m
    away. Within ``MAX_DEPTH`` a camera's rays reach its own group only, and
    no triangle of the group lies wholly outside its view: the cull keeps
    exactly the group."""
    rng = np.random.default_rng(seed)
    tris, origins, dirs = [], [], []
    half = np.tan(0.5) * ((np.arange(32) + 0.5) / 16.0 - 1.0)
    for g, n in enumerate(GROUPS):
        cam = np.asarray([0.0, 100.0 * g, 0.0], np.float32)
        x = rng.uniform(2.0, 9.0, n)
        centre = np.stack([x, rng.uniform(-0.3, 0.3, n) * x / 2, rng.uniform(-0.3, 0.3, n) * x / 2],
                          -1) + cam
        size = 0.25 if n > 1 else 0.8  # the lone triangle large enough to be seen
        corners = rng.uniform(-size, size, (n, 3, 3)) * [0.2, 1.0, 1.0]
        tris.append((centre[:, None] + corners).reshape(n, 9))
        zz, yy = np.meshgrid(-half, half, indexing="ij")  # row-major: rows down, columns across
        d = np.stack([np.ones_like(yy), yy, zz], -1).reshape(TILE, 3)
        dirs.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
        origins.append(np.broadcast_to(cam, (TILE, 3)))
    rows = pt.pack_triangles(np.concatenate(tris).reshape(-1, 3).astype(np.float32),
                             np.arange(3 * sum(GROUPS), dtype=np.int32).reshape(-1, 3))
    o = np.concatenate(origins).astype(np.float32)
    d = np.concatenate(dirs).astype(np.float32)
    return (rows[None], np.ascontiguousarray(o.T[:, None]), np.ascontiguousarray(d.T[:, None]))


@pytest.fixture(scope="module")
def ragged():
    return ragged_scene()


@pytest.fixture(scope="module")
def grid_scene():
    """The 2,304-triangle cube grid (cluster lists) seen by a 64×64 camera,
    repacked into four 32×32 tiles as the render does."""
    v, f = cube_grid()
    tris = T(pt.pack_triangles(v, f)[None])
    o_c, d_c = (T(x) for x in camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]]))
    plan = pt.plan_tiles(tris, o_c, d_c, 20.0, 1088, 64, 64 * 64)
    return tris, plan


# ---------------------------------------------------------------------------
# the plain tile tiers against the interpret-mode Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("img_w", [32, None], ids=["signed_volumes", "moller_trumbore"])
def test_ragged_tile_tier_matches_jax(interpret_pallas, ragged, img_w):
    """Each body on the five ragged tiles: the port's lists hold the counts
    the scene was built for, and its image equals the JAX kernel's."""
    tris, o_c, d_c = ragged
    lists = pt.tile_lists(T(tris), T(o_c), T(d_c), MAX_DEPTH, CAP, img_w, False)
    assert lists.count.flatten().tolist() == list(RAGGED)
    assert lists.n_stage.flatten().tolist() == [1, 1, 2, 2, 1]
    assert (lists.chunk, lists.ids.shape[-1]) == (64, CAP)
    out_j = jt.tri_trace_pallas(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c), MAX_DEPTH,
                                cap=CAP, img_w=img_w)
    tk.reset_launches()
    out_p = pt.tri_trace_tiled(T(tris), T(o_c), T(d_c), MAX_DEPTH, cap=CAP, img_w=img_w)
    assert sum(tk.LAUNCHES.values()) == 0
    assert_same_image(out_p, out_j, tris, o_c, d_c)
    hit = out_p[1].reshape(5, TILE).float().mean(-1)
    assert float(hit[0]) == 0.0 and bool((hit[1:] > 0).all())  # only the empty tile sees nothing


# ---------------------------------------------------------------------------
# the routing rule
# ---------------------------------------------------------------------------


def _lists(block=1, start=False):
    z = torch.zeros((1, 1, 2), dtype=torch.int32)
    return tk.TileLists(z.reshape(1, 1, 2) if not start else z.reshape(1, 2),
                        torch.ones((1, 1), dtype=torch.int32), torch.zeros((1, 1, 1)),
                        2 * block if block > 1 else 2, block,
                        torch.zeros((1, 1), dtype=torch.int32) if start else None)


@pytest.mark.parametrize("form,lists,kw,want", [
    ("sv_tile", _lists(), {}, True),
    ("mt", _lists(), {}, True),
    ("mt", _lists(block=64), {}, False),  # the soup tier, B5
    ("sv_cam", _lists(block=64), {}, False),  # the per-camera tier, B6
    ("sv_cam", _lists(block=64), {"mode": "merged"}, False),  # B7a
    ("sv_cam", _lists(block=64), {"mode": "mx"}, False),  # B7b
    ("sv_tile", _lists(start=True), {}, False),  # the worklist, B7c
    ("sv_tile", _lists(), {"count_stages": True}, True),  # with the stage count, B8a
    ("mt", _lists(), {"knockout": True}, False),
    ("sv_tile", _lists(), {"split": 1}, False),  # the cluster walk asked for
    ("mt", _lists(), {"split": 2}, False),
])
def test_tile_route(form, lists, kw, want):
    assert tk.tile_route(form, lists, **kw) is want


def test_launch_entries():
    """The two tile entries name the tile tiers; the cluster walk on their
    lists counts apart."""
    assert tk.count_name("sv_tile", 1) == "tri_trace_tile_sv"
    assert tk.count_name("mt", 1) == "tri_trace_tile_mt"
    assert tk.count_name("mt", 128) == "tri_trace_soup"
    assert "tri_trace_tile_cluster" in tk.LAUNCHES
    tk.reset_launches()
    assert set(tk.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# what the host hands the tile kernel
# ---------------------------------------------------------------------------


def _kept_per_slot(tris, o_c, d_c, cap, img_w, max_depth):
    """The cull's own record, slot by slot: a slot keeps a triangle the cull
    saw where its bound is finite (inactive slots carry BIG)."""
    ids, counts, lb = pt.tri_cull_compact(tris, o_c, d_c, max_depth, cap, img_w, False)
    return (lb < pt.BIG).sum(-1).to(torch.int32), torch.clamp(counts, max=ids.shape[-1])


@pytest.mark.parametrize("which", ["per_triangle", "clusters"])
def test_counts_and_order_match_their_definitions(which, ragged, grid_scene):
    """``count`` is the triangles the cull kept, at most the cap: the count of
    slots with a finite bound; the slots before it all hold one. ``order`` is
    the tiles by count, most first, index order among equals."""
    if which == "per_triangle":
        tris, o_c, d_c = (T(x) for x in ragged)
        lists = pt.tile_lists(tris, o_c, d_c, MAX_DEPTH, CAP, 32, False)
        finite, counts = _kept_per_slot(tris, o_c, d_c, CAP, 32, MAX_DEPTH)
    else:
        tris, plan = grid_scene
        lists = plan.lists
        assert (lists.chunk, lists.block, plan.form) == (128, 1, "sv_tile")
        finite, counts = _kept_per_slot(tris, plan.origins_c, plan.dirs_c, 1088, 32, 20.0)
    assert lists.count.dtype == torch.int32 and lists.count.is_contiguous()
    assert torch.equal(lists.count, counts) and torch.equal(lists.count, finite)
    pos = torch.arange(lists.ids.shape[-1])
    inside = pos < lists.count[..., None]
    assert bool((lists.ids[inside] >= 0).all())
    assert bool((lists.count <= lists.n_stage * lists.chunk).all())
    order = lists.order.long()
    assert order.dtype == torch.int64 and sorted(order.tolist()) == list(range(order.numel()))
    c = lists.count.flatten()[order]
    assert bool((c[1:] <= c[:-1]).all())
    ties = c[1:] == c[:-1]
    assert bool((order[1:][ties] > order[:-1][ties]).all())
    assert torch.equal(lists.order, tk.longest_first(lists.count))


def test_real_counts_from_the_ids():
    """Without a count, the walk ends one past the last slot that holds a
    triangle within the tile's stages; ids past ``T`` and stages past
    ``n_stage`` hold none."""
    ids = torch.full((1, 4, 8), -1, dtype=torch.int32)
    ids[0, 1, :3] = torch.tensor([5, 2, 7])
    ids[0, 2, :6] = torch.tensor([1, -1, 3, 0, 9, 4])  # a hole at 1; 9 is no triangle (T = 9)
    ids[0, 3, :] = torch.arange(8)  # stage 1 lies past n_stage
    lists = tk.TileLists(ids, torch.tensor([[1, 1, 2, 1]], dtype=torch.int32),
                         torch.zeros((1, 4, 2)), 4, 1)
    assert tk.real_counts(lists, 9).tolist() == [[0, 3, 6, 4]]
    lists = lists._replace(count=torch.tensor([[0, 2, 2, 1]], dtype=torch.int32))
    assert tk.real_counts(lists, 9) is lists.count


def test_wrapper_checks_count_and_order(ragged):
    tris, o_c, d_c = (T(x) for x in ragged)
    lists = pt.tile_lists(tris, o_c, d_c, MAX_DEPTH, CAP, 32, False)
    with pytest.raises(ValueError, match="count"):
        tk.tri_first_hit(tris, lists._replace(count=lists.count[:, :2]), o_c, d_c, MAX_DEPTH,
                         "sv_tile")
    with pytest.raises(ValueError, match="order"):
        tk.tri_first_hit(tris, lists._replace(order=lists.order[:2]), o_c, d_c, MAX_DEPTH,
                         "sv_tile")
    with pytest.raises(TypeError):
        tk.tri_first_hit(tris, lists._replace(order=lists.order.long()), o_c, d_c, MAX_DEPTH,
                         "sv_tile")


def tile_walk(tris, lists, o_c, d_c, max_depth, form):
    """A plain walk of the tile kernel → (t, hit, gid): each block of
    ``TILE_BLOCK_RAYS`` rays of a tile walks the tile's real slots
    (:func:`real_counts`) stage by stage, its own rays voting on each stage's
    bound, with its own running best and list position a ray (the blocks
    launch in ``lists.order``, which changes no ray's result)."""
    _, S, R = o_c.shape
    n_tris = tris.shape[1]
    block, chunk, n_stage = tk.TILE_BLOCK_RAYS, lists.chunk, lists.lb.shape[-1]
    counts = tk.real_counts(lists, n_tris)
    t = torch.empty((S, R))
    gid = torch.zeros((S, R), dtype=torch.int32)
    for s in range(S):
        for ti in range(R // TILE):
            n_real = min(int(counts[s, ti]), min(int(lists.n_stage[s, ti]), n_stage) * chunk)
            for r0 in range(ti * TILE, (ti + 1) * TILE, block):
                d = tuple(d_c[i, s, None, r0:r0 + block] for i in range(3))  # (1, block)
                o = (tuple(o_c[i, s, None, r0:r0 + block] for i in range(3)) if form == "mt"
                     else tuple(o_c[i, s, ti * TILE] for i in range(3)))
                tbest = torch.full((block,), tk.BIG)
                pbest = torch.full((block,), -1, dtype=torch.int64)
                for ci in range(-(-n_real // chunk)):
                    if not bool((lists.lb[s, ti, ci] < torch.clamp(tbest, max=max_depth)).any()):
                        continue
                    ids = lists.ids[s, ti, ci * chunk:min((ci + 1) * chunk, n_real)].long()
                    real = (ids >= 0) & (ids < n_tris)
                    rows = torch.where(real[:, None], tris[s, torch.where(real, ids, 0)], 0.0)
                    if form == "mt":
                        tk_ = tk._test_mt(rows, o, d)[0]
                    else:
                        g0, g1, g2, kt = tk.sv_coefficients(rows, o)
                        tk_ = tk._test_sv((*(tuple(x[:, None] for x in g) for g in (g0, g1, g2)),
                                           kt[:, None]), d)[0]
                    best, j = torch.min(tk_, dim=0)
                    better = best < tbest
                    pbest = torch.where(better, ci * chunk + j, pbest)
                    tbest = torch.where(better, best, tbest)
                t[s, r0:r0 + block] = torch.clamp(tbest, 0.0, max_depth)
                at = lists.ids[s, ti, torch.clamp(pbest, min=0)]
                gid[s, r0:r0 + block] = torch.where(pbest >= 0, at, 0)
    return t, t < max_depth, gid


def _same(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][b[1]], b[2][b[1]]))


@pytest.mark.parametrize("which,form", [("per_triangle", "sv_tile"), ("per_triangle", "mt"),
                                        ("clusters", "sv_tile"), ("clusters", "mt")])
def test_tile_walk_equals_the_reference(which, form, ragged, grid_scene):
    """The tile kernel's walk over the real slots, block by block, is the
    sequential walk of every slot to the bit, on ragged per-triangle lists
    and on cluster lists whose last stage holds culled clusters."""
    if which == "per_triangle":
        tris, o_c, d_c = (T(x) for x in ragged)
        lists = pt.tile_lists(tris, o_c, d_c, MAX_DEPTH, CAP, 32 if form == "sv_tile" else None,
                              False)
        depth = MAX_DEPTH
    else:
        tris, plan = grid_scene
        lists, o_c, d_c, depth = plan.lists, plan.origins_c, plan.dirs_c, 20.0
        # a tile whose count ends inside its last stage: culled slots follow
        assert bool(((lists.count % lists.chunk) != 0).any())
    args = (tris, lists, o_c, d_c, depth, form)
    ref = tk.tri_first_hit_reference(*args)
    walk = tile_walk(*args)
    assert _same(walk, ref) and float(ref[1].float().mean()) > 0.02
    # the same lists with the counts derived from the ids walk more slots
    # (the culled ones of the last stage) and give the same result
    assert _same(tile_walk(tris, lists._replace(count=None), *args[2:]), ref)


def test_tile_walk_on_emptied_slots(ragged):
    """Lists whose slots past each tile's count are emptied, as the smoke's
    synthetic set is cut: the tile walk, the reference on them and on the
    lists they were cut from agree, with the counts handed or derived."""
    tris, o_c, d_c = (T(x) for x in ragged)
    lists = pt.tile_lists(tris, o_c, d_c, MAX_DEPTH, CAP, 32, False)
    pos = torch.arange(lists.ids.shape[-1])
    cut = lists._replace(ids=torch.where(pos < lists.count[..., None], lists.ids, -1))
    args = (o_c, d_c, MAX_DEPTH, "sv_tile")
    ref = tk.tri_first_hit_reference(tris, lists, *args)
    assert _same(tk.tri_first_hit_reference(tris, cut, *args), ref)
    assert torch.equal(tk.real_counts(cut._replace(count=None), tris.shape[1]), cut.count)
    assert _same(tile_walk(tris, cut, *args), ref)
    assert _same(tile_walk(tris, cut._replace(count=None), *args), ref)
