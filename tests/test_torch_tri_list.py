"""B7a and B7c, the merged and worklist tiers of the exact-triangle tracer,
through the list walk (``csrc/tri_tile.cu``), and what the host hands it
(``render/tri_kernel.py``, ``render/tri_trace.py``).

- The routing rule (:func:`list_route`, beside :func:`tile_route`): the
  merged per-camera tier and CSR lists go to the list walk, with the stage
  count (CSR lists) and the knock-outs (the merged tier); B6 (scalar), B5
  (the soup), the matrix form and an explicit ``split`` do not, nor does the
  merged tier's count (``tests/test_torch_tri_diag.py`` has the rest of the
  diagnostics' rule).
- The real counts and the tile order that the plan hands B7a's block lists
  and ``worklist_lists`` B7c's equal their definitions, and the counts
  derived from the ids (:func:`real_counts`) agree with them; B6's block
  lists carry neither.
- A plain walk of the list walk (tiles in ``lists.order``, rays in blocks of
  256 or 512 or 1,024, each block voting on its own rays, over the real slots
  only, entries of 16 or 128 triangles, CSR and padded lists, the camera's
  origin and the merged output) equals ``tri_first_hit_reference`` to the bit
  on ragged lists: t and hit, and the id of every ray that hits.
- The merged and worklist variants, whose lists now carry ``count`` and
  ``order``, against the JAX kernels ``_tri_trace_pallas_camsoup_v2`` and
  ``_tri_trace_pallas_worklist`` in interpret mode; tolerances as
  ``tests/test_torch_tri_variants.py`` (hit flags equal, |Δt| ≤ 1e-3 m, ids
  equal where the best t is unique).
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import visfly_tpu.render.tri_trace as jt
from test_torch_tri_trace import (T, _assert_matches_brute, assert_same_image,  # noqa: F401
                                  camera_rays, cube_grid, interpret_pallas)
from visfly_tpu_torch.render import tri_kernel as tk
from visfly_tpu_torch.render import tri_trace as pt

torch.set_num_threads(1)

TILE = 1024
MAX_DEPTH = 20.0
RES = 64
CAMS = ([[-2.03, 0.011, 1.017], [-1.2, -6.5, 0.6]], [[0, 0.013, 0.021], [0, 0.05, 0.7]])


@pytest.fixture(scope="module")
def grid():
    """(tris (1, 2304, 9), o_c, d_c (3, 1, 2 · 4096)) as numpy: the cube grid
    of ``tests/test_tri_trace.py`` seen by two 64×64 cameras, the first the
    camera of ``test_camsoup_v2_matches_v1``."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays(*CAMS, res=(RES, RES))
    return tris, o_c, d_c


def plan(grid, variant, cams=2, **kw):
    """The per-camera tier's plan on the grid (reached through
    ``soup_min_t``), lists that hold the whole mesh unless ``cap`` says."""
    tris, o_c, d_c = grid
    n = cams * RES * RES
    n_tris = tris.shape[1]
    kw.setdefault("cap", n_tris)
    return pt.plan_tiles(T(tris), T(o_c[:, :, :n]), T(d_c[:, :, :n]), MAX_DEPTH, kw.pop("cap"),
                         RES, RES * RES, soup_min_t=n_tris - 1, variant=variant, **kw)


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
    ("sv_cam", _lists(block=128), {"mode": "merged"}, True),  # B7a
    ("sv_tile", _lists(block=16, start=True), {}, True),  # B7c
    ("sv_cam", _lists(block=128), {}, False),  # B6, the scalar per-camera tier
    ("mt", _lists(block=128), {}, False),  # B5, the soup
    ("sv_cam", _lists(block=128), {"mode": "mx"}, False),  # B7b, the tensor cores
    ("sv_cam", _lists(block=128), {"mode": "merged", "split": 1}, False),  # the cluster walk
    ("sv_tile", _lists(block=16, start=True), {"split": 2}, False),
    ("sv_cam", _lists(block=128), {"mode": "merged", "count_stages": True}, False),  # refused
    ("sv_tile", _lists(block=16, start=True), {"count_stages": True}, True),  # B8a
    ("sv_cam", _lists(block=128), {"mode": "merged", "knockout": True}, True),  # B8b
    ("sv_tile", _lists(), {}, False),  # B4: tile_route's
    ("mt", _lists(), {}, False),
])
def test_list_route(form, lists, kw, want):
    """The list tiers go to the list walk, and never both rules at once."""
    assert tk.list_route(form, lists, **kw) is want
    assert not (want and tk.tile_route(form, lists, **kw))


def test_launch_entries():
    """B7a and B7c keep their entries; the cluster walk on their lists at an
    explicit split counts apart."""
    assert tk.count_name("sv_cam", 128, "merged") == "tri_trace_camsoup_merged"
    assert tk.count_name("sv_tile", 16, worklist=True) == "tri_trace_worklist"
    assert {"tri_trace_list_cluster", "tri_trace_tile_cluster"} <= set(tk.LAUNCHES)
    assert tk.TILE_BLOCK_RAYS == 512
    tk.reset_launches()
    assert set(tk.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# what the host hands the list walk
# ---------------------------------------------------------------------------


def _check_order(lists):
    order = lists.order.long()
    assert lists.order.dtype == torch.int32 and lists.order.is_contiguous()
    assert sorted(order.tolist()) == list(range(order.numel()))
    c = lists.count.flatten()[order]
    assert bool((c[1:] <= c[:-1]).all())
    ties = c[1:] == c[:-1]
    assert bool((order[1:][ties] > order[:-1][ties]).all())
    assert torch.equal(lists.order, tk.longest_first(lists.count))


@pytest.mark.parametrize("cap", [2304, 1024])
def test_block_counts_and_order(grid, cap):
    """B7a: ``count`` is the slots of the blocks the cull kept, at most the
    cap: the stages with a finite bound (an unseen block's is BIG) times
    the block; the slots before it hold blocks. Where a tile sees a block,
    the count derived from the ids is the same; where it sees none, the ids
    give the one stage it owns, which never runs. The scalar tier's lists
    (B6, the cluster walk) come from the same prepass without them."""
    lists = plan(grid, "merged", cap=cap).lists
    assert (lists.chunk, lists.block, lists.start) == (128, 128, None)
    assert lists.count.dtype == torch.int32 and lists.count.is_contiguous()
    seen = (lists.lb < pt.BIG).sum(-1).to(torch.int32)
    assert torch.equal(lists.count, seen * lists.chunk)
    assert bool((lists.count <= lists.n_stage * lists.chunk).all())
    entries = torch.arange(lists.ids.shape[-1])
    assert bool((lists.ids[entries < seen[..., None]] >= 0).all())
    derived = tk.real_counts(lists._replace(count=None), 2304)
    some = lists.count > 0
    assert bool(some.any()) and torch.equal(derived[some], lists.count[some])
    assert torch.equal(derived[~some], lists.n_stage[~some] * lists.chunk)
    _check_order(lists)
    b6 = plan(grid, "scalar", cap=cap).lists
    assert b6.count is None and b6.order is None and torch.equal(b6.ids, lists.ids)
    assert torch.equal(pt.walk_order(b6).count, lists.count)


@pytest.mark.parametrize("budget", [2, 10 ** 6])
def test_worklist_counts_and_order(grid, budget):
    """B7c: ``count`` is the slots of the visible clusters a tile's quota
    holds, every slot before it a cluster and every one after it in the
    tile's stages empty; the count derived from the ids equals it."""
    lists = plan(grid, "wl", work_budget=budget).lists
    per = lists.chunk // lists.block
    assert (lists.chunk, lists.block) == (pt.WL_CHUNK, pt.WL_CLUSTER)
    for (s, ti), c in np.ndenumerate(lists.count.numpy()):
        st, q = int(lists.start[s, ti]), int(lists.n_stage[s, ti])
        own = lists.ids[s, st * per:(st + q) * per]
        n = int((own >= 0).sum())
        assert c == n * lists.block and bool((own[:n] >= 0).all())
    assert torch.equal(tk.real_counts(lists._replace(count=None), 2304), lists.count)
    if budget == 2:  # every quota cut: whole stages
        assert bool((lists.count == lists.n_stage * lists.chunk).all())
    else:  # the last stage part full
        assert bool((lists.count % lists.chunk != 0).any())
    _check_order(lists)


@pytest.mark.parametrize("n_blocks,resident,want", [
    (2048, 660, 1),  # path D's 1,024 tiles: one walk a tile's rays
    (1980, 660, 1),
    (1979, 660, 2),
    (1024, 660, 2),
    (512, 660, 4),  # path F's 256 tiles
    (512, 528, 4),
    (64, 660, 8),  # path T3's 32 tiles: at most MAX_STAGE_PARTS
    (0, 660, 1),
])
def test_stage_parts(n_blocks, resident, want):
    """The list walk splits a tile's stages only where its blocks fill the
    card's resident blocks fewer than three times, and then just enough."""
    assert tk.stage_parts(n_blocks, resident) == want


def test_real_counts_of_entries():
    """Entries of several triangles: a slot is real where its entry is and its
    triangle lies below ``n_tris``; a CSR tile counts in its own stages."""
    ids = torch.full((1, 3, 4), -1, dtype=torch.int32)  # 2 stages of 2 entries of 4
    ids[0, 0, :3] = torch.tensor([0, 5, 1])  # entry 5 holds triangles 20-23: past 22
    ids[0, 1, :2] = torch.tensor([2, -1])
    ids[0, 2, :] = torch.tensor([3, 4, 0, 1])  # stage 1 lies past n_stage
    lists = tk.TileLists(ids, torch.tensor([[2, 2, 1]], dtype=torch.int32),
                         torch.zeros((1, 3, 2)), 8, 4)
    assert tk.real_counts(lists, 22).tolist() == [[12, 4, 8]]
    # the same tiles as one CSR array: tile 0 owns stages 0-1, tile 1 stage 2, tile 2 stage 3
    flat = torch.cat([ids[0, 0], ids[0, 1, :2], ids[0, 2, :2]])[None]
    csr = tk.TileLists(flat, torch.tensor([[2, 1, 1]], dtype=torch.int32), torch.zeros((1, 4)),
                       8, 4, torch.tensor([[0, 2, 3]], dtype=torch.int32))
    assert tk.real_counts(csr, 22).tolist() == [[12, 4, 8]]
    partial = torch.full((1, 1, 2), -1, dtype=torch.int32)
    partial[0, 0, 0] = 5  # triangles 20-23 of 22: two real slots
    assert tk.real_counts(tk.TileLists(partial, torch.ones((1, 1), dtype=torch.int32),
                                       torch.zeros((1, 1, 1)), 8, 4), 22).tolist() == [[2]]


# ---------------------------------------------------------------------------
# a plain walk of the list walk against the reference
# ---------------------------------------------------------------------------


def list_walk(tris, lists, o_c, d_c, max_depth, form, origin_tiles, block_rays, mode="scalar",
              parts=1, body=True, pin=False):
    """A plain walk of ``csrc/tri_tile.cu`` → (t, hit, gid, stages): the tiles
    in ``lists.order``, each block of ``block_rays`` rays of a tile and stage
    share ``sp`` of ``parts`` walking the tile's real slots
    (:func:`real_counts`) in its stages ``sp, sp + parts, …`` counted from the
    tile's own first stage (``start`` for a CSR list), its own rays voting on
    each stage's bound, with its own running best and list position a ray;
    the shares then merge by (t, list position). Slot ``p`` holds triangle
    ``ids[p // block] · block + p % block``. ``stages`` (S, tiles) counts the
    stages the blocks' votes ran, summed over a tile's blocks. The knock-outs:
    ``body=False`` tests nothing; ``pin`` gives every stage the real slots of
    the tile's first stage, a win at position ``p`` that stage's slot
    ``p % chunk``."""
    _, S, R = o_c.shape
    tiles = R // TILE
    n_tris = tris.shape[1]
    chunk, bs, n_stage = lists.chunk, lists.block, lists.lb.shape[-1]
    per = chunk // bs
    counts = tk.real_counts(lists, n_tris)
    order = range(S * tiles) if lists.order is None else lists.order.tolist()
    t = torch.empty((S, R))
    gid = torch.zeros((S, R), dtype=torch.int32)
    stages = torch.zeros((S, tiles), dtype=torch.int32)
    for tile_idx in order:
        s, ti = divmod(tile_idx, tiles)
        if lists.start is None:
            n_own = min(int(lists.n_stage[s, ti]), n_stage)
            ids, lb = lists.ids[s, ti].long(), lists.lb[s, ti]
        else:
            st, n_own = int(lists.start[s, ti]), int(lists.n_stage[s, ti])
            ids, lb = lists.ids[s, st * per:(st + n_own) * per].long(), lists.lb[s, st:st + n_own]
        n_real = max(0, min(int(counts[s, ti]), n_own * chunk))
        cam0 = ti // origin_tiles * origin_tiles * TILE
        for r0, sp in itertools.product(range(ti * TILE, (ti + 1) * TILE, block_rays),
                                        range(parts)):
            d = tuple(d_c[i, s, None, r0:r0 + block_rays] for i in range(3))  # (1, block)
            o = (tuple(o_c[i, s, None, r0:r0 + block_rays] for i in range(3)) if form == "mt"
                 else tuple(o_c[i, s, cam0] for i in range(3)))
            tbest = torch.full((block_rays,), tk.BIG)
            pbest = torch.full((block_rays,), -1, dtype=torch.int64)
            for ci in range(sp, -(-n_real // chunk), parts):
                if not bool((lb[ci] < torch.clamp(tbest, max=max_depth)).any()):
                    continue
                stages[s, ti] += 1
                if not body:
                    continue
                at = torch.arange(min(chunk, n_real)) if pin else torch.arange(
                    ci * chunk, min((ci + 1) * chunk, n_real))
                entry = ids[at // bs]
                g = entry * bs + at % bs
                real = (entry >= 0) & (g < n_tris)
                rows = torch.where(real[:, None], tris[s, torch.where(real, g, 0)], 0.0)
                if form == "mt":
                    tk_ = tk._test_mt(rows, o, d)[0]
                else:
                    g0, g1, g2, kt = tk.sv_coefficients(rows, o)
                    tk_ = tk._test_sv((*(tuple(x[:, None] for x in c) for c in (g0, g1, g2)),
                                       kt[:, None]), d)[0]
                best, j = torch.min(tk_, dim=0)
                better = best < tbest
                pbest = torch.where(better, ci * chunk + j, pbest)
                tbest = torch.where(better, best, tbest)
            if sp == 0:
                t_m, p_m = tbest, pbest
            else:  # merge by (t, list position); a share that accepted nothing does not count
                live = pbest >= 0
                take = live & ((p_m < 0) | (tbest < t_m) | ((tbest == t_m) & (pbest < p_m)))
                t_m, p_m = torch.where(take, tbest, t_m), torch.where(take, pbest, p_m)
            t[s, r0:r0 + block_rays] = torch.clamp(t_m, 0.0, max_depth)
            at = torch.clamp(p_m, min=0)
            at = at % chunk if pin else at
            win = ids[at // bs] * bs + at % bs
            gid[s, r0:r0 + block_rays] = torch.where(p_m >= 0, win, 0).to(torch.int32)
    if mode == "merged":  # t and the id through one float32 block
        gid = gid.to(torch.float32).to(torch.int32)
    return t, t < max_depth, gid, stages


def _same(a, b):
    return (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and torch.equal(a[2][b[1]], b[2][b[1]]))


def ragged_blocks(lists, pattern=(0, 1, 7, 3, 18, 2, 5, 1)):
    """Block lists cut to ``pattern[tile]`` blocks a tile (at most the cap),
    the rest emptied, each tile's stages cut to those (at least one)."""
    per_tile = torch.tensor(pattern, dtype=torch.int32)[:lists.n_stage.shape[1]]
    blocks = torch.minimum(per_tile[None], lists.count // lists.chunk)
    entries = torch.arange(lists.ids.shape[-1])
    ids = torch.where(entries < blocks[..., None], lists.ids, -1).contiguous()
    count = (blocks * lists.chunk).to(torch.int32).contiguous()
    return lists._replace(ids=ids, n_stage=torch.clamp(blocks, min=1).to(torch.int32),
                          count=count, order=tk.longest_first(count))


@pytest.mark.parametrize("tier,block_rays,parts", [("merged", 1024, 1), ("merged", 512, 1),
                                                   ("merged", 512, 3), ("wl", 1024, 1),
                                                   ("wl", 256, 1), ("wl", 512, 8)])
def test_list_walk_equals_the_reference(grid, tier, block_rays, parts):
    """The list walk over the real slots, block by block, in longest-first
    order, is the sequential walk of every slot to the bit: on ragged block
    lists (tiles that keep 0 to 18 blocks) with the camera's origin and the
    merged output, and on a worklist (quotas of 3 to 14 stages, last stages
    part full); with ``parts`` stage shares a tile merged by (t, list
    position), more shares than some tiles have stages among them."""
    p = plan(grid, tier, **({"work_budget": 10 ** 6} if tier == "wl" else {}))
    lists = ragged_blocks(p.lists) if tier == "merged" else p.lists
    tris = T(grid[0])
    args = (tris, lists, p.origins_c, p.dirs_c, MAX_DEPTH, p.form, p.origin_tiles)
    ref = tk.tri_first_hit_reference(*args, mode=p.mode)
    walk = list_walk(*args, block_rays, p.mode, parts)
    assert _same(walk, ref) and float(ref[1].float().mean()) > 0.05
    assert torch.equal(tk.real_counts(lists._replace(count=None), tris.shape[1])[lists.count > 0],
                       lists.count[lists.count > 0])
    if tier == "merged":
        assert 0 in lists.count and len(set(lists.count.flatten().tolist())) >= 4
        full = tk.tri_first_hit_reference(tris, p.lists, *args[2:], mode=p.mode)
        assert not _same(full, ref)  # the cut lists see less of the mesh
    else:
        assert float(lists.n_stage.float().std()) > 0 and bool((lists.count % 128 != 0).any())


# ---------------------------------------------------------------------------
# the variants against the interpret-mode JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["merged", "wl"])
def test_list_tiers_match_jax(variant, grid, interpret_pallas):
    """The render through the tier, its lists carrying ``count`` and
    ``order``, equals the JAX kernel's on one 32×32 camera (one tile) where
    the first camera stands; the worklist with a budget for every stage."""
    tris = grid[0]
    n_tris, n = tris.shape[1], 32 * 32
    o1, d1 = camera_rays([CAMS[0][0]], [CAMS[1][0]], res=(32, 32))
    kw = {"work_budget": 10 ** 6} if variant == "wl" else {}
    lists = pt.plan_tiles(T(tris), T(o1), T(d1), MAX_DEPTH, n_tris, 32, n, soup_min_t=n_tris - 1,
                          variant=variant, **kw).lists
    assert lists.count is not None and lists.order is not None and int(lists.count.max()) > 0
    jax_args = (jnp.asarray(tris), jnp.asarray(o1), jnp.asarray(d1))
    if variant == "merged":
        out_j = jt._tri_trace_pallas_camsoup_v2(*jax_args, max_depth=MAX_DEPTH, cap=n_tris,
                                                img_w=32, cam_rays=n)
    else:
        out_j = jt._tri_trace_pallas_worklist(*jax_args, MAX_DEPTH, n_tris, 32, n,
                                              work_budget=10 ** 6)
    tk.reset_launches()
    out_p = pt.tri_trace_tiled(T(tris), T(o1), T(d1), MAX_DEPTH, n_tris, 32, n,
                               soup_min_t=n_tris - 1, variant=variant, **kw)
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors never count as launches
    assert float(out_p[1].float().mean()) > 0.2
    assert_same_image(out_p, out_j, tris, o1, d1, tol=1e-3)
    _assert_matches_brute(out_p, tris, o1, d1, tol=1e-3)
