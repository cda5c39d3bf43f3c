"""B8a and B8b, the stage count and the knock-outs, on the list walk of
``csrc/tri_tile.cu`` (``render/tri_kernel.py``, ``render/tri_trace.py``).

- The routing rule: with no ``split`` asked for, the stage count of every
  tier of the scalar output goes to the list walk (B4's tiers through
  :func:`tile_route`, the soup, per-camera and worklist tiers through
  :func:`list_route`), and so do the knock-outs of the merged output; at an
  explicit ``split`` they take the cluster walk, and the wrapper counts those
  launches apart. The count of the merged output asks for a ``split``.
- The plain version at ``block_rays=512``, each half of a tile voting on its
  own rays over the tile's real slots, equals a plain walk of the list walk
  (``test_torch_tri_list.list_walk``): the stages each tile ran summed over
  its blocks, exactly, t and hit to the bit and the id of every ray that
  hits. Möller–Trumbore over the soup's lists of 64- and 128-triangle blocks
  and signed volumes against the camera's origin, on the lists as the
  prepass gives them and on ragged ones in longest-first order; the three
  knock-outs on B7a's lists. The wrapper on CPU tensors counts alike.
- At ``block_rays=1024`` (the tile-wide vote) the count equals
  ``examples/_tri_probe.py::probe`` in interpret mode, exactly. The
  knock-outs at 512 are held to ``examples/_tri_kernel_exp.py::camsoup_exp``
  by ``test_torch_tri_variants.py::test_knockouts_match_jax_camsoup_exp``:
  ``knockout_trace`` on CPU tensors runs the plain version at 512.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_tri_list import _same, grid, list_walk, plan, ragged_blocks  # noqa: F401
from test_torch_tri_trace import T, camera_rays, cube_grid, interpret_pallas  # noqa: F401
from test_torch_tri_variants import example_module
from visfly_tpu_torch.render import tri_kernel as tk
from visfly_tpu_torch.render import tri_trace as pt

torch.set_num_threads(1)

TILE = 1024
MAX_DEPTH = 20.0
RES = 64
HALF = tk.TILE_BLOCK_RAYS


def _lists(block=1, start=False):
    z = torch.zeros((1, 1, 2), dtype=torch.int32)
    return tk.TileLists(z.reshape(1, 1, 2) if not start else z.reshape(1, 2),
                        torch.ones((1, 1), dtype=torch.int32), torch.zeros((1, 1, 1)),
                        2 * block if block > 1 else 2, block,
                        torch.zeros((1, 1), dtype=torch.int32) if start else None)


COUNT, KNOCK = {"count_stages": True}, {"mode": "merged", "knockout": True}


@pytest.mark.parametrize("form,lists,kw,want", [
    ("mt", _lists(block=128), COUNT, (False, True)),  # B8a on the soup's lists (B5)
    ("mt", _lists(block=64), COUNT, (False, True)),
    ("sv_cam", _lists(block=128), COUNT, (False, True)),  # on the per-camera tier (B6)
    ("sv_tile", _lists(block=16, start=True), COUNT, (False, True)),  # on the worklist (B7c)
    ("sv_tile", _lists(), COUNT, (True, False)),  # on B4's tiers
    ("mt", _lists(), COUNT, (True, False)),
    ("sv_cam", _lists(block=128), KNOCK, (False, True)),  # B8b on B7a's lists
    ("sv_cam", _lists(block=128), {"mode": "merged", **COUNT}, (False, False)),  # refused
    ("sv_cam", _lists(block=128), {"mode": "mx", **COUNT}, (False, False)),  # B7b counts itself
    ("mt", _lists(block=128), {**COUNT, "split": 1}, (False, False)),  # the cluster walk
    ("sv_tile", _lists(), {**COUNT, "split": 2}, (False, False)),
    ("sv_cam", _lists(block=128), {**KNOCK, "split": 1}, (False, False)),
])
def test_diagnostics_route(form, lists, kw, want):
    assert (tk.tile_route(form, lists, **kw), tk.list_route(form, lists, **kw)) == want


def test_launch_entries_and_the_merged_count(grid):
    """The cluster walk's diagnostics count apart; the merged output's count
    is refused without a split, on the CPU as on the card, and taken at one."""
    assert {"tri_trace_probe_cluster", "tri_trace_knockout_cluster"} <= set(tk.LAUNCHES)
    p = plan(grid, "merged")
    args = (T(grid[0]), p.lists, p.origins_c, p.dirs_c, MAX_DEPTH, p.form, p.origin_tiles)
    with pytest.raises(ValueError, match="split"):
        tk.tri_first_hit(*args, mode="merged", count_stages=True)
    s = {}
    ref = tk.tri_first_hit_reference(*args, stats=s, mode="merged")
    *out, stages = tk.tri_first_hit(*args, mode="merged", count_stages=True, split=1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref)) and torch.equal(stages, s["stages"])
    with pytest.raises(ValueError, match="divisor"):
        tk.tri_first_hit_reference(*args, block_rays=HALF, split=2)


def _soup(grid, block, ragged):
    """The soup tier's lists (Möller–Trumbore, per-ray origins) on the grid's
    two cameras: as the prepass gives them (no count, index order), or cut
    to ragged lists with their count and longest-first order."""
    tris, o_c, d_c = (T(x) for x in grid)
    lists = pt.block_lists(tris, o_c, d_c, MAX_DEPTH, tris.shape[1], RES, False, block)
    if ragged:
        lists = ragged_blocks(pt.walk_order(lists), (0, 1, 7, 3, 18, 2, 5, 1)[::-1])
    return tris, lists, o_c, d_c, "mt", 1


def _camera(grid, ragged):
    p = plan(grid, "scalar")
    lists = ragged_blocks(pt.walk_order(p.lists)) if ragged else p.lists
    return T(grid[0]), lists, p.origins_c, p.dirs_c, p.form, p.origin_tiles


@pytest.mark.parametrize("tier,block,ragged", [("soup", 128, False), ("soup", 64, False),
                                               ("soup", 128, True), ("soup", 64, True),
                                               ("camera", 128, False), ("camera", 128, True)])
def test_count_at_512_is_the_list_walks(grid, tier, block, ragged):
    """B8a: the plain version at 512 rays a block is the list walk's count
    and result; it sums the halves' own votes, so it lies within twice the
    tile's vote (1,024 rays), above it somewhere, and below it only where a
    tile has no real slot (the tile-wide walk still runs its one stage)."""
    tris, lists, o_c, d_c, form, origin_tiles = (_soup(grid, block, ragged) if tier == "soup"
                                                 else _camera(grid, ragged))
    assert lists.block == block
    args = (tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles)
    s512, s1024 = {}, {}
    ref = tk.tri_first_hit_reference(*args, stats=s512, block_rays=HALF)
    whole = tk.tri_first_hit_reference(*args, stats=s1024)
    walk = list_walk(*args, HALF)
    assert _same(walk, ref) and _same(whole, ref) and float(ref[1].float().mean()) > 0.05
    assert s512["stages"].dtype == torch.int32 and torch.equal(walk[3], s512["stages"])
    real = tk.real_counts(lists, tris.shape[1]) > 0
    assert bool((s1024["stages"] <= s512["stages"])[real].all())
    assert bool((s512["stages"] <= 2 * s1024["stages"]).all())
    assert bool((s512["stages"] > s1024["stages"]).any())
    *out, stages = tk.tri_first_hit(*args, count_stages=True)  # the wrapper on the CPU
    assert all(torch.equal(a, b) for a, b in zip(out, ref)) and torch.equal(stages, s512["stages"])
    if ragged:
        assert 0 in lists.count and lists.order is not None


@pytest.mark.parametrize("body,pin", [(True, False), (False, False), (True, True), (False, True)])
def test_knockouts_at_512_are_the_list_walks(grid, body, pin):
    """B8b on B7a's ragged lists: each knock-out of the plain version at 512
    rays a block equals the plain list walk with the same part knocked out,
    stages included; with the body off every ray ends at ``max_depth``, and a
    pinned stage's wins name the first stage's triangles."""
    p = plan(grid, "merged")
    lists = ragged_blocks(p.lists)
    args = (T(grid[0]), lists, p.origins_c, p.dirs_c, MAX_DEPTH, p.form, p.origin_tiles)
    s = {}
    ref = tk.tri_first_hit_reference(*args, stats=s, mode="merged", body=body, pin_stage=pin,
                                     block_rays=HALF)
    walk = list_walk(*args, HALF, "merged", body=body, pin=pin)
    assert _same(walk, ref) and torch.equal(walk[3], s["stages"]) and int(s["stages"].sum()) > 0
    if not body:
        assert bool((ref[0] == MAX_DEPTH).all()) and s["gated"] == 0
    elif pin:
        first = lists.ids[..., 0].long().repeat_interleave(TILE, 1)  # (S, R): the first block
        won = ref[2].long()[ref[1]] // lists.block
        assert bool((won == first[ref[1]]).all()) and float(ref[1].float().mean()) > 0.05
    t = pt.knockout_trace(args[0], p.origins_c, p.dirs_c, MAX_DEPTH, body=body, pin_stage=pin,
                          plan=p._replace(lists=lists))
    assert torch.equal(t, ref[0])


@pytest.fixture(scope="module")
def work():
    """One numpy-seeded 64×64 camera before the cube grid, as
    ``tests/test_torch_tri_variants.py``."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]], res=(RES, RES))
    return tris, o_c, d_c


def test_count_at_1024_is_the_jax_probes(work, interpret_pallas):
    """The tile-wide vote of the plain version counts what the JAX probe
    counts, tile by tile, on the probe's lists (the whole mesh); the list
    walk's count, which ``stage_stats`` gives, sums two such votes."""
    tris, o_c, d_c = work
    probe = example_module("_tri_probe").probe
    _, _, cnt_j, _, n_chunks = probe(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c),
                                     MAX_DEPTH, tris.shape[1], RES)
    tt, ot, dt = T(tris), T(o_c), T(d_c)
    lists = pt.block_lists(tt, ot, dt, MAX_DEPTH, tris.shape[1], RES, False)
    assert lists.lb.shape[-1] == n_chunks
    s = {}
    tk.tri_first_hit_reference(tt, lists, ot, dt, MAX_DEPTH, "mt", 1, stats=s)
    np.testing.assert_array_equal(s["stages"].numpy(), np.rint(np.asarray(cnt_j)).astype(np.int32))
    st = pt.stage_stats(tt, ot, dt, MAX_DEPTH, None, RES)
    assert st["block_rays"] == HALF and bool((st["stages"] >= s["stages"]).all())
    assert bool((st["stages"] <= 2 * s["stages"]).all())
