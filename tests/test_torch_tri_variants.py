"""The variants of the port's per-camera triangle tier (``variant="merged" |
"mx" | "wl"`` of ``visfly_tpu_torch/render/tri_trace.py``) and its two
diagnostics (stages executed, knock-outs) against the JAX package.

The JAX functions (``_tri_trace_pallas_camsoup_v2``, ``_camsoup_mx``,
``_worklist``) run in interpret mode exactly as ``tests/test_tri_trace.py``
runs them: one numpy-seeded 64×64 camera in front of a 2,304-triangle grid of
cubes, lists that hold the whole mesh. The port reaches the tier on that mesh
through its ``soup_min_t`` argument; on the CPU its wrapper runs each kernel's
plain version.

Tolerances: hit flags equal; |Δt| ≤ 1e-3 m against JAX, the bound of the
per-camera tier's own parity test (``test_camera_soup_tier_matches_jax``): the
JAX pages expand ``g0 = b×c + o×(b − c)`` where the port subtracts the origin
first, which moves a handful of grazing rays by 1e-4 m; all but 1% of rays
agree within 1e-4 m. Against the port's own ``"scalar"``: ``merged`` equal to
the bit, ``mx`` within 1e-4 m. Ids equal where the best t is unique; under
budget the worklist never reports a nearer hit than the brute force.
"""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.tri_trace as jt
from test_torch_tri_trace import (T, _assert_matches_brute, assert_same_image,  # noqa: F401
                                  camera_rays, cube_grid, interpret_pallas)
from visfly_tpu_torch.render import sphere_trace as st
from visfly_tpu_torch.render import tri_kernel as tk
from visfly_tpu_torch.render import tri_trace as pt

torch.set_num_threads(1)

MAX_DEPTH = 20.0
RES = 64


@pytest.fixture(scope="module")
def work():
    """(tris (1, 2304, 9), o_c, d_c (3, 1, 4096)) as numpy, the camera of
    ``tests/test_tri_trace.py::test_camsoup_v2_matches_v1``."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]], res=(RES, RES))
    return tris, o_c, d_c


def port_trace(work, variant, **kw):
    tris, o_c, d_c = work
    n_tris = tris.shape[1]
    return pt.tri_trace_tiled(T(tris), T(o_c), T(d_c), MAX_DEPTH, n_tris, RES, RES * RES,
                              soup_min_t=n_tris - 1, variant=variant, **kw)


@pytest.fixture(scope="module")
def scalar(work):
    return port_trace(work, "scalar")


JAX_FN = {"merged": "_tri_trace_pallas_camsoup_v2", "mx": "_tri_trace_pallas_camsoup_mx"}


@pytest.mark.parametrize("variant", ["merged", "mx"])
def test_variant_matches_jax(variant, work, scalar, interpret_pallas):
    tris, o_c, d_c = work
    out_j = getattr(jt, JAX_FN[variant])(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c),
                                         max_depth=MAX_DEPTH, cap=tris.shape[1], img_w=RES,
                                         cam_rays=RES * RES)
    tk.reset_launches()
    out_p = port_trace(work, variant)
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors never count as launches
    assert_same_image(out_p, out_j, tris, o_c, d_c, tol=1e-3)
    assert float((np.abs(out_p[0].numpy() - np.asarray(out_j[0])) > 1e-4).mean()) < 1e-2
    _assert_matches_brute(out_p, tris, o_c, d_c, tol=1e-3)
    # beside the port's own "scalar": the merged block changes no bit, the
    # matrix product only the rounding of t
    assert torch.equal(out_p[1], scalar[1])
    if variant == "merged":
        assert torch.equal(out_p[0], scalar[0]) and torch.equal(out_p[3], scalar[3])
    else:
        torch.testing.assert_close(out_p[0], scalar[0], atol=1e-4, rtol=0)
        assert float((out_p[3] != scalar[3])[scalar[1]].float().mean()) < 1e-2  # tied edges


def test_worklist_matches_jax_with_every_stage(work, interpret_pallas):
    tris, o_c, d_c = work
    out_j = jt._tri_trace_pallas_worklist(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c),
                                          MAX_DEPTH, tris.shape[1], RES, RES * RES,
                                          work_budget=10 ** 6)
    out_p = port_trace(work, "wl", work_budget=10 ** 6)
    assert_same_image(out_p, out_j, tris, o_c, d_c, tol=1e-3)
    _assert_matches_brute(out_p, tris, o_c, d_c, tol=1e-3)


@pytest.mark.parametrize("budget", [2, 8, None])
def test_worklist_under_budget_never_nearer(budget, work):
    """Dropped stages are each tile's farthest: depth only ever grows."""
    tris, o_c, d_c = work
    t_b, hit_b, _, _ = pt.tri_trace_brute(T(tris), T(o_c.transpose(1, 2, 0)),
                                          T(d_c.transpose(1, 2, 0)))
    t, hit, _, _ = port_trace(work, "wl", work_budget=budget)
    assert bool((t >= t_b - 1e-3).all())
    assert not bool((hit & ~hit_b).any())
    near = hit_b & (t_b < 4.0)  # the first row of cubes is in every tile's first stage
    assert int(near.sum()) > 50 and torch.equal(hit[near], hit_b[near])
    if budget == 2:  # 4 tiles share 8 stages of the 18 each would need
        assert int((hit_b & ~hit).sum()) > 0


def test_worklist_prepass_matches_jax(work):
    """The CSR lists against the arithmetic of ``_tri_trace_pallas_worklist``
    on the same rays: visible clusters per tile, quotas, offsets, per-stage
    bounds, and the clusters kept (in order where no two distances tie)."""
    tris, o_c, d_c = work
    n_tris, tiles = tris.shape[1], o_c.shape[2] // tk.TILE
    per = pt.WL_CHUNK // pt.WL_CLUSTER
    budget = 5
    lists = pt.worklist_lists(T(tris), T(o_c), T(d_c), MAX_DEPTH, n_tris, RES, False, budget)
    assert lists.chunk == pt.WL_CHUNK == jt.WL_CHUNK and lists.block == pt.WL_CLUSTER
    assert pt.WL_CLUSTER == jt.WL_CLUSTER

    o4 = jnp.asarray(o_c).reshape(3, 1, tiles, tk.TILE)
    d4 = jnp.asarray(d_c).reshape(3, 1, tiles, tk.TILE)
    lo = (o4.min(-1) + MAX_DEPTH * jnp.minimum(d4.min(-1), 0.0)).transpose(1, 2, 0)
    hi = (o4.max(-1) + MAX_DEPTH * jnp.maximum(d4.max(-1), 0.0)).transpose(1, 2, 0)
    active, dist, lb_all = jt._cluster_activity(jnp.asarray(tris), jnp.asarray(o_c),
                                                jnp.asarray(d_c), MAX_DEPTH, lo, hi, RES,
                                                cluster=jt.WL_CLUSTER, backface=False)
    active, dist, lb_all = (np.asarray(x) for x in (active, dist, lb_all))
    n_cl = n_tris // jt.WL_CLUSTER
    n_chunks = n_cl // per
    counts = active.sum(-1)  # (1, tiles)
    cnt_ch = np.clip(-(-counts // per), 1, n_chunks)
    nw = tiles * budget
    extra = (cnt_ch - 1).astype(np.float32)
    scale = np.minimum(1.0, (nw - tiles) / np.maximum(extra.sum(-1, keepdims=True), 1.0))
    quota = 1 + np.floor(extra * scale).astype(np.int64)
    start = np.cumsum(quota, -1) - quota
    assert (quota < cnt_ch).any()  # this budget truncates
    np.testing.assert_array_equal(lists.n_stage.numpy(), quota)
    np.testing.assert_array_equal(lists.start.numpy(), start)
    assert tuple(lists.ids.shape) == (1, nw * per) and tuple(lists.lb.shape) == (1, nw)

    ids = lists.ids.numpy()[0].reshape(nw, per)
    lb = lists.lb.numpy()[0]
    for tile in range(tiles):
        key = np.where(active[0, tile], dist[0, tile], np.inf)
        order = np.argsort(key, kind="stable")
        keep = min(int(counts[0, tile]), int(quota[0, tile]) * per)
        mine = ids[start[0, tile]:start[0, tile] + quota[0, tile]].reshape(-1)
        assert (mine[keep:] == -1).all()  # slots past the count are empty
        assert set(mine[:keep]) <= set(order[:int(counts[0, tile])])
        d_sorted = key[order[:keep + 1]]
        untied = np.diff(d_sorted) > 0
        same = mine[:keep] == order[:keep]
        assert same[untied[:keep] & np.r_[True, untied[:keep - 1]]].all()
        for s in range(int(quota[0, tile])):  # a stage's bound: the least of its clusters'
            cl = mine[s * per:(s + 1) * per]
            want = lb_all[0, tile][cl[cl >= 0]].min() if (cl >= 0).any() else tk.BIG
            assert lb[start[0, tile] + s] == pytest.approx(want, abs=1e-5)
    assert (lb[int(start[0, -1] + quota[0, -1]):] == tk.BIG).all()  # stages nobody owns


@pytest.mark.parametrize("tier", ["soup", "camera", "worklist"])
def test_count_stages_matches_lists(tier, work):
    """Stages executed per tile against what ``lb`` and ``n_stage`` allow,
    summed over the tile's blocks of ``TILE_BLOCK_RAYS`` rays (the list
    walk's count): with every bound at 0 each block runs every stage that
    holds its tile's real slots; with the real bounds a block runs a stage if its bound is below
    the block's final worst t (the worst only falls) and never if it is at
    or past ``max_depth``."""
    tris, o_c, d_c = (T(x) for x in work)
    n_tris = tris.shape[1]
    if tier == "worklist":
        lists, form = pt.worklist_lists(tris, o_c, d_c, MAX_DEPTH, n_tris, RES, False, 10 ** 6), \
            "sv_tile"
    else:
        lists = pt.block_lists(tris, o_c, d_c, MAX_DEPTH, n_tris, RES, False)
        form = "mt" if tier == "soup" else "sv_cam"
    origin_tiles = 4 if form == "sv_cam" else 1
    t, hit, gid, stages = tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                           count_stages=True)
    plain = tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, form, origin_tiles)
    assert torch.equal(t, plain[0]) and torch.equal(gid, plain[2])  # counting changes no pixel
    assert stages.dtype == torch.int32 and tuple(stages.shape) == (1, 4)
    blocks = tk.TILE // tk.TILE_BLOCK_RAYS
    padded = tk.padded_lists(lists)
    own = torch.arange(padded.lb.shape[2]) < padded.n_stage[..., None]
    worst = t.reshape(1, 4, blocks, tk.TILE_BLOCK_RAYS).amax(-1)  # (1, tiles, blocks)
    at_least = (own[:, :, None] & (padded.lb[:, :, None] < worst[..., None])).sum((-1, -2))
    at_most = (own & (padded.lb < MAX_DEPTH)).sum(-1) * blocks
    assert bool((stages >= at_least).all()) and bool((stages <= at_most).all())
    # the early-out skipped something
    assert int(stages.sum()) < int(lists.n_stage.sum()) * blocks
    forced = lists._replace(lb=torch.zeros_like(lists.lb))
    *_, all_stages = tk.tri_first_hit(tris, forced, o_c, d_c, MAX_DEPTH, form, origin_tiles,
                                      count_stages=True)
    walked = -(-tk.real_counts(lists, n_tris) // lists.chunk)  # the stages of the real slots
    assert bool((walked <= lists.n_stage).all()) and torch.equal(all_stages, walked * blocks)


@pytest.mark.parametrize("exact_aabb", [False, True])
def test_stage_stats(exact_aabb, work):
    tris, o_c, d_c = (T(x) for x in work)
    s = pt.stage_stats(tris, o_c, d_c, MAX_DEPTH, None, RES, exact_aabb=exact_aabb)
    t_b, hit_b, _, _ = pt.tri_trace_brute(tris, o_c.permute(1, 2, 0), d_c.permute(1, 2, 0))
    assert torch.equal(s["hit"], hit_b)  # the bound and the order change no pixel
    torch.testing.assert_close(s["t"], t_b, atol=1e-4, rtol=0)
    c = s["stages"].numpy()
    blocks = tk.TILE // s["block_rays"]  # the count sums a tile's blocks
    assert s["mean"] == pytest.approx(c.mean()) and s["max"] == c.max()
    assert s["p50"] <= s["p90"] <= s["max"] <= s["n_stage"] * blocks
    assert s["n_stage"] == tris.shape[1] // 128 and s["block_rays"] == tk.TILE_BLOCK_RAYS
    assert 0 < s["mean"] <= s["visible_mean"] * blocks and s["hit_frac"] == pytest.approx(
        float(hit_b.float().mean()))


@pytest.mark.parametrize("body,pin_stage", [(True, False), (True, True), (False, False),
                                            (False, True)])
def test_knockouts_match_their_definitions(body, pin_stage, work, scalar):
    """``body=False``: no test runs, every ray ends at ``max_depth``.
    ``pin_stage=True``: every stage loads the list's first block, so t is the
    first hit over that block alone. Neither: the merged kernel."""
    tris, o_c, d_c = (T(x) for x in work)
    n_tris = tris.shape[1]
    plan = pt.plan_tiles(tris, o_c, d_c, MAX_DEPTH, n_tris, RES, RES * RES, soup_min_t=0,
                         variant="merged")
    t = pt.knockout_trace(tris, o_c, d_c, MAX_DEPTH, n_tris, RES, RES * RES, body=body,
                          pin_stage=pin_stage, plan=plan)
    if not body:
        assert bool((t == MAX_DEPTH).all())
    elif pin_stage:
        first = plan.lists._replace(ids=plan.lists.ids[:, :, :1].contiguous(),
                                    lb=plan.lists.lb[:, :, :1].contiguous(),
                                    n_stage=torch.ones_like(plan.lists.n_stage))
        want = tk.tri_first_hit(tris, first, plan.origins_c, plan.dirs_c, MAX_DEPTH, "sv_cam",
                                plan.origin_tiles)[0]
        assert torch.equal(t, want) and bool((t < MAX_DEPTH).any())
    else:  # the scalar kernel's t; the function then takes t again on the winner's plane
        want = tk.tri_first_hit(tris, plan.lists, plan.origins_c, plan.dirs_c, MAX_DEPTH,
                                "sv_cam", plan.origin_tiles)[0]
        assert torch.equal(t, want)
        torch.testing.assert_close(plan.unpack(t), scalar[0], atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="merged"):
        tk.tri_first_hit(tris, plan.lists, plan.origins_c, plan.dirs_c, MAX_DEPTH, "sv_cam",
                         plan.origin_tiles, "scalar", body=False)


def example_module(name):
    """A diagnostic script of ``examples/`` as a module. The scripts point
    JAX's compilation cache at the repository when imported; that setting is
    put back."""
    import importlib
    import os
    import sys

    here = os.path.join(os.path.dirname(__file__), "..", "examples")
    if here not in sys.path:
        sys.path.insert(0, here)
    cache = jax.config.jax_compilation_cache_dir
    try:
        return importlib.import_module(name)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)


@pytest.mark.parametrize("exact_aabb", [False, True])
def test_stage_stats_matches_jax_probe(exact_aabb, work, interpret_pallas):
    """``stage_stats`` against ``examples/_tri_probe.py::probe`` in interpret
    mode on the same rays, lists of the whole mesh: t within 1e-4 m, hit flags
    equal, the blocks seen per tile equal. The stages executed differ by
    design (the port's are the list walk's, summed over a tile's two blocks);
    ``tests/test_torch_tri_diag.py`` holds the tile-wide count of the plain
    version to the probe's, exactly.

    With ``exact_aabb`` the JAX probe gives culled blocks a finite bound too
    and sorts them in among the visible ones, while a tile still walks only
    as many stages as it sees blocks: visible blocks fall off the end and hits
    are lost. The port keeps culled blocks last, so there it is held to the
    brute force (``test_stage_stats``) and to "never farther than JAX"."""
    tris, o_c, d_c = work
    probe = example_module("_tri_probe").probe
    t_j, hit_j, _, vis_j, n_chunks = probe(jnp.asarray(tris), jnp.asarray(o_c),
                                               jnp.asarray(d_c), MAX_DEPTH, tris.shape[1], RES,
                                               exact_aabb=exact_aabb)
    t_j, hit_j = np.asarray(t_j), np.asarray(hit_j) > 0.5
    s = pt.stage_stats(T(tris), T(o_c), T(d_c), MAX_DEPTH, None, RES, exact_aabb=exact_aabb)
    assert s["n_stage"] == n_chunks
    assert s["visible_mean"] == pytest.approx(float(np.asarray(vis_j).mean()))
    assert 0 < s["mean"] < n_chunks * tk.TILE // s["block_rays"]  # the early-out skipped some
    if exact_aabb:
        assert bool((s["t"].numpy() <= t_j + 1e-4).all()) and not (hit_j & ~s["hit"].numpy()).any()
        agree = np.abs(s["t"].numpy() - t_j) <= 1e-4
        assert agree.mean() > 0.9 and agree.reshape(4, -1).all(-1).any()
        return
    np.testing.assert_array_equal(s["hit"].numpy(), hit_j)
    np.testing.assert_allclose(s["t"].numpy(), t_j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("body,dma", [(True, True), (False, True), (True, False), (False, False)])
def test_knockouts_match_jax_camsoup_exp(body, dma, work, interpret_pallas):
    """``knockout_trace`` against ``examples/_tri_kernel_exp.py::camsoup_exp``
    in interpret mode on the plan's rays (32×32-pixel tiles), t within 1e-3 m
    (the JAX pages expand their coefficients, module docstring). ``dma=False``
    pins the page to block 0 of the soup where the port pins the list's first
    entry, so for that case the port's lists start with block 0."""
    tris, o_c, d_c = work
    n_tris = tris.shape[1]
    plan = pt.plan_tiles(T(tris), T(o_c), T(d_c), MAX_DEPTH, n_tris, RES, RES * RES,
                         soup_min_t=0, variant="merged")
    camsoup_exp = example_module("_tri_kernel_exp").camsoup_exp
    t_j = camsoup_exp(jnp.asarray(tris), jnp.asarray(plan.origins_c.numpy()),
                      jnp.asarray(plan.dirs_c.numpy()), MAX_DEPTH, n_tris, 32, RES * RES, False,
                      body=body, dma=dma)
    if not dma:
        ids = plan.lists.ids.clone()
        ids[:, :, 0] = 0
        plan = plan._replace(lists=plan.lists._replace(ids=ids))
    t = pt.knockout_trace(T(tris), T(o_c), T(d_c), MAX_DEPTH, body=body, pin_stage=not dma,
                          plan=plan)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=1e-3, rtol=0)
    hits = float((t < MAX_DEPTH).float().mean())
    if not body:
        assert hits == 0 and bool((np.asarray(t_j) == MAX_DEPTH).all())
    else:  # block 0 alone is a corner of the grid of cubes
        assert hits > (0.1 if dma else 0.0)


def test_wrapper_rejects_variants_off_their_tier(work):
    tris, o_c, d_c = (T(x) for x in work)
    lists = pt.tile_lists(tris, o_c, d_c, MAX_DEPTH, 256, RES, False)
    for mode in ("merged", "mx"):
        with pytest.raises(ValueError, match="per-camera"):
            tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, "sv_tile", 1, mode)
    with pytest.raises(ValueError, match="mode"):
        tk.tri_first_hit(tris, lists, o_c, d_c, MAX_DEPTH, "sv_tile", 1, "fast")
    with pytest.raises(ValueError, match="variant"):
        pt.tri_trace_tiled(tris, o_c, d_c, variant="fastest")


@pytest.fixture(scope="module")
def baked():
    from visfly_tpu_torch.scene import bake_scene_from_arrays

    v, f = cube_grid()
    return bake_scene_from_arrays(v, f, spacing=0.5, margin=3.0, device="cpu")


@pytest.mark.parametrize("variant", ["merged", "mx", "wl"])
def test_tri_variant_through_render_camera(variant, baked):
    """The sensor-spec key ``tri_variant`` reaches the tier: with the
    threshold lowered the render runs that variant's plain version and the
    image stays the default's; on a mesh below the threshold the key changes
    nothing."""
    pos = torch.tensor([[-2.03, 0.011, 1.017]])
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    spec = {"sensor_type": "depth", "resolution": [RES, RES], "tri_cap": baked.triangles.shape[1]}
    base = st.render_camera(baked, pos, q, spec)["depth"]
    seen = []
    plain = tk.tri_first_hit_reference

    def spy(tris, lists, *a, **kw):
        # (origins, dirs, max_depth, form, origin_tiles, stats, mode, ...)
        seen.append((a[3], lists.start is not None, a[6]))
        return plain(tris, lists, *a, **kw)

    with mock.patch.object(tk, "tri_first_hit_reference", spy):
        same = st.render_camera(baked, pos, q, dict(spec, tri_variant=variant))["depth"]
        assert seen == [("sv_tile", False, "scalar")]  # 2,304 triangles: the cluster tier
        assert torch.equal(same, base)
        seen.clear()
        lowered = functools.partial(pt.tri_trace_diff, soup_min_t=0,
                                    **({"work_budget": 10 ** 6} if variant == "wl" else {}))
        with mock.patch.object(st, "tri_trace_diff", lowered):
            out = st.render_camera(baked, pos, q, dict(spec, tri_variant=variant))["depth"]
    want = {"merged": ("sv_cam", False, "merged"), "mx": ("sv_cam", False, "mx"),
            "wl": ("sv_tile", True, "scalar")}[variant]
    assert seen == [want]
    torch.testing.assert_close(out, base, atol=1e-3, rtol=0)
    assert float((base < MAX_DEPTH).float().mean()) > 0.1
    with pytest.raises(ValueError, match="variant"):
        st.render_camera(baked, pos, q, dict(spec, tri_variant="fastest"))


def test_variant_gradient_is_the_closed_form(work, scalar):
    """The backward pass is the planar rule on the variant's forward output:
    with ``merged``, whose forward equals ``scalar`` to the bit, so does the
    gradient."""
    tris, o_c, d_c = (T(x) for x in work)
    n_tris = tris.shape[1]
    grads = {}
    for variant in ("scalar", "merged"):
        o = o_c.clone().requires_grad_(True)
        t, hit, _, _ = pt.tri_trace_diff(tris, o, d_c, MAX_DEPTH, n_tris, RES, True, RES * RES,
                                         soup_min_t=n_tris - 1, variant=variant)
        (grads[variant],) = torch.autograd.grad(torch.where(hit, t, 0.0).sum(), o)
    assert torch.equal(grads["scalar"], grads["merged"])
    assert float(grads["merged"].abs().max()) > 0
