"""The port's exact-triangle tracer (``visfly_tpu_torch/render/tri_trace.py``
and ``tri_kernel.py``) against ``visfly_tpu/render/tri_trace.py``.

The same numpy rays and meshes go through both packages. The JAX side runs its
Pallas kernels in interpret mode, as ``tests/test_tri_trace.py`` does, and
reaches the shared-soup tiers on a 2,304-triangle mesh by lowering
``SHARED_SOUP_MIN_T`` on its module; the port takes the threshold as an
argument. On the CPU the port's wrapper runs the kernel's plain version.

Tolerances: hit flags equal, |Δt| ≤ 1e-4 m (the JAX tests' own bound; the two
packages round the signed-volume coefficients in different orders), normals
within 1e-4 on hits, ids equal where the best t is unique; per-tile counts of
the prepasses equal and the kept ids equal as sets; gradients within 1e-4
relative where |n·d| > 0.1.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import visfly_tpu.render.tri_trace as jt
from visfly_tpu_torch.render import tri_kernel as tk
from visfly_tpu_torch.render import tri_trace as pt

torch.set_num_threads(1)

TOL_T = 1e-4
TILE = 1024


@pytest.fixture
def interpret_pallas():
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


def cube_mesh(center=(0.0, 0.0, 0.0), half=1.0):
    c = np.asarray(center, np.float32)
    v = np.asarray([[x, y, z] for x in (-half, half) for y in (-half, half)
                    for z in (-half, half)], np.float32) + c
    f = np.asarray([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                    [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def two_cubes():
    v1, f1 = cube_mesh((0.0, 0.0, 0.0), 1.0)
    v2, f2 = cube_mesh((4.0, 0.0, 0.0), 0.8)
    return np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)])


def cube_grid(nx=8, ny=8, nz=3, half=0.4, x0=2.0):
    """nx·ny·nz small cubes: 2,304 triangles at the default, past the
    cluster-cull threshold."""
    verts, faces = [], []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                v, f = cube_mesh((i * 2.0 + x0, j * 2.0 - ny, k * 2.0), half)
                faces.append(f + 8 * len(verts))
                verts.append(v)
    return np.concatenate(verts), np.concatenate(faces)


def random_rays(n=TILE, seed=0, origin=(-3.0, 0.0, 0.0), scenes=1):
    """Rays (scenes, n, 3) from a 1 m box around ``origin`` towards +x."""
    rng = np.random.default_rng(seed)
    o = (np.asarray(origin) + rng.uniform(-0.5, 0.5, (scenes, n, 3))).astype(np.float32)
    d = (rng.normal(size=(scenes, n, 3)) + [2.0, 0.0, 0.0]).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def camera_rays(pos, euler, res=(64, 64)):
    """Whole row-major cameras (3, 1, n·H·W), from the JAX package's camera
    model so that both sides see the same floats."""
    from visfly_tpu.core import quaternion as quat
    from visfly_tpu.render.camera import camera_rays_components

    spec = {"sensor_type": "depth", "resolution": list(res)}
    e = np.asarray(euler, np.float32)
    q = quat.from_euler(jnp.asarray(e[:, 0]), jnp.asarray(e[:, 1]), jnp.asarray(e[:, 2]))
    o_c, d_c, _ = camera_rays_components(spec, jnp.asarray(pos, jnp.float32), q)
    n, hw = len(e), res[0] * res[1]
    o = np.broadcast_to(np.asarray(o_c)[:, :, None], (3, n, hw)).reshape(3, 1, n * hw)
    return np.ascontiguousarray(o), np.ascontiguousarray(np.asarray(d_c).reshape(3, 1, n * hw))


def comp(x):
    """(S, R, 3) → component-major (3, S, R)."""
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same_image(port_out, jax_out, tris, o_c, d_c, tol=TOL_T):
    """(t, hit, normal, id) of the port against the JAX tuple."""
    t_p, hit_p, n_p, g_p = (x.numpy() for x in port_out)
    t_j, hit_j, n_j, g_j = (np.asarray(x) for x in jax_out)
    np.testing.assert_array_equal(hit_p, hit_j)
    np.testing.assert_allclose(t_p, t_j, atol=tol, rtol=0)
    np.testing.assert_allclose(n_p[hit_j], n_j[hit_j], atol=1e-4, rtol=0)
    # ids where no second triangle lies within a millimetre of the best t
    unique = hit_j & _unique_best(tris, o_c, d_c)
    assert unique.mean() > 0.5 * hit_j.mean()
    np.testing.assert_array_equal(g_p[unique], g_j[unique])


def _unique_best(tris, o_c, d_c):
    """Rays whose winning t beats every other triangle's by more than 1e-3."""
    o, d = o_c.transpose(1, 2, 0), d_c.transpose(1, 2, 0)
    S, R = o.shape[:2]
    out = np.zeros((S, R), bool)
    for s in range(S):
        a, b, c = tris[s, :, 0:3], tris[s, :, 3:6], tris[s, :, 6:9]
        e1, e2 = (b - a)[:, None], (c - a)[:, None]
        dd, oo = d[s][None], o[s][None]
        p = np.cross(dd, e2)
        det = (e1 * p).sum(-1)
        ok = np.abs(det) > 1e-9
        inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = oo - a[:, None]
        u = (tv * p).sum(-1) * inv
        qv = np.cross(tv, e1)
        v = (dd * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        # a generous acceptance band: near-edge hits of a neighbour count too
        okk = ok & (u >= -1e-3) & (v >= -1e-3) & (u + v <= 1 + 1e-3) & (t > 1e-4)
        ts = np.sort(np.where(okk, t, 1e9), axis=0)
        out[s] = ts[1] - ts[0] > 1e-3
    return out


def both_packages(tris, o_c, d_c, soup_min_t=None, monkeypatch=None, **kw):
    """The tiled trace of both packages on component-major numpy rays."""
    if soup_min_t is not None:
        monkeypatch.setattr(jt, "SHARED_SOUP_MIN_T", soup_min_t)
    out_j = jt.tri_trace_pallas(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c), **kw)
    if soup_min_t is not None:
        kw["soup_min_t"] = soup_min_t
    tk.reset_launches()
    out_p = pt.tri_trace_tiled(T(tris), T(o_c), T(d_c), **kw)
    assert sum(tk.LAUNCHES.values()) == 0  # CPU tensors never count as launches
    return out_p, out_j


def brute_both(tris, o_c, d_c):
    o, d = o_c.transpose(1, 2, 0), d_c.transpose(1, 2, 0)
    return (pt.tri_trace_brute(T(tris), T(o), T(d)),
            jt.tri_trace_xla(jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d)))


# ---------------------------------------------------------------------------
# packing, caps, brute force
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", ["two_cubes", "cube_grid"])
def test_pack_triangles_bitwise(mesh):
    v, f = two_cubes() if mesh == "two_cubes" else cube_grid()
    p_t, ids_t = pt.pack_triangles(v, f, return_order=True)
    p_j, ids_j = jt.pack_triangles(v, f, return_order=True)
    assert p_t.dtype == p_j.dtype and p_t.shape == p_j.shape
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(pt.pack_triangles(v, f), p_j)
    if mesh == "cube_grid":
        assert p_t.shape[0] % pt.CLUSTER == 0 and (ids_t[: len(f)] != np.arange(len(f))).any()


@pytest.mark.parametrize("n", [24, 360, 2048, 2049, 5760, 23040, 100_000])
def test_default_tri_cap(n):
    assert pt.default_tri_cap(n) == jt.default_tri_cap(n)


def test_constants_match():
    for name in ("TILE", "CLUSTER", "CLUSTER_CULL_MIN_T", "SHARED_SOUP_MIN_T", "BIG"):
        assert getattr(pt, name) == getattr(jt, name), name
    assert pt.STAGE == jt.TRI_UNROLL


def test_brute_force_matches_xla():
    v, f = two_cubes()
    tris = pt.pack_triangles(v, f)[None]
    o, d = random_rays(TILE, seed=3)
    (t_p, hit_p, n_p, g_p), (t_j, hit_j, n_j, g_j) = brute_both(tris, comp(o), comp(d))
    np.testing.assert_array_equal(hit_p.numpy(), np.asarray(hit_j))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(n_p.numpy(), np.asarray(n_j), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(g_p.numpy(), np.asarray(g_j))
    # slabs of triangles give the same first minimum as one pass
    t_s, hit_s, _, g_s = pt.tri_trace_brute(T(tris), T(o), T(d), max_elems=5 * TILE)
    torch.testing.assert_close(t_s, t_p, atol=0, rtol=0)
    assert torch.equal(g_s, g_p) and torch.equal(hit_s, hit_p)


def test_brute_force_geometry():
    v, f = two_cubes()
    tris = T(pt.pack_triangles(v, f)[None])
    o = torch.tensor([[[-3.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 5.0, 0.0]]])
    d = torch.tensor([[[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]])
    t, hit, n, _ = pt.tri_trace_brute(tris, o, d)
    torch.testing.assert_close(t[0], torch.tensor([2.0, 1.2, 4.0]), atol=1e-5, rtol=0)
    assert bool(hit.all())
    torch.testing.assert_close(n[0, 0], torch.tensor([-1.0, 0.0, 0.0]), atol=1e-5, rtol=0)
    torch.testing.assert_close(n[0, 2], torch.tensor([0.0, 1.0, 0.0]), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# prepasses
# ---------------------------------------------------------------------------


def _assert_lists_match(ids_p, counts_p, lb_p, ids_j, counts_j, lb_j, block=1):
    """Counts equal; the kept visible ids equal as sets per tile; the lower
    bounds of the kept entries equal within 1e-5."""
    counts_p, counts_j = counts_p.numpy(), np.asarray(counts_j)
    np.testing.assert_array_equal(counts_p, counts_j)
    ids_p, ids_j = ids_p.numpy(), np.asarray(ids_j)
    lb_p, lb_j = lb_p.numpy(), np.asarray(lb_j)
    assert ids_p.shape == ids_j.shape
    for s in range(ids_p.shape[0]):
        for t in range(ids_p.shape[1]):
            k = min(int(counts_p[s, t]) // block * block, ids_p.shape[2])
            assert set(ids_p[s, t, :k]) == set(ids_j[s, t, :k]), (s, t)
            order_p, order_j = np.argsort(ids_p[s, t, :k]), np.argsort(ids_j[s, t, :k])
            np.testing.assert_allclose(lb_p[s, t, :k][order_p], lb_j[s, t, :k][order_j],
                                       atol=1e-5, rtol=0)
    assert (lb_p[lb_j > 1e8] > 1e8).all()


@pytest.mark.parametrize("img_w,backface", [(None, False), (64, False), (64, True)])
def test_per_triangle_prepass_matches_jax(img_w, backface):
    v, f = two_cubes()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-3.0, 0.3, 0.1], [6.5, 0.0, 0.2]], [[0, 0, 0.1], [0, 0, np.pi]],
                           res=(16, 64))
    out_j = jt.tri_cull_compact(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c), 20.0, 16,
                                img_w=img_w, backface=backface)
    ids_p, counts_p, lb_p = pt.tri_cull_compact(T(tris), T(o_c), T(d_c), 20.0, 16, img_w,
                                                backface)
    assert ids_p.dtype == torch.int32 and counts_p.dtype == torch.int32
    _assert_lists_match(ids_p, counts_p, lb_p, out_j[3], out_j[1], out_j[2])
    if img_w is not None:  # the wedge culls beyond the reach box
        _, counts_box, _ = pt.tri_cull_compact(T(tris), T(o_c), T(d_c), 20.0, 16)
        assert int(counts_p.sum()) < int(counts_box.sum())
    stats_p = pt.cull_stats(T(tris), T(o_c), T(d_c), cap=16, img_w=img_w)
    stats_j = jt.cull_stats(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c), cap=16,
                            img_w=img_w)
    if backface:  # facing culls beyond the wedge
        _, counts_wedge, _ = pt.tri_cull_compact(T(tris), T(o_c), T(d_c), 20.0, 16, img_w)
        assert int(counts_p.sum()) < int(counts_wedge.sum())
    else:
        assert stats_p == pytest.approx(stats_j)


@pytest.mark.parametrize("img_w,backface", [(None, False), (32, False), (32, True)])
def test_cluster_prepasses_match_jax(img_w, backface):
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-2.03, 0.011, 1.017], [9.0, 0.5, 2.0]],
                           [[0, 0.013, 0.021], [0, 0.1, 2.5]], res=(32, 32))
    args = (20.0, 1024, img_w, backface)
    out_j = jt.tri_cull_compact(jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c), *args)
    ids_p, counts_p, lb_p = pt.tri_cull_compact(T(tris), T(o_c), T(d_c), *args)
    assert ids_p.shape[2] == 1024
    _assert_lists_match(ids_p, counts_p, lb_p, out_j[3], out_j[1], out_j[2], block=pt.CLUSTER)
    cids_j, counts_j, lbc_j, cluster_j = jt._cluster_ids_prepass(
        jnp.asarray(tris), jnp.asarray(o_c), jnp.asarray(d_c), *args)
    cids_p, cnt_p, lbc_p, cluster_p = pt._cluster_ids_prepass(T(tris), T(o_c), T(d_c), *args)
    assert cluster_p == cluster_j == 128
    _assert_lists_match(cids_p, cnt_p, lbc_p, cids_j, counts_j, lbc_j)


def test_lists_as_the_kernel_takes_them():
    """Stages of 64 up to a cap of 1,024 and of 128 above, whole stages
    padded with empty slots, the stage bound the least of its slots'."""
    v, f = cube_grid()
    tris = T(pt.pack_triangles(v, f)[None])
    o_c, d_c = (T(x) for x in camera_rays([[-2.0, 0.0, 1.0]], [[0, 0, 0]], res=(32, 32)))
    small = pt.tile_lists(tris, o_c, d_c, 20.0, 1024, 32, False)
    assert (small.chunk, small.block, small.lb.shape[2]) == (64, 1, 16)
    big = pt.tile_lists(tris, o_c, d_c, 20.0, 1088, 32, False)  # 17 clusters
    assert (big.chunk, big.block, big.lb.shape[2]) == (128, 1, 9)
    assert big.ids.shape[2] == 9 * 128 and (big.ids[..., 1088:] == -1).all()
    assert (big.lb[..., -1] <= 1e9).all() and big.n_stage.dtype == torch.int32
    _, counts, lb = pt.tri_cull_compact(tris, o_c, d_c, 20.0, 1088, 32)
    torch.testing.assert_close(big.lb[0, 0, 0], lb[0, 0, :128].min())
    assert int(big.n_stage[0, 0]) == max(1, -(-min(int(counts[0, 0]), 1088) // 128))
    blocks = pt.block_lists(tris, o_c, d_c, 20.0, 2304, 32, False)
    assert (blocks.chunk, blocks.block, blocks.ids.shape[2]) == (128, 128, 18)


# ---------------------------------------------------------------------------
# the tiers against the interpret-mode Pallas kernels and the brute force
# ---------------------------------------------------------------------------


def _assert_matches_brute(out_p, tris, o_c, d_c, tol=TOL_T):
    t_b, hit_b, n_b, g_b = pt.tri_trace_brute(T(tris), T(o_c.transpose(1, 2, 0)),
                                              T(d_c.transpose(1, 2, 0)))
    t_p, hit_p, n_p, g_p = out_p
    assert torch.equal(hit_p, hit_b)
    torch.testing.assert_close(t_p, t_b, atol=tol, rtol=0)
    torch.testing.assert_close(n_p[hit_b], n_b[hit_b], atol=1e-4, rtol=0)
    unique = torch.from_numpy(_unique_best(tris, o_c, d_c)) & hit_b
    assert torch.equal(g_p[unique], g_b[unique])


def test_tile_tier_ray_origins_matches_jax(interpret_pallas):
    """Per-triangle lists, Möller–Trumbore body (arbitrary ray origins)."""
    v, f = two_cubes()
    tris = pt.pack_triangles(v, f)[None]
    o, d = random_rays(TILE, seed=3)
    out_p, out_j = both_packages(tris, comp(o), comp(d), cap=32)
    assert_same_image(out_p, out_j, tris, comp(o), comp(d))
    _assert_matches_brute(out_p, tris, comp(o), comp(d))


def test_tile_tier_camera_tiles_matches_jax(interpret_pallas):
    """Per-triangle lists with the wedge cull and the signed-volume body:
    two 16×64 cameras, one tile each."""
    v, f = two_cubes()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-3.0, 0.3, 0.1], [6.5, 0.0, 0.2]], [[0, 0, 0.1], [0, 0, np.pi]],
                           res=(16, 64))
    out_p, out_j = both_packages(tris, o_c, d_c, cap=tris.shape[1], img_w=64)
    assert_same_image(out_p, out_j, tris, o_c, d_c)
    _assert_matches_brute(out_p, tris, o_c, d_c)


def test_cluster_tier_matches_jax(interpret_pallas):
    """Morton-cluster lists (T = 2,304), Möller–Trumbore body."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o, d = random_rays(TILE, seed=11, origin=(-4.0, 0.0, 1.0))
    out_p, out_j = both_packages(tris, comp(o), comp(d), cap=tris.shape[1])
    assert_same_image(out_p, out_j, tris, comp(o), comp(d))
    _assert_matches_brute(out_p, tris, comp(o), comp(d))


def test_cluster_tier_camera_matches_jax(interpret_pallas):
    """Morton-cluster lists with the signed-volume body and the 32×32
    repack of a 64×64 camera."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]])
    out_p, out_j = both_packages(tris, o_c, d_c, cap=tris.shape[1], img_w=64,
                                 cam_rays=64 * 64)
    assert_same_image(out_p, out_j, tris, o_c, d_c, tol=1e-3)
    _assert_matches_brute(out_p, tris, o_c, d_c, tol=1e-3)


def test_camera_soup_tier_matches_jax(interpret_pallas, monkeypatch):
    """Per-camera signed volumes over block-id lists, with the repack: one
    64×64 camera off the grid's symmetry axes (rays along shared cube edges
    round differently in the two forms)."""
    v, f = cube_grid()
    tris = pt.pack_triangles(v, f)[None]
    o_c, d_c = camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]])
    out_p, out_j = both_packages(tris, o_c, d_c, tris.shape[1] - 1, monkeypatch,
                                 cap=tris.shape[1], img_w=64, cam_rays=64 * 64)
    assert_same_image(out_p, out_j, tris, o_c, d_c, tol=1e-3)
    _assert_matches_brute(out_p, tris, o_c, d_c, tol=1e-3)


def test_two_scenes_soup_tier_matches_jax(interpret_pallas, monkeypatch):
    """Block-id lists into the shared soup, Möller–Trumbore body, on two
    scenes with soups of different length (the shorter zero-padded)."""
    v1, f1 = cube_grid(8, 8, 3)
    v2, f2 = cube_grid(8, 6, 3)
    p1, p2 = pt.pack_triangles(v1, f1), pt.pack_triangles(v2, f2)
    tris = np.zeros((2, max(len(p1), len(p2)), 9), np.float32)
    tris[0, :len(p1)] = p1
    tris[1, :len(p2)] = p2
    o1, d1 = random_rays(TILE, seed=21, origin=(-4.0, 0.0, 1.0))
    o2, d2 = random_rays(TILE, seed=22, origin=(-4.0, 0.0, 0.5))
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    out_p, out_j = both_packages(tris, comp(o), comp(d), tris.shape[1] - 1, monkeypatch,
                                 cap=tris.shape[1])
    assert_same_image(out_p, out_j, tris, comp(o), comp(d))
    _assert_matches_brute(out_p, tris, comp(o), comp(d))


@pytest.mark.parametrize("soup_min_t", [10 ** 9, 1])
def test_backface_cull_identical_on_closed_mesh(soup_min_t):
    """Backface culling changes no pixel of a closed, consistently wound
    mesh, on the cluster tier and on the per-camera tier."""
    v, f = cube_grid()
    tris = T(pt.pack_triangles(v, f)[None])
    o_c, d_c = (T(x) for x in camera_rays([[-1.57, 0.23, 1.11]], [[0, 0.04, -0.03]]))
    kw = dict(cap=tris.shape[1], img_w=64, cam_rays=64 * 64, soup_min_t=soup_min_t)
    t0, h0, n0, _ = pt.tri_trace_tiled(tris, o_c, d_c, backface=False, **kw)
    t1, h1, n1, _ = pt.tri_trace_tiled(tris, o_c, d_c, backface=True, **kw)
    assert torch.equal(h0, h1) and float(h0.float().mean()) > 0.1
    torch.testing.assert_close(t0, t1, atol=1e-5, rtol=0)
    _, seen, _ = pt.tri_cull_compact(tris, o_c, d_c, 20.0, tris.shape[1], 64, False)
    _, front, _ = pt.tri_cull_compact(tris, o_c, d_c, 20.0, tris.shape[1], 64, True)
    assert int(front.sum()) <= int(seen.sum())


def test_overflow_keeps_nearest_triangles(interpret_pallas):
    """A tile that sees more than ``cap`` keeps its nearest triangles: the
    near cube renders exactly, only the far cube may turn into background,
    and the port degrades as the JAX kernel does."""
    v, f = two_cubes()
    tris = pt.pack_triangles(v, f)[None]
    rng = np.random.default_rng(11)
    o = np.zeros((1, TILE, 3), np.float32) + np.asarray([-3.0, 0.0, 0.0], np.float32)
    d = (rng.normal(size=(1, TILE, 3)) * [0.0, 0.2, 0.2] + [1.0, 0.0, 0.0]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    full, _ = brute_both(tris, comp(o), comp(d))
    out_p, out_j = both_packages(tris, comp(o), comp(d), cap=8)
    tf, hf = full[0].numpy()[0], full[1].numpy()[0]
    tc, hc = out_p[0].numpy()[0], out_p[1].numpy()[0]
    near = hf & (tf < 3.0)
    np.testing.assert_array_equal(hc[near], hf[near])
    np.testing.assert_allclose(tc[near], tf[near], atol=1e-6, rtol=0)
    assert np.all(tc >= tf - 1e-6)
    np.testing.assert_array_equal(hc, np.asarray(out_j[1])[0])
    np.testing.assert_allclose(tc, np.asarray(out_j[0])[0], atol=TOL_T, rtol=0)


def test_early_out_and_count_skip_change_no_pixel():
    """The plain version with every stage forced to run gives the same image
    and the same ids on hits, and counts more tests: a wall in front of the
    camera hides the cubes behind it, so their stages are skipped."""
    v, f = cube_grid()
    wall = np.asarray([[0.5, -50, -50], [0.5, 50, -50], [0.5, 50, 50], [0.5, -50, 50]], np.float32)
    f = np.concatenate([f, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32) + len(v)])
    tris = T(pt.pack_triangles(np.concatenate([v, wall]), f)[None])
    o_c, d_c = (T(x) for x in camera_rays([[-2.03, 0.011, 1.017]], [[0, 0.013, 0.021]],
                                          res=(32, 32)))
    for form, make, tiles in (("sv_tile", pt.tile_lists, 1), ("mt", pt.tile_lists, 1),
                              ("sv_cam", pt.block_lists, 1), ("mt", pt.block_lists, 1)):
        lists = make(tris, o_c, d_c, 20.0, tris.shape[1], 32, False)
        forced = lists._replace(lb=torch.zeros_like(lists.lb),
                                n_stage=torch.full_like(lists.n_stage, lists.lb.shape[2]))
        s0, s1 = {}, {}
        a = tk.tri_first_hit_reference(tris, lists, o_c, d_c, 20.0, form, tiles, stats=s0)
        b = tk.tri_first_hit_reference(tris, forced, o_c, d_c, 20.0, form, tiles, stats=s1)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), form
        assert torch.equal(a[2][a[1]], b[2][b[1]]), form
        assert s0["tests"] < s1["tests"] == lists.lb.shape[2] * lists.chunk * TILE
        # every triangle of the mesh is on the forced list once; few tests pass
        # the body's gate (the sign test; for Möller–Trumbore nearly all do)
        assert s1["real_tests"] == tris.shape[1] * TILE and s0["real_tests"] <= s0["tests"]
        assert 0 < s0["gated"] <= s0["real_tests"] and s0["gated"] <= s1["gated"]
        if form != "mt":
            assert s1["gated"] < 0.25 * s1["real_tests"]


def test_wrapper_checks_its_inputs():
    v, f = two_cubes()
    tris = T(pt.pack_triangles(v, f)[None])
    o, d = random_rays(TILE, seed=1)
    o_c, d_c = T(comp(o)), T(comp(d))
    lists = pt.tile_lists(tris, o_c, d_c, 20.0, 24, None, False)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tk.tri_first_hit(tris, lists, o_c[:, :, :1000], d_c[:, :, :1000])
    with pytest.raises(ValueError, match="form"):
        tk.tri_first_hit(tris, lists, o_c, d_c, form="fast")
    with pytest.raises(TypeError, match="float32"):
        tk.tri_first_hit(tris.double(), lists, o_c, d_c)
    with pytest.raises(ValueError, match="lists do not fit"):
        tk.tri_first_hit(tris, lists._replace(lb=lists.lb[:, :, :0]), o_c, d_c)
    with pytest.raises(ValueError, match="stage takes"):
        tk.tri_first_hit(tris, lists._replace(chunk=256), o_c, d_c)
    with pytest.raises(ValueError, match="multiple of 1024"):
        pt.tri_trace_tiled(tris, o_c[:, :, :1000], d_c[:, :, :1000])


@pytest.mark.parametrize("variant", ["fastest"])
def test_unported_variants_raise(variant):
    """The variants of the per-camera kernel are an explicit argument; a name
    that is none of them raises. (``merged``, ``mx`` and ``wl`` are ported:
    ``tests/test_torch_tri_variants.py``.)"""
    v, f = two_cubes()
    tris = T(pt.pack_triangles(v, f)[None])
    o, d = random_rays(TILE, seed=1)
    with pytest.raises(ValueError, match="variant"):
        pt.tri_trace_tiled(tris, T(comp(o)), T(comp(d)), variant=variant)
    # on a mesh that does not reach the per-camera tier a variant changes nothing
    base = pt.tri_trace_tiled(tris, T(comp(o)), T(comp(d)))
    for name in pt.VARIANTS:
        out = pt.tri_trace_tiled(tris, T(comp(o)), T(comp(d)), variant=name)
        assert all(torch.equal(a, b) for a, b in zip(out, base))


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tiled", [False, True])
def test_gradients_match_jax(tiled, interpret_pallas):
    """∂/∂origins and ∂/∂dirs of Σ g·t against ``jax.grad`` through the JAX
    entry: 1e-4 relative where |n·d| > 0.1."""
    v, f = two_cubes()
    tris = pt.pack_triangles(v, f)[None]
    n = TILE if tiled else 256
    o, d = random_rays(n, seed=7)
    o_c, d_c = comp(o), comp(d)
    g = np.random.default_rng(5).normal(size=(1, n)).astype(np.float32)

    def loss_j(oc, dc):
        t, hit, _, _ = jt.tri_trace_diff(jnp.asarray(tris), oc, dc, 20.0, 32, None, tiled)
        return jnp.sum(t * g)

    go_j, gd_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(o_c), jnp.asarray(d_c))
    o_t, d_t = T(o_c).requires_grad_(True), T(d_c).requires_grad_(True)
    t, hit, normal, gid = pt.tri_trace_diff(T(tris), o_t, d_t, 20.0, 32, None, tiled)
    assert not hit.requires_grad and not normal.requires_grad and not gid.requires_grad
    go_t, gd_t = torch.autograd.grad((t * T(g)).sum(), (o_t, d_t))
    nd = (normal * T(d)).sum(-1).abs().numpy()
    well = hit.numpy() & (nd > 0.1)
    assert well.mean() > 0.3
    for got, ref in ((go_t, go_j), (gd_t, gd_j)):
        got, ref = got.numpy(), np.asarray(ref)
        scale = np.abs(ref[:, well]).max()
        np.testing.assert_allclose(got[:, well], ref[:, well], atol=1e-4 * scale, rtol=0)
        assert (got[:, ~hit.numpy()] == 0).all()


def test_gradient_matches_finite_differences():
    v, f = two_cubes()
    tris = T(pt.pack_triangles(v, f)[None])
    o, d = random_rays(64, seed=7)
    o_c, d_c = T(comp(o)).double(), T(comp(d)).double()

    def total(oc):
        t, hit, _, _ = pt.tri_trace_diff(tris.double(), oc, d_c, 20.0, 32, None, False)
        return torch.where(hit, t, 0.0).sum()

    o_c.requires_grad_(True)
    (g,) = torch.autograd.grad(total(o_c), o_c)
    eps = 1e-6
    for idx in ((0, 0, 0), (1, 0, 5), (2, 0, 17)):
        bump = torch.zeros_like(o_c)
        bump[idx] = eps
        fd = (total(o_c.detach() + bump) - total(o_c.detach() - bump)) / (2 * eps)
        assert abs(float(g[idx]) - float(fd)) < 1e-5 * max(1.0, abs(float(fd)))
