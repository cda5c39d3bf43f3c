"""The port's benchmark scripts (``visfly_tpu_torch/examples/fps_test.py`` and
``tri_bench.py``) against the JAX package's ``examples/fps_test.py`` and
``examples/tri_bench.py``, at a small size on the CPU, and the dense tier's
block size (``soup_cluster``) against the brute force.

``fps_test``: the JAX script's ``main`` runs with its ``measure`` replaced by
a recorder, so its envs are built exactly as the script builds them and none
is run; the port's ``envs`` builds the same labels, classes and agent counts,
and from each JAX reset state, carried over with ``interop``, one step with
the same actions gives positions within 1e-5 and depth within 1e-3 m on all
but 2 pixels per 1,024. ``tri_bench``: the mesh and the cameras equal to the
JAX script's, a frame of the exact lists within 1e-4 m of ``tri_trace_xla``
(hit flags equal on all but 2 rays per 1,024), and ``main`` with
``--check``.
"""
import argparse
import importlib.util
import math
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu.render import tri_trace as jt
from visfly_tpu.render.camera import camera_rays_components as j_camera_rays_components
from visfly_tpu_torch.core import quaternion as quat
from visfly_tpu_torch.examples import fps_test, tri_bench
from visfly_tpu_torch.interop import env_state_from_numpy
from visfly_tpu_torch.render.camera import camera_rays_components
from visfly_tpu_torch.render import tri_trace as pt
from visfly_tpu_torch.render.tri_kernel import MAX_CHUNK

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
DEPTH_TOL = 1e-3
POS_TOL = 1e-5
MAX_DEPTH = 20.0


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_script(name):
    """A script of ``examples/`` as a module (its ``main`` not run), with
    ``examples/`` importable while it loads and JAX's compilation cache
    setting, which the scripts change, put back."""
    cache = jax.config.jax_compilation_cache_dir
    sys.path.insert(0, EXAMPLES)
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_bench_{name}",
                                                      os.path.join(EXAMPLES, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(EXAMPLES)
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def assert_images_close(got, ref, tol):
    """(N, C, H, W) images equal within ``tol`` on all but 2 pixels per
    1,024 of each."""
    got = np.asarray(got).astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    assert got.shape == ref.shape
    off = (np.abs(got - ref) > tol).any(axis=1)
    allowed = 2 * -(-off[0].size // 1024)
    assert off.sum(axis=(1, 2)).max() <= allowed, (int(off.sum()), np.argwhere(off)[:6])


@pytest.fixture(scope="module")
def jfps():
    return jax_script("fps_test")


@pytest.fixture(scope="module")
def jtb():
    return jax_script("tri_bench")


# ---------------------------------------------------------------------------
# fps_test
# ---------------------------------------------------------------------------


def jax_fps_envs(jfps, argv, tmp_path, monkeypatch):
    """The envs the JAX script's ``main`` builds for ``argv``, in order, as
    ``[(label, env)]``; none is run."""
    built = []
    monkeypatch.setattr(jfps, "measure", lambda env, steps, label: built.append((label, env)))
    monkeypatch.setattr(sys, "argv", ["fps_test.py", *argv])
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.syspath_prepend(EXAMPLES)
    jfps.main()
    return built


def test_fps_envs_match_jax(jfps, tmp_path, monkeypatch):
    argv = ["--agents", "4", "--scenes", "2", "--mesh"]
    want = jax_fps_envs(jfps, argv, tmp_path, monkeypatch)
    args = argparse.Namespace(agents=4, steps=50, scenes=2, mesh=True)
    got = fps_test.envs(args, device="cpu")
    assert [label for label, _ in got] == [label for label, _ in want]
    assert len(got) == 5
    rng = np.random.RandomState(0)
    for (label, tenv), (_, jenv) in zip(got, want):
        assert type(tenv).__name__ == type(jenv).__name__, label
        assert tenv.num_envs == jenv.num_envs and tenv.num_scene == jenv.num_scene, label
        assert tenv.visual == jenv.visual, label
        n = jenv.num_envs
        jst, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
        a = rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)
        jst1, jout = jenv.step(jst, jnp.asarray(a))
        tst1, tout = tenv.step(env_state_from_numpy(to_numpy(jst)), torch.as_tensor(a))
        # an agent that ended its episode restarts from a fresh draw of each
        # package's own generator
        live = ~np.asarray(jout.done)
        assert live.sum() >= n // 2, label
        np.testing.assert_allclose(tst1.dyn.pos.numpy()[live], np.asarray(jst1.dyn.pos)[live],
                                   atol=POS_TOL, err_msg=label)
        if jenv.visual:
            depth = tout.obs["depth"].numpy()
            assert depth.shape == (n, 1, 64, 64), label
            assert_images_close(depth[live], np.asarray(jout.obs["depth"])[live], DEPTH_TOL)
        else:
            assert "depth" not in tout.obs


def test_fps_main_returns_five_rates():
    out = fps_test.main(["--agents", "4", "--steps", "50", "--scenes", "2", "--mesh"],
                        device="cpu")
    assert len(out) == 5
    assert all(math.isfinite(v) and v > 0 for v in out.values()), out


def test_scripts_need_the_card_they_are_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the scripts run there")
    with pytest.raises((RuntimeError, AssertionError)):
        fps_test.main(["--agents", "2", "--steps", "50"])
    with pytest.raises((RuntimeError, AssertionError)):
        tri_bench.main(["--levels", "0", "--cams", "1", "--res", "32", "--iters", "1"])


# ---------------------------------------------------------------------------
# tri_bench
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("level", [0, 1, 2])
def test_garage_mesh_matches_jax(jtb, level, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    v_j, f_j = jtb.load_garage(level)
    v_p, f_p = tri_bench.load_garage(level)
    assert v_p.dtype == v_j.dtype and f_p.dtype == f_j.dtype
    assert v_p.shape == v_j.shape and f_p.shape == f_j.shape == (360 * 4 ** level, 3)
    assert np.array_equal(v_p, v_j) and np.array_equal(f_p, f_j)
    v0, f0 = tri_bench.load_garage(0)
    v_s, f_s = tri_bench.subdivide(v0, f0, level)
    v_js, f_js = jtb.subdivide(v0, f0, level)
    assert np.array_equal(v_s, v_js) and np.array_equal(f_s, f_js)


def test_camera_batch_matches_jax(jtb):
    pos_j, q_j = jtb.camera_batch(256)
    pos_p, q_p = tri_bench.camera_batch(256, device="cpu")
    assert np.array_equal(pos_p.numpy(), np.asarray(pos_j))
    np.testing.assert_allclose(q_p.numpy(), np.asarray(q_j), atol=1e-6)


def test_frame_matches_tri_trace_xla(jtb, tmp_path, monkeypatch):
    """A level-1 frame (1,440 triangles) on 2 cameras at 32×32 through the
    port's plain version with exact lists, against the JAX brute force on
    the JAX script's own cameras and rays."""
    monkeypatch.setattr(tempfile, "gettempdir", lambda: str(tmp_path))
    cams, res = 2, 32
    v, f = jtb.load_garage(1)
    packed = jt.pack_triangles(v, f)
    T = packed.shape[0]
    spec = {"sensor_type": "depth", "resolution": [res, res]}
    pos, q = jtb.camera_batch(cams)
    o_c, d_c, _ = j_camera_rays_components(spec, pos, q)
    hw = res * res
    o_x = jnp.broadcast_to(o_c[:, :, None], (3, cams, hw)).reshape(3, 1, -1).transpose(1, 2, 0)
    d_x = d_c.reshape(3, 1, -1).transpose(1, 2, 0)
    t_j, hit_j = (np.asarray(x) for x in jt.tri_trace_xla(jnp.asarray(packed[None]), o_x, d_x,
                                                           MAX_DEPTH)[:2])

    o_p, d_p = tri_bench.batch_rays(cams, res, "cpu")
    tris = torch.as_tensor(pt.pack_triangles(*tri_bench.load_garage(1))[None])
    assert tris.shape[1] == T
    t_p, hit_p = pt.tri_trace_tiled(tris, o_p, d_p, MAX_DEPTH, T, img_w=res, cam_rays=hw)[:2]
    t_p, hit_p = t_p.numpy(), hit_p.numpy()
    assert (hit_p != hit_j).sum() <= 2 * -(-hit_j.size // 1024)
    both = hit_p & hit_j
    assert both.mean() > 0.9
    np.testing.assert_allclose(t_p[both], t_j[both], atol=1e-4)


def test_tri_bench_main_checks_exact_lists():
    """Level 1 (per-triangle lists) and level 3 (23,040 triangles: block
    lists, the per-camera tier) with ``cap = T``: no hit differs from the
    brute force."""
    out = tri_bench.main(["--levels", "1", "3", "--cams", "2", "--res", "32", "--iters", "1",
                          "--cap", "23040", "--check"], device="cpu")
    lv1, lv3 = out["levels"]
    assert (lv1["T"], lv1["cap"], lv1["tier"]) == (1440, 23040, "tri_trace_tile_sv")
    assert (lv3["T"], lv3["cap"], lv3["tier"], lv3["block"]) == (23040, 23040,
                                                                 "tri_trace_camsoup", 128)
    for lv in (lv1, lv3):
        c = lv["check"]
        assert c["rays"] == 2048 and c["rays_past_cap"] == 0 and c["hit_mismatches"] == 0, c
        assert c["depth_err_max"] <= 1e-3 and c["untied_id_mismatches"] == 0, c
        assert all(math.isfinite(lv[k]) and lv[k] > 0
                   for k in ("ms", "cam_fps", "mray_s", "prepass_ms", "kernel_ms"))


def test_tri_bench_check_is_exact_within_the_cap():
    """Level 2 (5,760 triangles) at the default cap: some tiles see more than
    it keeps; the rays of the others agree with the brute force."""
    out = tri_bench.main(["--levels", "2", "--cams", "2", "--iters", "1", "--check"],
                         device="cpu")
    c = out["levels"][0]["check"]
    assert out["levels"][0]["cap"] == pt.default_tri_cap(5760)
    assert 0 < c["rays_past_cap"] < c["rays"], c
    assert c["hit_mismatches_within_cap"] == 0 and c["untied_id_mismatches_within_cap"] == 0, c
    assert c["depth_err_max_within_cap"] <= 1e-3, c
    assert c["hit_mismatches"] >= c["hit_mismatches_within_cap"]


# ---------------------------------------------------------------------------
# soup_cluster
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_scene():
    """The level-3 garage (23,040 triangles, 90 blocks of 256) and 2 cameras
    at 32×32."""
    tris = torch.as_tensor(pt.pack_triangles(*tri_bench.load_garage(3))[None])
    o_c, d_c = tri_bench.batch_rays(2, 32, "cpu")
    want = pt.tri_trace_brute(tris, o_c.permute(1, 2, 0), d_c.permute(1, 2, 0), MAX_DEPTH)
    return tris, o_c, d_c, want


@pytest.mark.parametrize("cluster", [32, 64, 128, 256])
def test_soup_cluster_matches_brute(dense_scene, cluster):
    tris, o_c, d_c, want = dense_scene
    T = tris.shape[1]
    plan = pt.plan_tiles(tris, o_c, d_c, MAX_DEPTH, T, 32, 1024, soup_min_t=2048,
                         soup_cluster=cluster)
    assert plan.form == "sv_cam" and plan.lists.block == min(cluster, MAX_CHUNK)
    t, hit = pt.tri_trace_tiled(tris, o_c, d_c, MAX_DEPTH, T, 32, 1024, soup_min_t=2048,
                                soup_cluster=cluster)[:2]
    assert torch.equal(hit, want[1])
    assert float((t - want[0]).abs()[hit].max()) <= 1e-4


def test_soup_cluster_256_expands_to_stages(dense_scene):
    tris, o_c, d_c, _ = dense_scene
    T = tris.shape[1]
    cids, counts, lb_c, cluster = pt._cluster_ids_prepass(tris, o_c, d_c, MAX_DEPTH, T, 32,
                                                          soup_cluster=256)
    assert cluster == 256 and cids.shape[-1] == T // 256
    lists = pt._as_block_lists(cids, counts, lb_c, cluster)
    assert lists.chunk == lists.block == MAX_CHUNK
    ids = lists.ids.to(torch.int64)
    assert torch.equal(ids[..., 0::2], 2 * cids.to(torch.int64))
    assert torch.equal(ids[..., 1::2], 2 * cids.to(torch.int64) + 1)
    assert torch.equal(lists.lb[..., 0::2], lb_c) and torch.equal(lists.lb[..., 1::2], lb_c)
    assert torch.equal(lists.n_stage, torch.clamp(2 * counts, 1, 2 * cids.shape[-1]).int())
    # a size the mesh does not divide is halved until it does; None keeps 128
    assert pt._cluster_ids_prepass(tris, o_c, d_c, MAX_DEPTH, T, 32, soup_cluster=1024)[3] == 512
    assert pt._cluster_ids_prepass(tris, o_c, d_c, MAX_DEPTH, T, 32)[3] == 128
    with pytest.raises(ValueError, match="whole number of stages"):
        pt._as_block_lists(cids, counts, lb_c, 192)


# ---------------------------------------------------------------------------
# t of the signed-volume bodies on sliver triangles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("yaw_deg", [-45.0, 0.0, 60.0])
def test_signed_volume_depth_on_slivers(yaw_deg):
    """A pillar face (0.6 m by 3.5 m) subdivided four times into slivers of
    3.75 by 22 cm, as the 92,160-triangle garage's pillars are, seen from 9 m
    by a 20° camera: the signed-volume tier's depth within 1e-5 m of the
    float64 first hit, hits equal (the kernels' own t is not:
    ``chip_profile.py plane``)."""
    x0, dist, res = 12.0, 9.0, 32
    v = np.array([[x0, -0.3, 0.0], [x0, 0.3, 0.0], [x0, 0.3, 3.5], [x0, -0.3, 3.5]], np.float32)
    v, f = tri_bench.subdivide(v, np.array([[0, 1, 2], [0, 2, 3]], np.int32), 4)
    tris = torch.as_tensor(pt.pack_triangles(v, f)[None])
    T = tris.shape[1]
    yaw = np.deg2rad(yaw_deg)
    pos = torch.tensor([[x0 - dist * np.cos(yaw), -dist * np.sin(yaw), 1.75]],
                       dtype=torch.float32)
    q = quat.from_euler(torch.zeros(1), torch.zeros(1), torch.tensor([yaw], dtype=torch.float32))
    o_c, d_c, _ = camera_rays_components({"sensor_type": "depth", "resolution": [res, res],
                                          "hfov": 20}, pos, q)
    o = o_c[:, :, None].expand(3, 1, res * res).reshape(3, 1, -1).contiguous()
    d = d_c.reshape(3, 1, -1).contiguous()
    assert pt.plan_tiles(tris, o, d, MAX_DEPTH, T, res, res * res).form == "sv_tile"
    t, hit = pt.tri_trace_tiled(tris, o, d, MAX_DEPTH, T, res, res * res)[:2]
    want = pt.tri_trace_brute(tris.double(), o.permute(1, 2, 0).double(),
                              d.permute(1, 2, 0).double(), MAX_DEPTH)
    assert torch.equal(hit, want[1]) and hit.float().mean() > 0.05
    assert float((t.double() - want[0]).abs()[hit].max()) <= 1e-5
