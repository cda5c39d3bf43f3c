"""The port's analytic trace (plain PyTorch version of the CUDA kernel) vs
``visfly_tpu``'s Pallas kernel in interpret mode and its XLA tracer.

(a) ``pallas_trace_c(analytic=True, n_refine=0, cull=True)`` in interpret
    mode: the same float32 formulas in another op order, hit equal, t within
    1e-4 wherever float32 resolves t: on rays where both packages lie within
    5e-5 of a float64 evaluation of the same formulas. The cylinder
    quadratic cancels badly on some rays 10-14 m out, where both stray up to
    1.7e-4 from float64; such rays (counted, under 1%) are held to the 1e-3
    of (b) instead;
(b) ``trace_grouped(mode="analytic")``: t within 1e-3, hit equal, the
    tolerance of ``test_analytic_kernel_matches_xla``, because the XLA path
    adds one final residual SDF evaluation.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from visfly_tpu.core import quaternion as jquat
from visfly_tpu.render import camera as jcamera
from visfly_tpu.render.pallas_trace import pallas_trace_c
from visfly_tpu.render.pallas_trace import prepare_kernel_scene as j_prepare
from visfly_tpu.render.sphere_trace import trace_grouped
from visfly_tpu.scene import make_scene as j_make_scene
from visfly_tpu.scene import pack_scenes as j_pack
from visfly_tpu_torch.core import quaternion as tquat
from visfly_tpu_torch.interop import scene_from_numpy
from visfly_tpu_torch.render import camera as tcamera
from visfly_tpu_torch.render import trace_kernel
from visfly_tpu_torch.render.trace_kernel import (KernelScene, prepare_kernel_scene,
                                                  trace_analytic, trace_analytic_reference)
from visfly_tpu_torch.scene import prim_sdf

torch.set_num_threads(1)

TOL_KERNEL = 1e-4  # vs the Pallas tile in interpret mode
TOL_XLA = 1e-3  # vs the XLA tracer, which adds a residual evaluation
TILE = 1024


@pytest.fixture
def interpret_pallas():
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", patched):
        yield


def _free_rays(sc_t, n, seed, center, half, margin=0.1):
    """n rays with origins in free space (SDF > margin: away from the 5 cm
    inside-capsule band, where the kernel and the XLA tracer differ by
    design) and unit directions, (n, 3) float32 each."""
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(o) for o in out) < n:
        o = (np.asarray(center) + rng.uniform(-1, 1, (4 * n, 3)) * np.asarray(half))
        o = o.astype(np.float32)
        keep = prim_sdf(sc_t.params[0], torch.from_numpy(o)).numpy() > margin
        out.append(o[keep])
    o = np.concatenate(out)[:n]
    d = rng.normal(size=(n, 3))
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _scene(preset, seed):
    jsc = j_pack([j_make_scene(preset, seed=seed)])
    return jsc, scene_from_numpy(jax.tree_util.tree_map(np.asarray, jsc))


def _camera_rays(n_cam=2):
    spec = {"sensor_type": "depth", "resolution": [16, 64]}  # 1024 rays = one tile
    pos = np.asarray([[1.0, 0.0, 1.5], [2.0, 1.0, 1.0]], np.float32)[:n_cam]
    yaw = np.asarray([0.3, 2.2], np.float32)[:n_cam]
    q = jquat.from_euler(jnp.zeros(n_cam), jnp.zeros(n_cam), jnp.asarray(yaw))
    o_c, d_c, _ = jcamera.camera_rays_components(spec, jnp.asarray(pos), q)
    o = np.broadcast_to(np.asarray(o_c)[:, :, None], (3, n_cam, TILE)).reshape(3, -1)
    d = np.asarray(d_c).reshape(3, -1)
    return o.T.copy(), d.T.copy()


def _case(name):
    """(jax scene, port scene, origins (R, 3), dirs (R, 3), objects, img_w)."""
    if name == "random_rays":
        jsc, sc = _scene("garage_simple", 1)
        o, d = _free_rays(sc, TILE, 0, [1.0, 0.0, 1.5], [0.5, 2.0, 0.7])
        return jsc, sc, o, d, None, None
    if name == "camera_tiles":
        jsc, sc = _scene("garage_simple", 1)
        return (jsc, sc, *_camera_rays(), None, 64)
    if name == "dynamic_capsules":
        jsc, sc = _scene("garage_simple", 1)
        o, d = _free_rays(sc, TILE, 1, [1.0, 0.0, 1.5], [0.5, 2.0, 0.7])
        # object 0 holds the first rays' origins (self-exclusion); objects 1
        # and 2 stand in front of the spawn region
        obj_pos = np.asarray([[o[0], [2.2, 0.0, 1.5], [1.0, 1.5, 2.0]]], np.float32)
        obj_rad = np.asarray([[0.3, 0.4, 0.25]], np.float32)
        return jsc, sc, o, d, (obj_pos, obj_rad), None
    if name == "forest_room":
        jsc, sc = _scene("forest", 2)
        o, d = _free_rays(sc, TILE, 2, [0.0, 0.0, 2.0], [8.0, 8.0, 1.5])
        return jsc, sc, o, d, None, None
    if name == "box_random_spheres":
        jsc, sc = _scene("box_random", 3)
        o, d = _free_rays(sc, TILE, 3, [0.0, 0.0, 2.0], [6.0, 6.0, 1.5])
        return jsc, sc, o, d, None, None
    raise ValueError(name)


CASES = ["random_rays", "camera_tiles", "dynamic_capsules", "forest_room",
         "box_random_spheres"]


def _port_trace(sc, o, d, objects):
    obj = None if objects is None else tuple(torch.from_numpy(x) for x in objects)
    ks = prepare_kernel_scene(sc, obj)
    oc = torch.from_numpy(o.T.copy())[:, None, :]
    dc = torch.from_numpy(d.T.copy())[:, None, :]
    t, hit = trace_analytic(ks, oc, dc, 20.0)
    return ks, t.numpy(), hit.numpy()


@pytest.mark.parametrize("name", CASES)
def test_matches_pallas_kernel_interpret(interpret_pallas, name):
    jsc, sc, o, d, objects, img_w = _case(name)
    jobj = None if objects is None else tuple(jnp.asarray(x) for x in objects)
    jks = j_prepare(jsc, jobj)
    t_ref, hit_ref = pallas_trace_c(jks, jnp.asarray(o.T)[:, None, :],
                                    jnp.asarray(d.T)[:, None, :], None, analytic=True,
                                    n_refine=0, cull=True, img_w=img_w, want_kid=False)
    ks, t, hit = _port_trace(sc, o, d, objects)
    np.testing.assert_array_equal(ks.boxes.numpy(), np.asarray(jks.boxes))
    np.testing.assert_array_equal(ks.capsules.numpy(), np.asarray(jks.capsules))
    np.testing.assert_array_equal(hit, np.asarray(hit_ref))
    t_ref = np.asarray(t_ref)
    t64, _ = trace_analytic_reference(
        KernelScene(ks.boxes.double(), ks.capsules.double()),
        torch.from_numpy(o.T.astype(np.float64))[:, None, :],
        torch.from_numpy(d.T.astype(np.float64))[:, None, :])
    t64 = t64.numpy()
    ill = (np.abs(t - t64) > TOL_KERNEL / 2) | (np.abs(t_ref - t64) > TOL_KERNEL / 2)
    assert ill.mean() < 0.01, ill.sum()
    np.testing.assert_allclose(t[~ill], t_ref[~ill], atol=TOL_KERNEL, rtol=0)
    np.testing.assert_allclose(t[ill], t_ref[ill], atol=TOL_XLA, rtol=0)
    assert 0.3 < hit.mean() <= 1.0


@pytest.mark.parametrize("name", CASES)
def test_matches_xla_analytic_tracer(name):
    jsc, sc, o, d, objects, _ = _case(name)
    jobj = None if objects is None else tuple(jnp.asarray(x) for x in objects)
    t_ref, hit_ref = trace_grouped(jsc, jnp.asarray(o)[None], jnp.asarray(d)[None], jobj,
                                   mode="analytic")
    _, t, hit = _port_trace(sc, o, d, objects)
    np.testing.assert_array_equal(hit, np.asarray(hit_ref))
    np.testing.assert_allclose(t, np.asarray(t_ref), atol=TOL_XLA, rtol=0)


def test_cases_cover_every_primitive_branch():
    """The cases above reach rooms, solid boxes, spheres, static and dynamic
    capsules, and origins inside a dynamic capsule."""
    _, sc, o, _, objects, _ = _case("dynamic_capsules")
    ks = prepare_kernel_scene(sc, tuple(torch.from_numpy(x) for x in objects))
    assert (ks.boxes[0, :, 9] < 0).any() and (ks.capsules[0, :, 7] == 2.0).any()
    assert np.linalg.norm(o - objects[0][0, 0], axis=-1).min() < 0.3
    _, sc, *_ = _case("box_random_spheres")
    box = sc.boxes[0][sc.boxes[0, :, 11] > 0.5]
    assert (box[:, 3:6].sum(-1) < 1e-6).any() and (box[:, 3:6].sum(-1) > 1e-6).any()


def test_self_exclusion_and_static_inside():
    """An origin inside a dynamic capsule ignores it; inside a static one
    it hits at t = 0."""
    _, sc = _scene("garage_simple", 1)
    o = torch.tensor([[1.0], [0.0], [1.5]]).expand(3, 4)[:, None, :].contiguous()
    d = torch.tensor([[1.0], [0.0], [0.0]]).expand(3, 4)[:, None, :].contiguous()
    t_plain, _ = trace_analytic(prepare_kernel_scene(sc), o, d)
    obj = (torch.tensor([[[1.0, 0.0, 1.5]]]), torch.tensor([[0.3]]))
    t_dyn, _ = trace_analytic(prepare_kernel_scene(sc, obj), o, d)
    torch.testing.assert_close(t_dyn, t_plain, rtol=0, atol=0)
    ks = prepare_kernel_scene(sc, obj)
    caps = ks.capsules.clone()
    caps[0, -1, 7] = 1.0  # the same capsule, static
    t_static, hit = trace_analytic(ks._replace(capsules=caps), o, d)
    assert (t_static == 0).all() and hit.all()


def test_ragged_ray_count():
    """R need not be a multiple of 1024."""
    jsc, sc, o, d, _, _ = _case("random_rays")
    _, t_full, _ = _port_trace(sc, o, d, None)
    _, t_part, _ = _port_trace(sc, o[:700], d[:700], None)
    np.testing.assert_array_equal(t_part, t_full[:, :700])


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    _, sc, o, d, _, _ = _case("random_rays")
    ks = prepare_kernel_scene(sc)
    oc = torch.from_numpy(o.T.copy())[:, None, :]
    dc = torch.from_numpy(d.T.copy())[:, None, :]
    before = dict(trace_kernel.LAUNCHES)
    t, hit = trace_analytic(ks, oc, dc)
    t_ref, hit_ref = trace_analytic_reference(ks, oc, dc, chunk=333)
    assert trace_kernel.LAUNCHES == before
    torch.testing.assert_close(t, t_ref, rtol=0, atol=0)
    assert torch.equal(hit, hit_ref) and t.dtype == torch.float32 and hit.dtype == torch.bool


def test_wrapper_rejects_bad_inputs():
    _, sc, o, d, _, _ = _case("random_rays")
    ks = prepare_kernel_scene(sc)
    oc = torch.from_numpy(o.T.copy())[:, None, :]
    dc = torch.from_numpy(d.T.copy())[:, None, :]
    with pytest.raises(ValueError):
        trace_analytic(ks, oc[:2], dc[:2])
    with pytest.raises(TypeError):
        trace_analytic(ks, oc.double(), dc.double())
    with pytest.raises(ValueError):
        trace_analytic(ks._replace(boxes=ks.boxes[:, :, :12]), oc, dc)
    with pytest.raises(ValueError):
        trace_analytic(ks, oc.to("meta"), dc.to("meta"))


@pytest.mark.parametrize("spec", [
    {"resolution": [16, 64]},
    {"resolution": [8, 12], "hfov": 70.0, "position": [0.1, 0.0, 0.05],
     "orientation": [0.0, 0.3, 0.1]},
])
def test_camera_rays_match_jax(spec):
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    q = rng.normal(size=(3, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    ref = jcamera.camera_rays_components(spec, jnp.asarray(pos), jnp.asarray(q))
    out = tcamera.camera_rays_components(spec, torch.from_numpy(pos), torch.from_numpy(q))
    for r, x in zip(ref, out):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    dirs_j, fwd_j = jcamera.pixel_dirs_body(spec)
    dirs_t, fwd_t = tcamera.pixel_dirs_body(spec)
    np.testing.assert_array_equal(dirs_t, dirs_j)
    np.testing.assert_array_equal(fwd_t, fwd_j)
    np.testing.assert_allclose(tquat.to_rotation_matrix(torch.from_numpy(q)).numpy(),
                               np.asarray(jquat.to_rotation_matrix(jnp.asarray(q))), atol=1e-7)
