"""The port's trace modes (plain PyTorch versions of the CUDA kernels) vs
``visfly_tpu``'s Pallas tile in interpret mode and its XLA tracer: the
march, plain and over-relaxed, on component-major and packed rays, with a
warm start; the winning-primitive id; the residual refine; dynamic capsules.

Tolerances, each beside its reason:
- march vs the interpret-mode tile, same float32 steps in another op order:
  |Δt| ≤ 1e-4, hit equal (measured: 3e-6);
- the culled march vs the CULLED tile: the same function (the rows of
  ``cull_rows``, filler rows included), so the same |Δt| ≤ 1e-4, hit equal;
- packed vs component entry: the same arithmetic, ≤ 1e-6;
- analytic with refine vs the XLA analytic tracer: ≤ 1e-3, hit equal, the
  bound of ``test_analytic_kernel_matches_xla``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_trace_kernel import _free_rays, _scene, interpret_pallas  # noqa: F401
from visfly_tpu.render.pallas_trace import pallas_trace, pallas_trace_c
from visfly_tpu.render.pallas_trace import prepare_kernel_scene as j_prepare
from visfly_tpu.render.sphere_trace import trace_grouped
from visfly_tpu_torch.interop import kernel_scene_from_numpy, scene_from_numpy
from visfly_tpu_torch.render import trace_kernel
from visfly_tpu_torch.render.trace_kernel import (prepare_kernel_scene, trace_analytic,
                                                  trace_march, trace_march_reference)
from visfly_tpu_torch.scene.prim_scene import _family_split

torch.set_num_threads(1)

TOL_KERNEL = 1e-4
TOL_XLA = 1e-3
R = 2048  # two tiles


def _rays(seed, n=R):
    jsc, sc = _scene("garage_simple", 1)
    o, d = _free_rays(sc, n, seed, [1.0, 0.0, 1.5], [0.5, 2.0, 0.7])
    return jsc, sc, o, d


def _c(x):
    """(R, 3) numpy → (3, 1, R) torch and jax arrays."""
    return torch.from_numpy(x.T.copy())[:, None, :], jnp.asarray(x.T)[:, None, :]


@pytest.mark.parametrize("n_steps,omega", [(40, 1.0), (60, 1.0), (40, 1.5), (60, 1.5)])
def test_march_matches_unculled_tile(interpret_pallas, n_steps, omega):
    jsc, sc, o, d = _rays(11)
    (oc, joc), (dc, jdc) = _c(o), _c(d)
    t_ref, hit_ref, kid_ref = pallas_trace_c(j_prepare(jsc), joc, jdc, None, n_steps=n_steps,
                                             omega=omega, cull=False)
    t, hit = trace_march(prepare_kernel_scene(sc), oc, dc, None, n_steps, omega=omega,
                         cull=False)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=TOL_KERNEL, rtol=0)
    assert (np.asarray(kid_ref) == -1).all()  # a march reports no winner
    assert 0.5 < hit.float().mean() <= 1.0
    assert t.dtype == torch.float32 and hit.dtype == torch.bool


@pytest.mark.parametrize("n_steps", [40, 60])
def test_march_vs_culled_tile(interpret_pallas, n_steps):
    jsc, sc, o, d = _rays(11)
    (oc, joc), (dc, jdc) = _c(o), _c(d)
    t_c, hit_c, _ = pallas_trace_c(j_prepare(jsc), joc, jdc, None, n_steps=n_steps, cull=True)
    t, hit = trace_march(prepare_kernel_scene(sc), oc, dc, None, n_steps, cull=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_c))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_c), atol=TOL_KERNEL, rtol=0)
    assert hit.float().mean() > 0.5


def test_packed_entry_matches_component_and_packed_tile(interpret_pallas):
    jsc, sc, o, d = _rays(5)
    ks = prepare_kernel_scene(sc)
    (oc, _), (dc, _) = _c(o), _c(d)
    t_c, hit_c = trace_march(ks, oc, dc, None, 40)
    t_p, hit_p = trace_march(ks, torch.from_numpy(o)[None], torch.from_numpy(d)[None], None, 40,
                             packed=True)
    np.testing.assert_allclose(t_p.numpy(), t_c.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(hit_p, hit_c)
    t_ref, hit_ref, _ = pallas_trace(j_prepare(jsc), jnp.asarray(o)[None], jnp.asarray(d)[None],
                                     n_steps=40)
    np.testing.assert_array_equal(hit_p.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(t_ref), atol=TOL_KERNEL, rtol=0)


def test_warm_start(interpret_pallas):
    """A march of 20 steps from t_init > 0, on packed rays, as the cone
    prepass starts it."""
    jsc, sc, o, d = _rays(6)
    t0 = np.random.default_rng(0).uniform(0.0, 1.0, (1, R)).astype(np.float32)
    t_ref, hit_ref, _ = pallas_trace(j_prepare(jsc), jnp.asarray(o)[None], jnp.asarray(d)[None],
                                     jnp.asarray(t0), n_steps=20)
    t, hit = trace_march(prepare_kernel_scene(sc), torch.from_numpy(o)[None],
                         torch.from_numpy(d)[None], torch.from_numpy(t0), 20, packed=True)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=TOL_KERNEL, rtol=0)
    t_cold, _ = trace_march(prepare_kernel_scene(sc), torch.from_numpy(o)[None],
                            torch.from_numpy(d)[None], None, 20, packed=True)
    assert (t.numpy() != t_cold.numpy()).any()


def _dynamic(o):
    """Three dynamic objects: one holds the first ray's origin."""
    obj_pos = np.asarray([[o[0], [2.2, 0.0, 1.5], [1.0, 1.5, 2.0]]], np.float32)
    obj_rad = np.asarray([[0.3, 0.4, 0.25]], np.float32)
    return obj_pos, obj_rad


@pytest.mark.parametrize("dynamic", [False, True])
def test_kid_matches_tile(interpret_pallas, dynamic):
    """The winning id equals the interpret-mode tile's on every ray whose
    best and second-best candidates differ by more than 1e-5 (an exact tie
    may break differently after rounding); −1 on misses and on dynamic
    capsules."""
    jsc, sc, o, d = _rays(13)
    objects = _dynamic(o) if dynamic else None
    jks = j_prepare(jsc, None if objects is None else tuple(jnp.asarray(x) for x in objects))
    ks = prepare_kernel_scene(sc, None if objects is None
                              else tuple(torch.from_numpy(x) for x in objects))
    (oc, joc), (dc, jdc) = _c(o), _c(d)
    t_ref, hit_ref, kid_ref = pallas_trace_c(jks, joc, jdc, None, analytic=True, n_refine=0,
                                             cull=True)
    t, hit, kid = trace_analytic(ks, oc, dc, want_kid=True)
    assert kid.dtype == torch.float32 and kid.shape == t.shape
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    # per-row candidates, to find the rays with a unique winner
    tk = torch.cat([trace_kernel._box_t(ks.boxes[0], *_triples(oc, dc)),
                    trace_kernel._capsule_t(ks.capsules[0], *_triples(oc, dc))], dim=1)
    two = torch.topk(tk, 2, dim=1, largest=False).values
    unique = ((two[:, 1] - two[:, 0]) > 1e-5).numpy()
    assert unique.mean() > 0.95
    kid, kid_ref = kid.numpy()[0], np.asarray(kid_ref)[0]
    np.testing.assert_array_equal(kid[unique], kid_ref[unique])
    assert (kid[~hit.numpy()[0]] == -1).all()
    n_rows = sc.params.shape[1]
    assert ((kid >= -1) & (kid < n_rows)).all()
    if dynamic:
        ids = torch.cat([ks.boxes[0, :, 12], ks.capsules[0, :, 8]])
        on_dyn = (ids[torch.argmin(tk, dim=1)] == -1).numpy() & hit.numpy()[0]
        assert on_dyn.sum() > 10 and (kid[on_dyn] == -1).all()
    else:
        assert (kid[hit.numpy()[0]] >= 0).all()


def _triples(oc, dc):
    return (tuple(oc[i, 0, :, None] for i in range(3)), tuple(dc[i, 0, :, None] for i in range(3)))


@pytest.mark.parametrize("n_refine", [0, 2])
def test_analytic_refine_matches_xla(n_refine):
    jsc, sc, o, d = _rays(0)
    t_ref, hit_ref = trace_grouped(jsc, jnp.asarray(o)[None], jnp.asarray(d)[None],
                                   mode="analytic", refine_steps=n_refine)
    (oc, _), (dc, _) = _c(o), _c(d)
    t, hit = trace_analytic(prepare_kernel_scene(sc), oc, dc, n_refine=n_refine)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=TOL_XLA, rtol=0)


def test_analytic_refine_matches_tile(interpret_pallas):
    jsc, sc, o, d = _rays(1)
    (oc, joc), (dc, jdc) = _c(o), _c(d)
    t_ref, hit_ref, kid_ref = pallas_trace_c(j_prepare(jsc), joc, jdc, None, analytic=True,
                                             n_refine=2, cull=False)
    t, hit, kid = trace_analytic(prepare_kernel_scene(sc), oc, dc, want_kid=True, n_refine=2)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    # the analytic candidate of a cylinder cancels badly on some rays 10-14 m
    # out, where float32 resolves t only to ~1.7e-4 in both packages and two
    # refine steps inside the 1 cm hit shell do not move it: such rays
    # (counted, under 1%) are held to the XLA bound
    t, t_ref = t.numpy(), np.asarray(t_ref)
    ill = np.abs(t - t_ref) > TOL_KERNEL
    assert ill.mean() < 0.01, ill.sum()
    np.testing.assert_allclose(t, t_ref, atol=TOL_XLA, rtol=0)


def test_rounded_box_needs_the_refine():
    """A general rounded box (half extents > 0 and radius > 0): the slab
    candidate is a lower bound that 8 refine steps converge. The port agrees
    with the XLA analytic tracer within 1e-3, and with a 256-step march as
    closely as the JAX test asks (p95 < 0.05)."""
    from visfly_tpu.scene import pack_scenes as j_pack
    from visfly_tpu.scene.prim_scene import PrimitiveScene as JScene
    from visfly_tpu.scene.scene import SceneSpec

    spec = SceneSpec(np.asarray([-5.0, -5.0, 0.0]), np.asarray([5.0, 5.0, 4.0]),
                     [{"type": "room", "bounds_min": [-5, -5, 0], "bounds_max": [5, 5, 4],
                       "color": [128, 128, 128], "semantic": 1}], "unit")
    jsc = j_pack([spec])
    rounded = np.zeros((1, 1, 12), np.float32)
    rounded[0, 0, [0, 1, 2, 3, 4, 5, 6, 7, 9, 11]] = [0, 0, 1.5, 1, 1, 1, 0.4, 1, 1, 1]
    params = np.concatenate([np.asarray(jsc.params), rounded], axis=1)
    jsc = JScene(params=jnp.asarray(params), colors=jnp.zeros((1, 2, 3)),
                 semantic=jnp.zeros((1, 2), jnp.int32), bbox=jsc.bbox, eps=jsc.eps,
                 boxes=(), capsules=())
    boxes, capsules = _family_split(params)
    ks = kernel_scene_from_numpy(trace_kernel.KernelScene(boxes, capsules))
    np.testing.assert_array_equal(ks.boxes.numpy(), np.asarray(j_prepare(jsc).boxes))
    rng = np.random.default_rng(5)
    o = (np.asarray([1.0, 0.0, 1.5]) + rng.uniform(-1, 1, (512, 3)) * [0.5, 2.0, 0.7])
    o = o.astype(np.float32)
    d = rng.normal(size=(512, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jo, jd = jnp.asarray(o)[None], jnp.asarray(d)[None]
    t_an, _ = trace_grouped(jsc, jo, jd, mode="analytic", refine_steps=8)
    t_march, _ = trace_grouped(jsc, jo, jd, n_steps=256, compute_dtype=jnp.float32)
    (oc, _), (dc, _) = _c(o), _c(d)
    t, _ = trace_analytic(ks, oc, dc, n_refine=8)
    t0, _ = trace_analytic(ks, oc, dc, n_refine=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_an), atol=TOL_XLA, rtol=0)
    assert np.percentile(np.abs(t.numpy() - np.asarray(t_march)), 95) < 0.05
    assert (t.numpy() - t0.numpy()).max() > 0.05  # the refine moved the lower bounds


def test_dynamic_capsules_in_the_march(interpret_pallas):
    """A dynamic object appends as a capsule the march hits, and the ray
    whose origin it holds does not see it."""
    jsc, sc = _scene("garage_simple", 1)
    obj = (np.asarray([[[2.0, 0.0, 1.5]]], np.float32), np.asarray([[0.4]], np.float32))
    ks_plain = prepare_kernel_scene(sc)
    ks_obj = prepare_kernel_scene(sc, tuple(torch.from_numpy(x) for x in obj))
    assert ks_obj.capsules.shape[1] == ks_plain.capsules.shape[1] + 1
    o = np.tile(np.asarray([[0.0, 0.0, 1.5]], np.float32), (1024, 1))
    o[1] = [2.1, 0.0, 1.5]  # inside the object
    d = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (1024, 1))
    (oc, joc), (dc, jdc) = _c(o), _c(d)
    t_with, _ = trace_march(ks_obj, oc, dc, None, 40)
    t_without, _ = trace_march(ks_plain, oc, dc, None, 40)
    assert float(t_with[0, 0]) < float(t_without[0, 0])
    np.testing.assert_allclose(float(t_with[0, 0]), 1.6, atol=0.05)
    assert float(t_with[0, 1]) == float(t_without[0, 1])
    t_ref, _, _ = pallas_trace_c(j_prepare(jsc, tuple(jnp.asarray(x) for x in obj)), joc, jdc,
                                 None, n_steps=40, cull=False)
    np.testing.assert_allclose(t_with.numpy(), np.asarray(t_ref), atol=TOL_KERNEL, rtol=0)


def test_march_wrapper_on_cpu_runs_the_plain_version_and_checks_inputs():
    _, sc, o, d = _rays(2, 700)  # a ragged ray count
    ks = prepare_kernel_scene(sc)
    (oc, _), (dc, _) = _c(o), _c(d)
    before = dict(trace_kernel.LAUNCHES)
    t, hit = trace_march(ks, oc, dc, None, 12, omega=1.2, cull=False)  # the cull takes whole tiles
    stats = {}
    t_ref, hit_ref = trace_march_reference(ks, oc, dc, None, 12, omega=1.2, chunk=333,
                                           stats=stats)
    assert trace_kernel.LAUNCHES == before
    torch.testing.assert_close(t, t_ref, rtol=0, atol=0)
    assert torch.equal(hit, hit_ref)
    assert 700 < stats["sdf_evals"] <= 700 * 13  # done rays stop counting
    op, dp = torch.from_numpy(o)[None], torch.from_numpy(d)[None]
    with pytest.raises(ValueError):
        trace_march(ks, op, dp, None, 12, omega=1.5, packed=True)
    with pytest.raises(ValueError):
        trace_march(ks, op, dp, None, 12)  # packed rays without packed=True
    with pytest.raises(ValueError):
        trace_march(ks, oc, dc, torch.zeros(1, 3), 12)
    with pytest.raises(TypeError):
        trace_march(ks, oc.double(), dc.double(), None, 12)
