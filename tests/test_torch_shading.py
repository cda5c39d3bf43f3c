"""Shading, lighting and the cone prepass of the port vs ``visfly_tpu``: the
same hit points, hit masks and winning ids (numpy, from a seed) go through
both packages.

Tolerances: the float shade agrees within 1e-3 (of 0..255) before the uint8
cast: the port gathers a row where the JAX package multiplies by a one-hot
matrix, and sums lights in another order. After the cast, a value that lies
within that 1e-3 of an integer may truncate to the neighbouring count: uint8
images are equal on ≥ 99.5% of pixels and within 1 count elsewhere. Shading
by the reported id agrees with shading by the nearest primitive on > 98% of
hit pixels, the JAX test's own bound (edge ties differ).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_trace_kernel import _free_rays, _scene
from visfly_tpu.render import camera as jcamera
from visfly_tpu.render import sphere_trace as jst
from visfly_tpu.scene.prim_scene import prim_normal_single as j_normal
from visfly_tpu_torch.interop import lighting_from_numpy
from visfly_tpu_torch.render import camera as tcamera
from visfly_tpu_torch.render import sphere_trace as tst
from visfly_tpu_torch.render.trace_kernel import prepare_kernel_scene, trace_analytic
from visfly_tpu_torch.scene import prim_normal_single, scene_sdf_grouped

torch.set_num_threads(1)

TOL_SHADE = 1e-3
LIGHTING = {"ambient": 0.3, "attenuation": 0.05, "lights": [
    {"type": "directional", "direction": [0.2, -0.3, -1.0], "color": [1.0, 0.95, 0.9],
     "intensity": 0.6},
    {"type": "point", "position": [2.0, 0.5, 2.5], "color": [1.0, 0.8, 0.6], "intensity": 1.5}]}
R = 2048


def _hits(seed, objects=None):
    """(jax scene, port scene, p_hit (1, R, 3), hit (1, R), kid (1, R)) as
    numpy, from the port's analytic trace."""
    jsc, sc = _scene("garage_simple", 1)
    o, d = _free_rays(sc, R, seed, [1.0, 0.0, 1.5], [0.5, 2.0, 0.7])
    obj = None if objects is None else tuple(torch.from_numpy(x) for x in objects)
    t, hit, kid = trace_analytic(prepare_kernel_scene(sc, obj),
                                 torch.from_numpy(o.T.copy())[:, None, :],
                                 torch.from_numpy(d.T.copy())[:, None, :], want_kid=True)
    p_hit = o[None] + d[None] * t.numpy()[..., None]
    return jsc, sc, p_hit.astype(np.float32), hit.numpy(), kid.numpy()


def _lighting(kind):
    if kind == "default":
        return None, None
    baked = jst.bake_lighting(LIGHTING)
    return baked, lighting_from_numpy(jax.tree_util.tree_map(np.asarray, baked))


def _assert_images(shaded, ref, want):
    """Float shade, then the uint8 image as render_camera casts it."""
    np.testing.assert_allclose(shaded, ref, atol=TOL_SHADE, rtol=0)
    if want == "semantic":
        img, img_ref = np.round(shaded).astype(np.uint8), np.round(ref).astype(np.uint8)
    else:
        img = np.clip(shaded, 0, 255).astype(np.uint8)
        img_ref = np.clip(ref, 0, 255).astype(np.uint8)
    diff = np.abs(img.astype(int) - img_ref.astype(int))
    assert (diff == 0).mean() >= 0.995 and diff.max() <= 1


def test_prim_normal_single_matches_jax():
    jsc, sc = _scene("garage_simple", 1)
    rng = np.random.default_rng(0)
    k = rng.integers(0, 14, 512)  # the scene's active rows: room, boxes, capsules
    prow = np.asarray(jsc.params)[0, k]
    p = rng.uniform([-1, -5, 0.2], [17, 5, 4.5], (512, 3)).astype(np.float32)
    n = prim_normal_single(torch.from_numpy(prow), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(n, np.asarray(j_normal(jnp.asarray(prow), jnp.asarray(p))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)
    assert {0.0, 1.0} <= set(prow[:, 10])  # both families


def test_scene_sdf_grouped_matches_jax():
    from visfly_tpu.scene.prim_scene import scene_sdf_grouped as j_grouped

    jsc, sc = _scene("garage_simple", 1)
    p = np.random.default_rng(1).uniform([-1, -5, 0.2], [17, 5, 4.5], (1, 300, 3))
    p = p.astype(np.float32)
    np.testing.assert_allclose(scene_sdf_grouped(sc, torch.from_numpy(p)).numpy(),
                               np.asarray(j_grouped(jsc, jnp.asarray(p))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", ["default", "baked"])
def test_lambert_shade_matches_jax(kind):
    jl, tl = _lighting(kind)
    rng = np.random.default_rng(2)
    n = rng.normal(size=(4, 64, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    p = rng.uniform(-3, 3, (4, 64, 3)).astype(np.float32)
    out = tst.lambert_shade(torch.from_numpy(n), torch.from_numpy(p), tl).numpy()
    ref = np.asarray(jst.lambert_shade(jnp.asarray(n), jnp.asarray(p), jl))
    assert out.shape == ref.shape == (4, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_bake_lighting_matches_jax_and_types_the_shadow_flag():
    cfg = dict(LIGHTING, shadows=True)
    ref = jst.bake_lighting(cfg)
    out = tst.bake_lighting(cfg)
    for a, b in zip((out.kind, out.vec, out.color, out.ambient, out.attenuation), ref[:5]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-7)
    assert out.shadows is True and tst.bake_lighting(LIGHTING).shadows is False
    assert tst.bake_lighting(None) is None and tst.bake_lighting({}) is None
    amb = tst.bake_lighting({"ambient": 0.5})  # ambient only: one black light
    assert amb.kind.shape == (1,) and float(amb.color.abs().sum()) == 0.0
    crossed = lighting_from_numpy(jax.tree_util.tree_map(np.asarray, ref))
    assert crossed.shadows is True and torch.equal(crossed.vec, out.vec)
    with pytest.raises(ValueError):
        tst.bake_lighting({"lights": [{"type": "spot"}]})


@pytest.mark.parametrize("kind", ["default", "baked"])
@pytest.mark.parametrize("want", ["color", "semantic"])
def test_shade_primitive_matches_jax(want, kind):
    jl, tl = _lighting(kind)
    jsc, sc, p_hit, hit, kid = _hits(17)
    args = (torch.from_numpy(p_hit), torch.from_numpy(hit))
    jargs = (jnp.asarray(p_hit), jnp.asarray(hit))
    ref_argmin = np.asarray(jst._shade_primitive(jsc, *jargs, want, jl))
    ref_index = np.asarray(jst._shade_primitive_indexed(jsc, *jargs, jnp.asarray(kid), want, jl))
    out_argmin = tst._shade_primitive(sc, *args, want, tl).numpy()
    out_index = tst._shade_primitive_indexed(sc, *args, torch.from_numpy(kid), want, tl).numpy()
    _assert_images(out_argmin, ref_argmin, want)
    _assert_images(out_index, ref_index, want)
    assert out_index.shape == ((1, R, 3) if want == "color" else (1, R))
    # by the reported id vs by the nearest primitive (of the other package)
    close = np.isclose(out_index, ref_argmin, atol=TOL_SHADE)
    match = close.all(axis=-1) if want == "color" else close
    assert match[hit].mean() > 0.98, match[hit].mean()
    assert (out_index[~hit] == 0).all() and out_index[hit].max() > 1


@pytest.mark.parametrize("want", ["color", "semantic"])
def test_dynamic_object_pixels(want):
    """A hit with id −1 lies on a dynamic object: grey 110 × 0.75, semantic
    255; a miss stays 0."""
    objects = (np.asarray([[[2.2, 0.0, 1.5], [1.0, 1.5, 2.0]]], np.float32),
               np.asarray([[0.4, 0.25]], np.float32))
    jsc, sc, p_hit, hit, kid = _hits(3, objects)
    dyn = hit & (kid < 0)
    assert dyn.sum() > 20
    out = tst._shade_primitive_indexed(sc, torch.from_numpy(p_hit), torch.from_numpy(hit),
                                       torch.from_numpy(kid), want).numpy()
    ref = np.asarray(jst._shade_primitive_indexed(jsc, jnp.asarray(p_hit), jnp.asarray(hit),
                                                  jnp.asarray(kid), want))
    _assert_images(out, ref, want)
    if want == "color":
        np.testing.assert_allclose(out[dyn], 110.0 * 0.75, atol=1e-4)
    else:
        assert (out[dyn] == 255.0).all()


@pytest.mark.parametrize("spec", [
    {"resolution": [16, 16], "tile": 8},
    {"resolution": [16, 32], "tile": 4, "hfov": 70.0, "position": [0.1, 0.0, 0.05],
     "orientation": [0.0, 0.3, 0.1]},
])
def test_point_major_rays_and_tile_cones_match_jax(spec):
    rng = np.random.default_rng(4)
    pos = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    q = rng.normal(size=(3, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    ref = jcamera.camera_rays(spec, jnp.asarray(pos), jnp.asarray(q))
    out = tcamera.camera_rays(spec, torch.from_numpy(pos), torch.from_numpy(q))
    for r, x in zip(ref, out):
        assert tuple(x.shape) == r.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    for r, x in zip(jcamera.tile_cones_body(spec, spec["tile"]),
                    tcamera.tile_cones_body(spec, spec["tile"])):
        np.testing.assert_array_equal(x, r)
    assert tcamera.tile_cones_body(spec, 5) == (None, None)


@pytest.mark.parametrize("with_objects", [False, True])
def test_cone_prepass_matches_jax(with_objects):
    """``trace_cones_grouped`` on the tile cones of two cameras: the same
    float32 march in both packages, within 1e-4."""
    jsc, sc = _scene("garage_simple", 1)
    spec = {"resolution": [16, 16]}
    tdirs, ttan = tcamera.tile_cones_body(spec, 4)
    pos = np.asarray([[1.0, 0.0, 1.5], [2.0, 1.0, 1.0]], np.float32)
    o = np.repeat(pos, len(tdirs), axis=0)[None]
    d = np.tile(tdirs, (2, 1))[None]
    tan = np.tile(ttan, 2)[None]
    objects = None
    if with_objects:  # one object holds the first camera, one stands ahead
        objects = (np.asarray([[pos[0], [2.2, 0.0, 1.5]]], np.float32),
                   np.asarray([[0.2, 0.4]], np.float32))
    ref = jst.trace_cones_grouped(
        jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tan),
        None if objects is None else tuple(jnp.asarray(x) for x in objects), 24)
    out = tst.trace_cones_grouped(
        sc, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tan),
        None if objects is None else tuple(torch.from_numpy(x) for x in objects), 24)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert out.shape == (1, 32) and float(out.max()) > 1.0


@pytest.mark.parametrize("spec", [
    {"sensor_type": "depth", "resolution": [16, 16]},
    {"sensor_type": "depth", "resolution": [16, 16], "trace_mode": "march", "tile": 4,
     "render_dtype": "float32"},
    {"sensor_type": "semantic", "resolution": [16, 16]},
])
def test_render_camera_with_objects_matches_jax(spec):
    """Two cameras and two dynamic objects (one holds the first camera, one
    stands in view): depth within 1e-3 m on all but 2 silhouette pixels a
    camera; the semantic image differs only on the object's pixels, which
    the port marks 255 as the TPU path does, while the JAX CPU path shades
    them by the nearest scene primitive."""
    jsc, sc = _scene("garage_simple", 1)
    pos = np.asarray([[1.0, 0.0, 1.5], [1.2, 1.0, 1.0]], np.float32)
    q = np.asarray([[1.0, 0.0, 0.0, 0.0], [0.9689124, 0.0, 0.0, 0.2474040]], np.float32)
    objects = (np.asarray([[pos[0], [2.6, 0.2, 1.4]]], np.float32),
               np.asarray([[0.2, 0.4]], np.float32))
    ref = jst.render_camera(jsc, jnp.zeros(2, jnp.int32), jnp.asarray(pos), jnp.asarray(q), spec,
                            objects=tuple(jnp.asarray(x) for x in objects))
    out = tst.render_camera(sc, torch.from_numpy(pos), torch.from_numpy(q), spec,
                            objects=tuple(torch.from_numpy(x) for x in objects))
    (key, img), = out.items()
    img, img_ref = img.numpy(), np.asarray(ref[key])
    assert img.shape == img_ref.shape == (2, 1, 16, 16) and img.dtype == img_ref.dtype
    if key == "depth":
        off = np.abs(img - img_ref) > 1e-3
        assert off.sum(axis=(1, 2, 3)).max() <= 2, np.argwhere(off)
        assert img[0].min() > 0.5  # the first camera does not see the object around it
        plain = tst.render_camera(sc, torch.from_numpy(pos), torch.from_numpy(q), spec)
        assert (plain["depth"].numpy() - img).max() > 0.5  # the other object is in view
    else:
        on_object = img == 255
        assert 5 < on_object.sum() < 200
        assert ((img != img_ref) & ~on_object).sum() <= 4
