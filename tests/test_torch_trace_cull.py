"""The per-tile cull of the port's march (``cull_rows`` and the culled plain
march, the CUDA kernel's plain versions) vs ``visfly_tpu``'s ``cull_compact``
and its culled Pallas tile in interpret mode, on two-tile ray sets.

Tolerances, each beside its reason:
- ``cull_rows`` vs ``cull_compact``: counts, the fit flag and the evaluated
  rows equal (the same float32 tests in the same order);
- the culled march vs ``_trace_kernel_culled``: the same function, float32
  step by step in another op order, so |Δt| ≤ 1e-4 with hit flags equal, at
  8 steps (rays run out of steps, and the culled-out filler rows of a tile
  that fits decide where they end) and at 40;
- the un-culled analytic refine vs the culled analytic tile: the same bound.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_trace_kernel import _camera_rays, _case, _scene, interpret_pallas  # noqa: F401
from visfly_tpu.render.pallas_trace import cull_compact, pallas_trace_c
from visfly_tpu.render.pallas_trace import prepare_kernel_scene as j_prepare
from visfly_tpu_torch.render import sphere_trace
from visfly_tpu_torch.render.trace_kernel import (cull_capacity, cull_rows,
                                                  prepare_kernel_scene, trace_analytic,
                                                  trace_diff, trace_march)

torch.set_num_threads(1)

TOL_KERNEL = 1e-4
MAX_DEPTH = 20.0


def _cull_case(name):
    """(jax kernel scene, port kernel scene, jax rays, port rays, img_w): two
    1,024-ray tiles, component-major."""
    base = {"camera": "camera_tiles", "camera_frustum": "camera_tiles",
            "dynamic": "dynamic_capsules", "forest": "forest_room"}[name]
    jsc, sc, o, d, objects, _ = _case(base)
    img_w = 64 if name in ("camera_frustum", "dynamic") else None
    if name == "dynamic":
        o, d = _camera_rays()
    if name == "forest":
        o, d = np.concatenate([o, o[::-1]]), np.concatenate([d, d[::-1]])
    jks = j_prepare(jsc, None if objects is None else tuple(jnp.asarray(x) for x in objects))
    ks = prepare_kernel_scene(sc, None if objects is None
                              else tuple(torch.from_numpy(x) for x in objects))
    j_rays = (jnp.asarray(o.T)[:, None, :], jnp.asarray(d.T)[:, None, :])
    rays = (torch.from_numpy(o.T.copy())[:, None, :], torch.from_numpy(d.T.copy())[:, None, :])
    return jks, ks, j_rays, rays, img_w


def _rows(block):
    """A block's rows as a sorted list, to compare sets of rows."""
    return sorted(map(tuple, np.asarray(block).tolist()))


@pytest.mark.parametrize("name", ["camera", "camera_frustum", "dynamic", "forest"])
def test_cull_rows_matches_cull_compact(name):
    """Counts, fit flags and rows: a hollow room (always in), an overflowing
    tile (camera: 11 box rows against a capacity of 6; forest: 24 capsule
    rows against 12), frustum planes, dynamic capsules."""
    jks, ks, (joc, jdc), (oc, dc), img_w = _cull_case(name)
    KB, KC = ks.boxes.shape[1], ks.capsules.shape[1]
    kb_c, kc_c = cull_capacity(KB), cull_capacity(KC)
    box_t, nb, cap_t, nc = cull_compact(jks, joc, jdc, MAX_DEPTH, kb_c, kc_c, img_w)
    plan = cull_rows(ks, oc, dc, MAX_DEPTH, img_w)
    np.testing.assert_array_equal(plan.nb.numpy(), np.asarray(nb))
    np.testing.assert_array_equal(plan.nc.numpy(), np.asarray(nc))
    fits = plan.fits.numpy()
    np.testing.assert_array_equal(fits, (np.asarray(nb) <= kb_c) & (np.asarray(nc) <= kc_c))
    assert not fits.all()  # every case has a tile that overflows
    assert bool(plan.box_rows[~plan.fits].all()) and bool(plan.cap_rows[~plan.fits].all())
    for s, t in zip(*np.nonzero(fits)):
        # a tile that fits evaluates the compacted block: its culled-in rows
        # and the culled-out filler rows after them
        assert _rows(ks.boxes[s][plan.box_rows[s, t]]) == _rows(np.asarray(box_t)[s, t])
        assert _rows(ks.capsules[s][plan.cap_rows[s, t]]) == _rows(np.asarray(cap_t)[s, t])
    if name in ("camera", "forest"):
        assert (ks.boxes[0, :, 9] < 0).any()  # a hollow room


@pytest.mark.parametrize("name,n_steps", [("camera_frustum", 8), ("camera_frustum", 40),
                                          ("dynamic", 8)])
def test_culled_march_matches_culled_tile(interpret_pallas, name, n_steps):
    jks, ks, (joc, jdc), (oc, dc), img_w = _cull_case(name)
    t_ref, hit_ref, _ = pallas_trace_c(jks, joc, jdc, None, n_steps=n_steps, cull=True,
                                       img_w=img_w)
    t, hit = trace_march(ks, oc, dc, None, n_steps, img_w=img_w)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=TOL_KERNEL, rtol=0)
    # the cull is part of the function: every row gives another image
    t_all, _ = trace_march(ks, oc, dc, None, n_steps, cull=False)
    assert (np.abs(t_all.numpy() - np.asarray(t_ref)) > TOL_KERNEL).any()
    plan = cull_rows(ks, oc, dc, MAX_DEPTH, img_w)
    assert bool(plan.fits.any()) and not bool(plan.fits.all())


def test_analytic_refine_matches_culled_tile(interpret_pallas):
    """The un-culled analytic trace with two refine steps stays within 1e-4
    of the culled analytic tile, whose refine marches the compacted rows: on
    these rays the refine barely moves an exact candidate. The culled trace,
    which marches the tile's rows too, is held to the tile in
    ``test_torch_trace_analytic_cull.py``."""
    jks, ks, (joc, jdc), (oc, dc), img_w = _cull_case("camera_frustum")
    t_ref, hit_ref = pallas_trace_c(jks, joc, jdc, None, analytic=True, n_refine=2, cull=True,
                                    img_w=img_w, want_kid=False)
    t, hit = trace_analytic(ks, oc, dc, n_refine=2)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=TOL_KERNEL, rtol=0)


def test_cull_takes_whole_tiles():
    _, ks, _, (oc, dc), img_w = _cull_case("camera_frustum")
    o, d = oc[:, :, :1500].contiguous(), dc[:, :, :1500].contiguous()
    for call in (lambda: trace_march(ks, o, d, None, 8),
                 lambda: trace_diff(ks, o, d, None, 8),
                 lambda: cull_rows(ks, o, d, MAX_DEPTH)):
        with pytest.raises(ValueError, match="1024"):
            call()
    with pytest.raises(ValueError):
        trace_march(ks, oc, dc, None, 8, cull=False, want_counts=True)
    t, hit = trace_march(ks, o, d, None, 8, cull=False)
    assert t.shape == (1, 1500)
    # packed rays take no cull, as the TPU's packed entry: a ragged count passes
    t_p, _ = trace_march(ks, o.permute(1, 2, 0), d.permute(1, 2, 0), None, 8, packed=True)
    torch.testing.assert_close(t_p, t, rtol=0, atol=1e-6)
    # the counts on the CPU are the plain cull's
    _, _, counts = trace_march(ks, oc, dc, None, 8, img_w=img_w, want_counts=True)
    plan = cull_rows(ks, oc, dc, MAX_DEPTH, img_w)
    assert counts.dtype == torch.int32 and counts.shape == (1, 2, 2)
    assert counts[..., 0].tolist() == plan.nb.tolist()
    assert counts[..., 1].tolist() == plan.nc.tolist()


@pytest.mark.parametrize("res,n,cull", [((16, 64), 2, True), ((10, 10), 2, False)])
def test_render_culls_whole_tiles_of_one_camera(res, n, cull):
    """render_camera culls only whole 1,024-ray tiles (JAX renders un-culled
    otherwise) and gives the image width where a tile is rows of one camera."""
    _, sc = _scene("garage_simple", 1)
    spec = {"sensor_type": "depth", "trace_mode": "march", "resolution": list(res)}
    pos = torch.tensor([[1.0, 0.0, 1.5], [2.0, 1.0, 1.0]])[:n]
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(n, 4).contiguous()
    with mock.patch.object(sphere_trace, "trace_diff", wraps=sphere_trace.trace_diff) as spy:
        depth = sphere_trace.render_camera(sc, pos, q, spec, n_steps=8)["depth"]
    assert depth.shape == (n, 1, *res)
    args, kw = spy.call_args
    assert args[7] is cull  # the cull argument of trace_diff
    assert kw["img_w"] == (res[1] if (res[0] * res[1]) % 1024 == 0 else None)
