"""The per-tile cull of the port's analytic trace (the culled plain version
of ``csrc/trace_analytic.cu``) vs ``visfly_tpu``'s culled analytic tile in
interpret mode, vs the port's un-culled analytic trace, and the render's
arguments, on two-tile ray sets: one origin a tile (camera rays, with and
without the frustum planes, with dynamic capsules) and origins that differ
(free rays in the forest, whose tiles overflow the compacted block).

Tolerances, each beside its reason:
- the culled plain version vs ``pallas_trace_c(analytic=True, cull=True)``:
  the same function (closed form over the culled-in rows, which equals the
  tile's over its culled-in and filler rows; the refine over the tile's
  rows), float32 in another op order, so hit flags equal, |Δt| ≤ 1e-4
  wherever float32 resolves t (both within 5e-5 of the culled plain version
  in float64; the rule of ``test_torch_trace_kernel.py``: the cylinder
  quadratic cancels badly on some rays, under 1%, which are held to 1e-3),
  and ids equal where the winner is unique (its two best candidates more
  than 1e-5 apart: an exact tie may break differently after rounding);
- culled vs un-culled with no refine: a row the cull keeps out has no hit
  nearer than max_depth, so t, hit and the id are equal.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_trace_cull import _cull_case
from test_torch_trace_kernel import _scene, interpret_pallas  # noqa: F401
from visfly_tpu.render.pallas_trace import pallas_trace_c
from visfly_tpu_torch.render import sphere_trace, trace_kernel
from visfly_tpu_torch.render.trace_kernel import (KernelScene, cull_rows, trace_analytic,
                                                  trace_analytic_reference, trace_diff)

torch.set_num_threads(1)

TOL_KERNEL = 1e-4
TOL_XLA = 1e-3  # rays whose t float32 does not resolve to 1e-4
MAX_DEPTH = 20.0
CASES = ["camera", "camera_frustum", "dynamic", "forest"]


def _unique_winner(ks, oc, dc, img_w):
    """(R,) True where the best culled-in candidate of the ray is more than
    1e-5 below its second best."""
    plan = cull_rows(ks, oc, dc, MAX_DEPTH, img_w)
    o = tuple(oc[i, 0, :, None] for i in range(3))
    d = tuple(dc[i, 0, :, None] for i in range(3))
    tiles = torch.arange(oc.shape[2]) // trace_kernel.TILE
    tk = torch.cat([trace_kernel._box_t(ks.boxes[0], o, d).masked_fill(
                        ~plan.box_in[0, tiles], trace_kernel.BIG),
                    trace_kernel._capsule_t(ks.capsules[0], o, d).masked_fill(
                        ~plan.cap_in[0, tiles], trace_kernel.BIG)], dim=1)
    two = torch.topk(tk, 2, dim=1, largest=False).values
    return ((two[:, 1] - two[:, 0]) > 1e-5).numpy()


@pytest.mark.parametrize("want_kid", [False, True])
@pytest.mark.parametrize("n_refine", [0, 2])
@pytest.mark.parametrize("name", CASES)
def test_culled_analytic_matches_culled_tile(interpret_pallas, name, n_refine, want_kid):
    jks, ks, (joc, jdc), (oc, dc), img_w = _cull_case(name)
    ref = pallas_trace_c(jks, joc, jdc, None, analytic=True, n_refine=n_refine, cull=True,
                         img_w=img_w, want_kid=want_kid)
    out = trace_analytic_reference(ks, oc, dc, MAX_DEPTH, want_kid=want_kid,
                                   n_refine=n_refine, cull=True, img_w=img_w)
    assert len(out) == len(ref) == (3 if want_kid else 2)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    t64, _ = trace_analytic_reference(KernelScene(ks.boxes.double(), ks.capsules.double()),
                                      oc.double(), dc.double(), MAX_DEPTH, n_refine=n_refine,
                                      cull=True, img_w=img_w)
    t, t_ref, t64 = out[0].numpy(), np.asarray(ref[0]), t64.numpy()
    ill = (np.abs(t - t64) > TOL_KERNEL / 2) | (np.abs(t_ref - t64) > TOL_KERNEL / 2)
    assert ill.mean() < 0.01, ill.sum()
    np.testing.assert_allclose(t[~ill], t_ref[~ill], atol=TOL_KERNEL, rtol=0)
    np.testing.assert_allclose(t[ill], t_ref[ill], atol=TOL_XLA, rtol=0)
    if want_kid:
        kid, kid_ref = out[2].numpy()[0], np.asarray(ref[2])[0]
        unique = _unique_winner(ks, oc, dc, img_w)
        assert unique.mean() > 0.9
        np.testing.assert_array_equal(kid[unique], kid_ref[unique])
        assert (kid[~out[1].numpy()[0]] == -1).all()
    # the wrapper on CPU tensors is the plain version
    for a, b in zip(trace_analytic(ks, oc, dc, MAX_DEPTH, want_kid, n_refine, cull=True,
                                   img_w=img_w), out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_culled_analytic_equals_unculled(name):
    """With no refine the cull changes no bit; the rows it keeps in are
    ``box_in`` and ``cap_in``, counted by ``nb`` and ``nc``. The cameras'
    tiles leave rows out; the forest's free rays reach every row."""
    _, ks, _, (oc, dc), img_w = _cull_case(name)
    plan = cull_rows(ks, oc, dc, MAX_DEPTH, img_w)
    assert torch.equal(plan.box_in.sum(-1), plan.nb) and torch.equal(plan.cap_in.sum(-1), plan.nc)
    active = (ks.boxes[..., 11] > 0.5).sum() + (ks.capsules[..., 7] > 0.5).sum()
    assert bool(((plan.nb + plan.nc) < active).any()) is (name != "forest")
    t, hit, kid = trace_analytic_reference(ks, oc, dc, MAX_DEPTH, want_kid=True, cull=True,
                                           img_w=img_w)
    t_all, hit_all, kid_all = trace_analytic_reference(ks, oc, dc, MAX_DEPTH, want_kid=True)
    assert torch.equal(t, t_all) and torch.equal(hit, hit_all) and torch.equal(kid, kid_all)
    assert float(hit.float().mean()) > 0.05


def test_culled_analytic_takes_whole_tiles():
    _, ks, _, (oc, dc), img_w = _cull_case("camera_frustum")
    o, d = oc[:, :, :1500].contiguous(), dc[:, :, :1500].contiguous()
    for call in (lambda: trace_analytic(ks, o, d, cull=True),
                 lambda: trace_diff(ks, o, d, analytic=True)):
        with pytest.raises(ValueError, match="1024"):
            call()
    t, _ = trace_analytic(ks, o, d)
    assert t.shape == (1, 1500)


@pytest.mark.parametrize("img_w", [None, 64])
def test_trace_diff_passes_the_cull(img_w):
    _, ks, _, (oc, dc), _ = _cull_case("camera_frustum")
    with mock.patch.object(trace_kernel, "trace_analytic",
                           wraps=trace_kernel.trace_analytic) as spy:
        t, hit, kid = trace_diff(ks, oc, dc, analytic=True, n_refine=0, img_w=img_w)
    assert spy.call_args.kwargs["cull"] is True and spy.call_args.kwargs["img_w"] == img_w
    t_ref, _, kid_ref = trace_analytic_reference(ks, oc, dc, want_kid=True, cull=True,
                                                 img_w=img_w)
    assert torch.equal(t, t_ref) and torch.equal(kid, kid_ref)


@pytest.mark.parametrize("stype", ["depth", "semantic"])
@pytest.mark.parametrize("res,cull", [((16, 64), True), ((10, 10), False)])
def test_render_passes_the_cull_to_the_analytic_trace(res, cull, stype):
    """render_camera's analytic sensors cull whole 1,024-ray tiles only, with
    the image width where a tile is rows of one camera."""
    _, sc = _scene("garage_simple", 1)
    spec = {"sensor_type": stype, "resolution": list(res)}
    pos = torch.tensor([[1.0, 0.0, 1.5], [2.0, 1.0, 1.0]])
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(2, 4).contiguous()
    with mock.patch.object(trace_kernel, "trace_analytic",
                           wraps=trace_kernel.trace_analytic) as spy:
        out = sphere_trace.render_camera(sc, pos, q, spec, n_steps=8)[stype]
    assert out.shape == (2, 1, *res)
    kw = spy.call_args.kwargs
    assert kw["cull"] is cull
    assert kw["img_w"] == (res[1] if cull else None)
    assert spy.call_args.args[4] is (stype != "depth")  # want_kid
