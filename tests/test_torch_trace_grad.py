"""The differentiable trace entry (``trace_diff``, one ``autograd.Function``
for both ray layouts) vs ``jax.grad`` through ``pallas_trace_diff_c`` and
``pallas_trace_diff`` with the Pallas tile in interpret mode.

Both packages compute the same implicit-function-theorem rule, each from its
own forward t. The two t differ by a few 1e-6 m, which turns the normal of a
0.2 m capsule by ~1e-5 rad, and 1/(n·d) amplifies that: the gradients agree
within 1e-4 relative on rays that meet the surface at |n·d| > 0.1 and within
1e-3 at 1e-2 < |n·d| ≤ 0.1 (measured: one element in 2904 at 2.9e-4); at
|n·d| ≤ 1e-3 the rule cuts the gradient to 0 on either side of a threshold.
Misses carry no gradient. ``torch.autograd.gradcheck``
is not usable here: it needs float64 and a smooth function, and the kernels
and their plain versions are float32 with a discrete hit mask; the
finite-difference check of ``test_custom_vjp_matches_ift`` (atol 0.05) takes
its place.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_trace_kernel import _free_rays, _scene, interpret_pallas  # noqa: F401
from visfly_tpu.render.pallas_trace import (_kernel_scene_sdf, pallas_trace_diff,
                                            pallas_trace_diff_c)
from visfly_tpu.render.pallas_trace import prepare_kernel_scene as j_prepare
from visfly_tpu_torch.render.trace_kernel import (kernel_scene_sdf, prepare_kernel_scene,
                                                  trace_diff)

torch.set_num_threads(1)

R = 1024
REL_TOL = 1e-4


def _setup(seed):
    jsc, sc = _scene("garage_simple", 1)
    o, d = _free_rays(sc, R, seed, [1.0, 0.0, 1.5], [0.5, 2.0, 0.7])
    g_t = np.random.default_rng(seed).normal(size=(1, R)).astype(np.float32)
    return j_prepare(jsc), prepare_kernel_scene(sc), o, d, g_t


def _well_conditioned(ks, o, d, t, hit):
    """|n·d| of the rays that hit (0 elsewhere), from the port's own normal."""
    p = (torch.from_numpy(o) + torch.from_numpy(d) * t[0, :, None])[None].requires_grad_(True)
    (n,) = torch.autograd.grad(kernel_scene_sdf(ks, p).sum(), p)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    nd = torch.sum(n[0] * torch.from_numpy(d), dim=-1).abs()
    return torch.where(hit[0], nd, 0.0).numpy()


def _assert_grads(g, g_ref, nd, miss, what):
    """g, g_ref (R, 3); nd (R,) = |n·d| on hits."""
    assert np.isfinite(g).all()
    err = np.linalg.norm(g - g_ref, axis=1)  # relative to each ray's gradient vector
    ref = np.linalg.norm(g_ref, axis=1)
    for band, tol in ((nd > 0.1, REL_TOL), ((nd > 1e-2) & (nd <= 0.1), 10 * REL_TOL)):
        worst = (err[band] / (ref[band] + 1e-6)).max()
        assert worst <= tol, (what, tol, worst)
    assert (g[miss] == 0).all() and (nd > 0.1).mean() > 0.5


@pytest.mark.parametrize("mode", ["march", "analytic", "analytic_refine"])
def test_component_gradients_match_jax(interpret_pallas, mode):
    jks, ks, o, d, g_t = _setup(3)
    analytic, n_refine = mode != "march", 2 if mode == "analytic_refine" else 0
    joc, jdc = jnp.asarray(o.T)[:, None, :], jnp.asarray(d.T)[:, None, :]

    def loss(oc, dc):
        out = pallas_trace_diff_c(jks, oc, dc, jnp.zeros((1, R)), 40, 20.0, 1.0, False, None,
                                  analytic, n_refine, True)
        return jnp.sum(out[0] * jnp.asarray(g_t))

    go_ref, gd_ref = jax.grad(loss, argnums=(0, 1))(joc, jdc)
    oc = torch.from_numpy(o.T.copy())[:, None, :].requires_grad_(True)
    dc = torch.from_numpy(d.T.copy())[:, None, :].requires_grad_(True)
    t, hit, kid = trace_diff(ks, oc, dc, None, 40, 20.0, 1.0, False, analytic, n_refine, True)
    assert not hit.requires_grad and not kid.requires_grad
    go, gd = torch.autograd.grad((t * torch.from_numpy(g_t)).sum(), (oc, dc))
    good = _well_conditioned(ks, o, d, t.detach(), hit)
    miss = ~hit[0].numpy()
    _assert_grads(go[:, 0].numpy().T, np.asarray(go_ref)[:, 0].T, good, miss, "d/d origins")
    _assert_grads(gd[:, 0].numpy().T, np.asarray(gd_ref)[:, 0].T, good, miss, "d/d dirs")


def test_packed_gradients_match_jax(interpret_pallas):
    jks, ks, o, d, g_t = _setup(4)
    t0 = np.random.default_rng(1).uniform(0, 0.5, (1, R)).astype(np.float32)

    def loss(op, dp):
        t, _, _ = pallas_trace_diff(jks, op, dp, jnp.asarray(t0), 40, 20.0)
        return jnp.sum(t * jnp.asarray(g_t))

    go_ref, gd_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(o)[None], jnp.asarray(d)[None])
    op = torch.from_numpy(o)[None].requires_grad_(True)
    dp = torch.from_numpy(d)[None].requires_grad_(True)
    t_init = torch.from_numpy(t0).requires_grad_(True)
    t, hit, kid = trace_diff(ks, op, dp, t_init, 40, 20.0, packed=True)
    assert (kid == -1).all()
    go, gd, gt0 = torch.autograd.grad((t * torch.from_numpy(g_t)).sum(), (op, dp, t_init),
                                      allow_unused=True)
    assert gt0 is None  # nothing flows to the warm start
    good = _well_conditioned(ks, o, d, t.detach(), hit)
    miss = ~hit[0].numpy()
    _assert_grads(go[0].numpy(), np.asarray(go_ref)[0], good, miss, "d/d origins")
    _assert_grads(gd[0].numpy(), np.asarray(gd_ref)[0], good, miss, "d/d dirs")


@pytest.mark.parametrize("packed", [False, True])
def test_gradient_matches_finite_differences(packed):
    """∂(mean t)/∂o_x of one ray against central differences of the forward,
    as ``test_custom_vjp_matches_ift`` and ``test_component_path_vjp``."""
    _, ks, o, d, _ = _setup(7 if packed else 3)

    def rays(o_np):
        if packed:
            return torch.from_numpy(o_np)[None], torch.from_numpy(d)[None]
        return (torch.from_numpy(o_np.T.copy())[:, None, :],
                torch.from_numpy(d.T.copy())[:, None, :])

    def depth(o_np):
        oi, di = rays(o_np)
        return trace_diff(ks, oi, di, None, 40, 20.0, packed=packed)[0]

    oi, di = rays(o)
    oi.requires_grad_(True)
    t = trace_diff(ks, oi, di, None, 40, 20.0, packed=packed)[0]
    (g,) = torch.autograd.grad(t.mean(), oi)
    an = float(g[0, 0, 0]) * R  # undo the mean; ray 0, x component in both layouts
    eps = 1e-3
    o_p, o_m = o.copy(), o.copy()
    o_p[0, 0] += eps
    o_m[0, 0] -= eps
    fd = float(depth(o_p)[0, 0] - depth(o_m)[0, 0]) / (2 * eps)
    np.testing.assert_allclose(an, fd, atol=0.05)


def test_kernel_scene_sdf_matches_jax():
    """The backward's SDF: against the JAX one, and against the packed
    scene's SDF with dynamic capsules appended."""
    jsc, sc = _scene("garage_simple", 1)
    obj = (np.asarray([[[2.0, 0.0, 1.5]]], np.float32), np.asarray([[0.4]], np.float32))
    jks = j_prepare(jsc, tuple(jnp.asarray(x) for x in obj))
    ks = prepare_kernel_scene(sc, tuple(torch.from_numpy(x) for x in obj))
    p = np.random.default_rng(0).uniform([-1, -5, 0.2], [17, 5, 4.5], (1, 256, 3))
    p = p.astype(np.float32)
    np.testing.assert_allclose(kernel_scene_sdf(ks, torch.from_numpy(p)).numpy(),
                               np.asarray(_kernel_scene_sdf(jks, jnp.asarray(p))), atol=1e-5)
