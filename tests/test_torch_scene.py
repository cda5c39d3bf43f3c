"""Parity of the port's primitive scenes and scene queries with
``visfly_tpu``: packing is bitwise equal, SDF values and collision queries
agree within 1e-5 at random points (float32)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visfly_tpu.scene import closest_point_query as j_closest
from visfly_tpu.scene import make_scene as j_make_scene
from visfly_tpu.scene import pack_scenes as j_pack
from visfly_tpu.scene import point_is_collision as j_point_is_collision
from visfly_tpu.scene.prim_scene import prim_sdf as j_prim_sdf
from visfly_tpu_torch.interop import scene_from_numpy
from visfly_tpu_torch.scene import (closest_point_query, make_scene, pack_scenes,
                                    point_is_collision, prim_distances, prim_sdf)

torch.set_num_threads(1)

TOL = 1e-5  # float32 evaluation of the same formulas, points within ~20 m
PRESETS = ["garage_simple", "box_random", "forest", "racing", "garage_crossing",
           "garage_landing", "box15_wall_empty"]
FIELDS = ("params", "colors", "semantic", "bbox", "eps", "boxes", "capsules")


@pytest.mark.parametrize("preset", PRESETS)
def test_pack_scenes_bitwise_equal(preset):
    specs = [make_scene(preset, seed=s) for s in (3, 4)]
    ref = j_pack([j_make_scene(preset, seed=s) for s in (3, 4)])
    out = pack_scenes(specs)
    for name in FIELDS:
        a, b = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("preset", ["garage_simple", "box_random", "racing"])
def test_host_sdf_matches_jax(preset):
    """The numpy primitive SDFs (``SceneSpec.sdf``): spheres, boxes,
    cylinders, rooms and gates."""
    p = np.random.default_rng(3).uniform(-9, 9, size=(2048, 3))
    np.testing.assert_allclose(make_scene(preset, seed=7).sdf(p),
                               j_make_scene(preset, seed=7).sdf(p), atol=1e-12, rtol=0)


def test_pack_scenes_on_device_argument():
    sc = pack_scenes([make_scene("garage_simple")], device="cpu")
    assert all(getattr(sc, f).device.type == "cpu" for f in FIELDS)
    assert sc.num_scene == 1


def _points(rng, n, scene):
    lo = np.asarray(scene.bbox[0]) - 0.5
    hi = np.asarray(scene.bbox[1]) + 0.5
    return rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)


def _ties(params, p, gap=1e-4):
    """Points where the two nearest primitives are closer than ``gap``: the
    min's subgradient is a tie there, which JAX and torch may split
    differently. Returns a bool mask."""
    d = np.sort(prim_distances(torch.from_numpy(params), torch.from_numpy(p)).numpy(), -1)
    return (d[:, 1] - d[:, 0]) < gap


@pytest.mark.parametrize("preset", ["garage_simple", "box_random", "forest", "racing"])
def test_prim_sdf_matches_jax(preset):
    jsc = j_pack([j_make_scene(preset, seed=5)])
    sc = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jsc))
    p = _points(np.random.default_rng(0), 4096, jsc)
    ref = np.asarray(j_prim_sdf(jsc.params[0], jnp.asarray(p)))
    out = prim_sdf(sc.params[0], torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("n_scene", [1, 2])
@pytest.mark.parametrize("preset", ["garage_simple", "box_random", "forest", "racing"])
def test_closest_point_query_matches_jax(preset, n_scene):
    jsc = j_pack([j_make_scene(preset, seed=5 + i) for i in range(n_scene)])
    sc = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jsc))
    rng = np.random.default_rng(1)
    n = 2048
    p = _points(rng, n, jsc)
    sid = np.sort(rng.integers(0, n_scene, size=n)).astype(np.int32)
    ref = [np.asarray(x) for x in j_closest(jsc, jnp.asarray(sid), jnp.asarray(p))]
    out = [x.numpy() for x in closest_point_query(sc, torch.from_numpy(sid).long(),
                                                  torch.from_numpy(p))]
    params = np.asarray(jsc.params)[sid]
    tie = _ties(params, p)
    assert tie.mean() < 0.01, tie.mean()
    keep = ~tie
    np.testing.assert_allclose(out[1], ref[1], atol=TOL, rtol=0)  # distance
    np.testing.assert_allclose(out[0][keep], ref[0][keep], atol=TOL, rtol=0)  # point
    np.testing.assert_array_equal(out[2], ref[2])  # out of bounds


@pytest.mark.parametrize("preset", ["garage_simple", "box_random", "forest"])
def test_point_is_collision_matches_jax(preset):
    jsc = j_pack([j_make_scene(preset, seed=6)])
    sc = scene_from_numpy(jax.tree_util.tree_map(np.asarray, jsc))
    p = _points(np.random.default_rng(2), 4096, jsc)
    ref = np.asarray(j_point_is_collision(jsc, jnp.asarray(p), radius=1.0))
    out = point_is_collision(sc, torch.from_numpy(p), radius=1.0).numpy()
    # exclude points within float32 reach of the radius boundary
    near = np.abs(np.asarray(j_prim_sdf(jsc.params[0], jnp.asarray(p))) - 1.0) < TOL
    np.testing.assert_array_equal(out[~near], ref[~near])
    assert 0.05 < out.mean() < 0.95
