"""The port's debugging and demo scripts (``visfly_tpu_torch/examples/``:
``debug_obs``, ``habitat_dataset_demo``, ``vision_grad_probe``) against the
JAX package's, at a small size on the CPU.

Each script runs through ``main()`` into a temporary directory. Then its
pieces are held to the JAX package's with the same inputs: a JAX state,
carried over with ``interop``, renders the same frames (depth within 1e-3
m, colour within 1 a channel, semantic ids equal, each on all but 2 pixels
per 1,024, as ``tests/test_torch_habitat.py`` holds renders); the demo's
loader puts the same dataset files in the same scenes; and the probe's
per-term gradient norms, from the same parameters, spawns and action noise,
agree within 1e-4 relative.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import visfly_tpu.render.sphere_trace  # noqa: F401  (first render must not happen under jit)
from visfly_tpu import envs as jenvs
from visfly_tpu.algos import BPTT as JBPTT
from visfly_tpu_torch.examples import debug_obs, habitat_dataset_demo, vision_grad_probe
from visfly_tpu_torch.interop import bptt_state_from_jax, env_state_from_numpy

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH_TOL = 1e-3


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_images_close(got, ref, tol=0.0):
    """(N, C, H, W) images equal within ``tol`` on all but 2 pixels per
    1,024 of each."""
    got = np.asarray(got).astype(np.float64)
    ref = np.asarray(ref).astype(np.float64)
    assert got.shape == ref.shape
    off = (np.abs(got - ref) > tol).any(axis=1)
    allowed = 2 * -(-off[0].size // 1024)
    assert off.sum(axis=(1, 2)).max() <= allowed, (int(off.sum()), np.argwhere(off)[:6])


def jax_script(name):
    """A script of ``examples/`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# debug_obs
# ---------------------------------------------------------------------------


def test_debug_obs_writes_its_frames(tmp_path):
    out = debug_obs.main(["--out", str(tmp_path)], device="cpu")
    names = sorted(os.path.basename(f) for f in out["files"])
    assert names == sorted([f"a{a}_{k}.png" for a in range(2)
                            for k in ("depth", "color", "semantic")] + ["global_top.png"])
    for f in out["files"]:
        with open(f, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
    assert out["view"].shape == (480, 640, 3) and out["view"].dtype == np.uint8
    got = out["frames"]
    assert got["depth"].shape == (2, 64, 64) and got["color"].shape == (2, 64, 64, 3)
    assert np.isfinite(got["depth"]).all() and got["depth"].max() > got["depth"].min()


def test_debug_obs_frames_match_jax():
    """The script's env at 16×16 and the JAX script's env, 40 steps at the
    script's action from the JAX reset; the port renders the JAX state."""
    res = (16, 16)
    tenv = debug_obs.make_env(resolution=res, device="cpu")
    jenv = jenvs.NavigationEnv(
        num_agent_per_scene=4, visual=True, scene_kwargs={"path": "garage_simple_l_medium"},
        sensor_kwargs=[{"sensor_type": s, "uuid": s, "resolution": list(res)}
                       for s in debug_obs.SENSORS],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03})
    jst, _ = jenv.reset(jax.random.PRNGKey(0))
    step = jax.jit(jenv.step)
    for _ in range(40):
        jst, _ = step(jst, jnp.full((4, 4), 0.1))
    want = to_numpy(jenv.sensor_observations(jst))
    got = debug_obs.frames(tenv, env_state_from_numpy(to_numpy(jst)))
    assert_images_close(got["depth"][:, None], want["depth"][:2], DEPTH_TOL)
    assert_images_close(np.transpose(got["color"], (0, 3, 1, 2)), want["color"][:2], 1.0)
    assert_images_close(got["semantic"][:, None], want["semantic"][:2])
    assert len(np.unique(got["semantic"])) > 1


# ---------------------------------------------------------------------------
# habitat_dataset_demo
# ---------------------------------------------------------------------------


def test_habitat_demo_matches_jax(tmp_path):
    """The same files on disk; the same dataset files in the scenes after
    the swap; the port's renders of the JAX states after the swap and at the
    grid reload."""
    out = habitat_dataset_demo.main([str(tmp_path / "port")], device="cpu")
    jdemo = jax_script("habitat_dataset_demo")
    scenes = jdemo.build_dataset(str(tmp_path / "jax"))
    for d, _, files in os.walk(tmp_path / "jax"):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), tmp_path / "jax")
            with open(os.path.join(d, f), "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
                assert a.read() == b.read(), rel
    assert out["same_shape"] and out["changed"]
    tenv, tex = out["env"], out["env_exact"]
    assert tuple(out["obs"]["depth"].shape) == (8, 1, 32, 32)

    tscenes = str(tmp_path / "port" / "configs" / "scenes")
    jenv = jenvs.NavigationEnv(
        num_agent_per_scene=4, num_scene=2, visual=True,
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 1.0, 0.5]}}]}},
        scene_kwargs={"path": tscenes},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [32, 32]}],
        target=[7.0, 0.0, 1.0])
    jst, _ = jenv.reset(jax.random.PRNGKey(0))
    jst = jenv.reset_env_by_id(jst, 0)
    assert [s.name for s in tenv._scene_specs] == [s.name for s in jenv._scene_specs]
    assert len({s.name for s in tenv._scene_specs}) == 2
    want = to_numpy(jenv.sensor_observations(jst))["depth"]
    got = tenv.sensor_observations(env_state_from_numpy(to_numpy(jst)))["depth"]
    assert_images_close(got.numpy(), want, DEPTH_TOL)

    jex = jenvs.NavigationEnv(
        num_agent_per_scene=2, visual=True,
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.0, 0.5, 0.3]}}]}},
        scene_kwargs={"path": tscenes, "backend": "grid"},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": [32, 32]}],
        target=[7.0, 0.0, 1.0])
    jst_e, _ = jex.reset(jax.random.PRNGKey(1))
    assert tex.scene.triangles.shape[1] == jex.scene.triangles.shape[1]
    want = to_numpy(jex.sensor_observations(jst_e))["depth"]
    got = tex.sensor_observations(env_state_from_numpy(to_numpy(jst_e)))["depth"]
    assert_images_close(got.numpy(), want, DEPTH_TOL)
    assert scenes.endswith(os.path.join("configs", "scenes"))


# ---------------------------------------------------------------------------
# vision_grad_probe
# ---------------------------------------------------------------------------

P_N, P_H, P_RES = 4, 4, (16, 16)


def jax_term_norms(jtr, st):
    """The JAX script's per-term gradient norms (its ``term_loss`` and
    cosines, at this file's size)."""
    env, terms = jtr.env, vision_grad_probe.TERMS

    def term_loss(params, env_state, obs, key, w):
        def body(carry, _):
            env_state, obs, discount, key, loss = carry
            key, k_act = jax.random.split(key)
            action, _ = jtr.actor.apply(params, obs, k_act)
            env_state, out = env.step(env_state, jnp.clip(action, -1.0, 1.0))
            done = out.done.astype(loss.dtype)
            term_vec = jnp.stack([out.info[f"extra_{k}"] for k in terms])
            loss = loss - (w @ term_vec) * discount
            discount = discount * 0.99 * (1.0 - done) + done
            return (env_state, out.obs, discount, key, loss), None

        init = (env_state, obs, jnp.ones(P_N), key, jnp.zeros(P_N))
        (_, _, _, _, loss), _ = jax.lax.scan(body, init, None, length=jtr.H)
        return loss.mean()

    gfn = jax.jit(jax.grad(term_loss))
    out, grads = {}, {}
    for i, name in enumerate(terms + ["TOTAL"]):
        w = jnp.ones(len(terms)) if name == "TOTAL" else jnp.zeros(len(terms)).at[i].set(1.0)
        g = gfn(st.params, st.env_state, st.obs, st.key, w)
        grads[name] = jnp.concatenate([x.ravel() for x in jax.tree.leaves(g)])
        out[name] = float(jnp.linalg.norm(grads[name]))
    rest = grads["approach"] + grads["view"] + grads["vel"] + grads["omega"]
    for name in ("col_dis", "col_closing"):
        denom = out[name] * float(jnp.linalg.norm(rest))
        out[f"cos({name},task)"] = float(grads[name] @ rest) / denom if denom > 0 else float(
            "nan")
    return out


def test_vision_grad_probe_runs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = vision_grad_probe.main([], device="cpu", n=P_N, horizon=P_H, resolution=P_RES)
    for flag in (False, True):
        norms = out[flag]
        assert set(norms) == set(vision_grad_probe.TERMS) | {
            "TOTAL", "cos(col_dis,task)", "cos(col_closing,task)"}
        assert norms["TOTAL"] > 0 and norms["approach"] > 0
    # the query's gradient is what grad_collision adds
    assert out[False]["col_dis"] == 0.0 and out[True]["col_dis"] > 0.0


@pytest.mark.parametrize("grad_collision", [False, True], ids=["detached", "grad_collision"])
def test_vision_grad_probe_matches_jax(grad_collision):
    tr = vision_grad_probe.make_trainer(grad_collision, n=P_N, horizon=P_H, resolution=P_RES,
                                        device="cpu")
    jenv = jenvs.NavigationEnv(
        num_agent_per_scene=P_N, visual=True, requires_grad=True, indiv_reward=True,
        grad_collision=grad_collision, scene_kwargs={"path": "garage_simple_l_medium"},
        sensor_kwargs=[{"uuid": "depth", "sensor_type": "depth", "resolution": list(P_RES)}],
        random_kwargs={"state_generator": {"class": "Uniform", "kwargs": [
            {"position": {"mean": [1.0, 0.0, 1.5], "half": [0.5, 2.0, 1.0]}}]}},
        dynamics_kwargs={"dt": 0.03, "ctrl_dt": 0.03, "action_type": "bodyrate"},
        max_episode_steps=256)
    jtr = JBPTT(jenv, horizon=P_H, learning_rate=5e-4, policy_kwargs=vision_grad_probe.POLICY)
    jst = jtr.init(jax.random.PRNGKey(0))
    want = jax_term_norms(jtr, jst)

    tst = bptt_state_from_jax(to_numpy(jst), tr)
    key, noise = jst.key, []
    for _ in range(P_H):
        key, k_act = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(k_act, (P_N, 4))))
    got = vision_grad_probe.grad_norms(tr, tst, torch.from_numpy(np.stack(noise)))
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("cos"):
            assert np.isnan(got[k]) == np.isnan(v), k
            if not np.isnan(v):
                assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= 1e-4 * max(abs(v), 1e-12), (k, got[k], v)
    assert want["TOTAL"] > 0
