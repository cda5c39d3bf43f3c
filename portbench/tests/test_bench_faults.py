"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced (an image, or
the collision query's distance). (No cell exchanges anything between
chips.)"""
import pytest
import torch

from portbench.tests import _fixture


class Broken:
    """The env with one fault in its timed entry; everything else passes."""

    def __init__(self, env, fault):
        self._env, self._fault, self._last = env, fault, None

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, state, action, **kw):
        new, out = self._env.step(state, action, **kw)
        if self._fault == "unchanged":
            return state, out
        if self._fault == "half":
            h = state.dyn.pos.shape[0] // 2
            dyn = type(new.dyn)(*[torch.cat([a[:h], b[h:]]) if isinstance(a, torch.Tensor)
                                  and a.dim() and a.shape[0] == 2 * h else a
                                  for a, b in zip(new.dyn, state.dyn)])
            return new._replace(dyn=dyn), out
        if self._fault == "collision":
            # the query's answer 2 cm off, as a baked grid's distance would be
            c = new.collision
            return new._replace(collision=c._replace(dis=c.dis + 0.02)), out
        obs = dict(out.obs)
        obs["depth"] = obs["depth"].clone()
        obs["depth"][0] += 0.5
        return new, out._replace(obs=obs)

    def sensor_observations(self, state):
        imgs = self._env.sensor_observations(state)
        if self._fault == "unchanged":
            last, self._last = self._last, imgs
            return last if last is not None else imgs
        imgs = {k: v.clone() for k, v in imgs.items()}
        if self._fault == "half":
            h = imgs["depth"].shape[0] // 2
            for v in imgs.values():
                v[h:] = 0
            return imgs
        imgs["depth"][0] += 0.5
        return imgs


@pytest.mark.parametrize("name,fault", [
    *[("crossing_tiny.rollout", f) for f in ("unchanged", "half", "altered", "collision")],
    *[("crossing_tiny.render", f) for f in ("unchanged", "half", "altered")]])
def test_a_broken_path_is_not_correct(name, fault):
    cell = _fixture.cell(name)
    cell.traffic = dict(cell.traffic, check_agents=8)
    from portbench.harness import run

    torch.set_num_threads(2)
    r = run(cell, 9, 1.0, False, device="cpu", require_cuda=False,
            wrap_env=lambda env: Broken(env, fault))
    assert not r["correct"], r["checks"]
