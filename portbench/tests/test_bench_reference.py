"""The plain reference against the port on the CPU at tiny sizes: a run of
each fixture cell comes out correct, every number within its limit; the
control (the reference in bfloat16 in the program's place) fails one."""
import pytest

from portbench.tests import _fixture

CELLS = ["crossing_tiny.rollout", "crossing_tiny.render"]


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name):
    r = _fixture.run(name)
    assert r["attempted"] > 0
    assert r["correct"], r["checks"]
    for k, v in r["checks"].items():
        assert v["value"] <= v["limit"], (k, v)
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    import torch

    from portbench.control import readings
    from portbench.harness import build_env

    torch.set_num_threads(2)
    cell = _fixture.cell(name)
    env = build_env(cell, "cpu")
    r = readings(cell, env, 3, 6, "cpu")
    assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
    assert any(v > cell.limits[k] for k, v in r["control"].items()), r
