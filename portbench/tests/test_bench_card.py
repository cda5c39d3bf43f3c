"""On the card (skips here): each cell's program readings within its limits
and its control past one, at the cell's own size, one seed."""
import pytest

from portbench.tests._fixture import ROOT


@pytest.mark.card
@pytest.mark.parametrize("name", ["crossing_swarm.rollout", "crossing_swarm.render"])
def test_cell_on_card(card, name):
    from portbench.control import readings
    from portbench.harness import Cell, build_env

    cell = Cell(ROOT, name)
    env = build_env(cell, "cuda")
    r = readings(cell, env, 17, 24, "cuda")
    assert all(v <= cell.limits[k] for k, v in r["program"].items()), r
    assert any(v > cell.limits[k] for k, v in r["control"].items()), r
