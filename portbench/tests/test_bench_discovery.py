"""Cells are found by name from files alone: a configuration, a traffic mix,
per-layer metrics and limits added as new files and entries make a cell the
harness runs, with no edit to a file that exists."""
import json
import os
import shutil

import pytest

from portbench.tests._fixture import FIXTURES, ROOT


def test_a_cell_is_discovered_from_files_alone(tmp_path):
    home = tmp_path / "fx"
    for d in ("configs", "traffic", "metrics", "limits"):
        (home / d).mkdir(parents=True)
    shutil.copy(os.path.join(FIXTURES, "crossing_tiny.json"), home / "configs" / "swarm.json")
    (home / "configs" / "swarm.py").write_text(
        "from portbench.configs.crossing_swarm import Reference  # noqa: F401\n")
    traffic = json.load(open(os.path.join(ROOT, "portbench", "traffic", "rollout.json")))
    traffic.update(warmup=2, check_samples=1, check_agents=6)
    (home / "traffic" / "short_loop.json").write_text(json.dumps(traffic))
    for m in ("dynamics_ms", "reset_ms"):
        shutil.copy(os.path.join(ROOT, "portbench", "metrics", f"{m}.py"), home / "metrics")
    (home / "limits" / "swarm.short_loop.json").write_text(json.dumps({"limits": {
        "state_err": 1e-5, "collision_err": 1e-5, "reward_err": 1e-5, "done_bad": 0,
        "spawn_bad": 0, "depth_bad": 0.05}}))
    bench = {
        "command": ["python3", "-m", "portbench.run"], "paths": ["fx"], "run_seconds": 1,
        "configs": [{"name": "swarm", "source": "fixture", "file": "fx/configs/swarm.json",
                     "reduced": [], "why": "fixture"}],
        "workloads": [{"name": "swarm.short_loop", "config": "swarm", "traffic": "short_loop",
                       "chips": 1, "why": "fixture"}],
        "end_to_end": [{"name": "env_steps_per_s", "unit": "steps/s", "better": "higher",
                        "bound": 0.05, "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [{"name": "dynamics_ms", "unit": "ms", "better": "lower",
                       "source": "host_clock", "layer": "dynamics", "moves": "env_steps_per_s",
                       "workloads": ["swarm.short_loop"]},
                      {"name": "reset_ms", "unit": "ms", "better": "lower",
                       "source": "host_clock", "layer": "env", "moves": "env_steps_per_s",
                       "workloads": ["other.cell"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    import torch

    from portbench.harness import Cell, run

    cell = Cell(str(tmp_path), "swarm.short_loop")
    assert cell.traffic["warmup"] == 2 and cell.limits["depth_bad"] == 0.05
    assert [m["name"] for m in cell.per_layer()] == ["dynamics_ms"]
    assert cell.reader("dynamics_ms").read.__doc__ is None
    # a dotted name without a file of its own takes the reader of its first part
    assert cell.reader("dynamics_ms.rollout").__file__.endswith(os.sep + "dynamics_ms.py")
    with pytest.raises(FileNotFoundError):
        cell.reader("no_such_metric.rollout")
    torch.set_num_threads(2)
    r = run(cell, 4, 0.5, False, device="cpu", require_cuda=False)
    assert set(r["metrics"]) == {"env_steps_per_s", "setup_s"}
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"state_err", "collision_err", "reward_err", "done_bad",
                                "spawn_bad", "depth_bad"}
    with pytest.raises(SystemExit):
        Cell(str(tmp_path), "swarm.missing")


def test_the_benchmark_file_keeps_to_its_shape():
    import re

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    configs = {c["name"] for c in b["configs"]}
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    home = os.path.join(ROOT, b["paths"][0])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert os.path.isfile(os.path.join(ROOT, os.path.splitext(c["file"])[0] + ".py"))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and name.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.isfile(os.path.join(home, "traffic", f"{w['traffic']}.json"))
        assert os.path.isfile(os.path.join(home, "limits", f"{w['name']}.json"))
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert any(os.path.isfile(os.path.join(home, "metrics", f"{stem}.py"))
                   for stem in (m["name"], m["name"].split(".")[0]))
    for w in cells:
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
        assert sum(w in m.get("workloads", cells) for m in b["end_to_end"]) >= 2
