"""The program trace (``portbench/program_trace.py``): device events joined
to their launches and given to the span open at the launch, idle gaps to the
span open at their start, on synthetic chrome-trace events; and a traced run
of the CPU fixture cell that reads the program's counters."""
import json
import os

import pytest

from portbench import program_trace as pt
from portbench.tests import _fixture

NEW_METRICS = ("idle_ms.spawn", "idle_ms.collision", "idle_ms.dynamics", "idle_ms.render",
               "object_hits_ms.rollout", "object_test_share.rollout", "spawn_useful_share")


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# a window of 100 us: the benchmark's env.step over 0-90, the program's
# env.spawn over 10-20 and render.object_hits over 30-60; kernel 1 launched
# inside env.spawn runs while render.object_hits is open, kernel 2 is
# launched under env.step alone, kernel 3 inside render.object_hits, and a
# copy (4) has no launch in the trace
EVENTS = [
    _x("user_annotation", "window", 0, 100),
    _x("user_annotation", "env.step", 0, 90),
    _x("user_annotation", "env.spawn", 10, 10),
    _x("user_annotation", "render.object_hits", 30, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=2),
    _x("cuda_driver", "cuLaunchKernel", 35, 1, corr=3),
    _x("kernel", "k1", 40, 10, corr=1),
    _x("kernel", "k2", 50, 5, corr=2),
    _x("kernel", "k3", 60, 10, corr=3),
    _x("gpu_memcpy", "copy", 80, 2, corr=4),
    {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 15, "id": 1},
]


@pytest.fixture
def attributed():
    dev, launches, spans = pt.parse(EVENTS)
    assert len(dev) == 4 and launches == {1: 15.0, 2: 25.0, 3: 35.0} and len(spans) == 4
    return pt.attribute(dev, launches, spans, (0.0, 100.0))


def test_a_kernel_goes_to_the_span_open_at_its_launch(attributed):
    ms = attributed["kernel_ms"]
    assert ms["env.spawn"] == pytest.approx(0.010)
    assert ms["render.object_hits"] == pytest.approx(0.010)
    assert attributed["joined"] == pytest.approx(0.75)
    assert ms["unjoined"] == pytest.approx(0.002)


def test_a_kernel_launched_outside_program_spans_falls_to_the_benchmark_span(attributed):
    assert attributed["kernel_ms"]["env.step"] == pytest.approx(0.005)
    assert "window" not in attributed["kernel_ms"]
    assert attributed["spans_seen"] == ["env.spawn", "env.step", "render.object_hits"]


def test_an_idle_gap_goes_to_the_innermost_span_at_its_start(attributed):
    idle = attributed["idle_ms"]
    # gaps 0-40 (env.step), 55-60 (render.object_hits), 70-80 and 82-100 (env.step)
    assert idle == pytest.approx({"env.step": 0.068, "render.object_hits": 0.005})
    assert attributed["idle_total_ms"] == pytest.approx(sum(idle.values()))
    assert attributed["window_ms"] == pytest.approx(0.100)


def test_innermost_is_the_shortest_open_span():
    spans = [("outer", 0.0, 10.0), ("inner", 2.0, 4.0), ("late", 6.0, 8.0)]
    assert pt.innermost(spans, [9.0, 3.0, 1.0, 7.0, 4.0, 11.0]) == [
        "outer", "inner", "outer", "late", "outer", "none"]


def test_a_traced_fixture_run_reads_both_shares(monkeypatch):
    import torch

    from portbench.harness import run

    with open(os.path.join(_fixture.ROOT, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    cell = _fixture.cell("crossing_tiny.rollout")
    cell.bench["per_layer"] += [dict(entries[n], workloads=[cell.name]) for n in NEW_METRICS]
    monkeypatch.setitem(cell.traffic, "trace_units", 4)
    torch.set_num_threads(2)
    r = run(cell, 7, 1.0, True, device="cpu", require_cuda=False)
    assert r["correct"], r["checks"]
    # the span readers read the card's time and find nothing on the CPU
    assert set(r["metrics"]) == {"object_test_share.rollout", "spawn_useful_share"}
    assert 0.0 <= r["metrics"]["object_test_share.rollout"]["value"] <= 100.0
    assert 0.0 <= r["metrics"]["spawn_useful_share"]["value"] <= 100.0
