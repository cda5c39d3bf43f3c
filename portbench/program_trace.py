"""The program's own spans and counters, read from one profiled window.

``window(ctx)`` runs ``trace_units`` more units of the cell's traffic under
``torch.profiler``, after the traced window whose units were sampled (so
the sample is already kept), with the program's counters cleared before
it. It joins each device event to its launch (the ``cuda_runtime`` or
``cuda_driver`` event of the same correlation id), gives each kernel to
the innermost span open at its launch's host time, and each idle gap of the
window to the innermost span open at the gap's start (``trace.gaps``, and
``trace.breakdown``'s rule: the shortest span that holds the time). Spans
are the program's (``env.*``, ``render.*``) and the benchmark's own
(``env.step``, ``sensor_observations``, ...), so a kernel launched outside
every program span falls to the benchmark's span. The result is memoized
on ``ctx``, so the readers share one window. Where the program has no
spans or counters, ``window`` returns None and runs nothing.
"""
from __future__ import annotations

import json
import os
import sys

from portbench import trace as tr

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def parse(events):
    """(device events [(name, start, end, correlation)], launch host times
    {correlation: ts}, spans [(name, start, end)]) of chrome trace events."""
    dev, launches, spans = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in tr.DEVICE_CATS:
            dev.append((e.get("name", "?"), s, end, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = s
        elif cat == "user_annotation":
            spans.append((e.get("name", "?"), s, end))
    return dev, launches, spans


def innermost(spans, times):
    """The name of the innermost span (the shortest that holds it) open at
    each time, "none" where no span is open; one sweep over both sorted."""
    order = sorted(range(len(times)), key=times.__getitem__)
    todo = sorted(spans, key=lambda sp: sp[1])
    out, open_, j = ["none"] * len(times), [], 0
    for i in order:
        t = times[i]
        while j < len(todo) and todo[j][1] <= t:
            open_.append(todo[j])
            j += 1
        open_ = [sp for sp in open_ if sp[2] > t]
        if open_:
            out[i] = min(open_, key=lambda sp: sp[2] - sp[1])[0]
    return out


def attribute(dev, launches, spans, window):
    """Device ms and idle ms of the window by span: ``{"kernel_ms": {span:
    ms}, "idle_ms": {span: ms}, "idle_total_ms", "window_ms", "events",
    "joined", "spans_seen"}``, ``joined`` the share of the window's device
    events whose launch was found (those not joined fall under
    "unjoined")."""
    lo, hi = window
    inner = [sp for sp in spans if sp[0] != "window"]
    dev = [d for d in dev if d[2] > lo and d[1] < hi]
    joined = [d for d in dev if d[3] in launches]
    names = innermost(inner, [launches[d[3]] for d in joined])
    by_span = {}
    for name, d in zip(names, joined):
        by_span.setdefault(name, []).append((max(d[1], lo), min(d[2], hi)))
    lost = [(max(d[1], lo), min(d[2], hi)) for d in dev if d[3] not in launches]
    if lost:
        by_span["unjoined"] = lost
    kernel_ms = {k: tr.union_length(v) * 1e-3 for k, v in by_span.items()}
    gaps = tr.gaps([(d[1], d[2]) for d in dev], lo, hi)
    idle_ms = {}
    for name, (g0, g1) in zip(innermost(inner, [g[0] for g in gaps]), gaps):
        idle_ms[name] = idle_ms.get(name, 0.0) + (g1 - g0) * 1e-3
    return {"kernel_ms": kernel_ms, "idle_ms": idle_ms,
            "idle_total_ms": sum((g1 - g0) for g0, g1 in gaps) * 1e-3,
            "window_ms": (hi - lo) * 1e-3, "events": len(dev),
            "joined": len(joined) / len(dev) if dev else None,
            "spans_seen": sorted({sp[0] for sp in inner})}


def _program_profiling():
    from visfly_tpu_torch.utils import profiling

    if all(hasattr(profiling, f) for f in ("tracing", "counters", "reset_counters")):
        return profiling
    return None


def _run(ctx):
    import torch

    from portbench.harness import scratch_dir

    profiling = _program_profiling()
    if profiling is None:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if ctx.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    n = int(ctx.cell.traffic["trace_units"])
    profiling.reset_counters()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("window"):
            for _ in range(n):
                ctx.load.step(traced=True)
            if ctx.cuda:
                torch.cuda.synchronize()
    counts = profiling.counters()
    path = os.path.join(scratch_dir("program_trace"), "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            dev, launches, spans = parse(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
    win = [sp for sp in spans if sp[0] == "window"][0]
    out = attribute(dev, launches, spans, (win[1], win[2]))
    out.update(units=n, counters=counts)
    print(f"program trace: {n} units, {out['events']} device events, joined "
          f"{out['joined']}, idle {out['idle_total_ms']:.3f} of {out['window_ms']:.3f} ms, "
          f"idle ms by span {out['idle_ms']}, device ms by span {out['kernel_ms']}, "
          f"counters {counts}", file=sys.stderr)
    return out


def window(ctx):
    """The program trace of ``ctx``'s cell (above), run once a context."""
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = _run(ctx)
    return ctx.program_trace


def per_unit(ctx, key, names):
    """ms a unit under the spans ``names`` of ``window(ctx)[key]``, or None
    where the program has no spans or the run no card."""
    pt = window(ctx) if ctx.cuda else None
    if pt is None or not pt["events"]:
        return None
    found = [v for k, v in pt[key].items() if k in names]
    if not any(sp in names for sp in pt["spans_seen"]):
        return None
    return sum(found) / pt["units"]
