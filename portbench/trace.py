"""Reduction of a ``torch.profiler`` window to the benchmark's numbers: the
device's busy time (the union of the intervals in which a kernel, a copy or
a set ran), the operations that took most time, and the idle gaps named by
the benchmark's own host span that was open when each began."""
from __future__ import annotations

import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle (start, end) gaps of the union of ``intervals`` inside [lo, hi]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def events_of(prof, scratch_dir):
    """(device ops [(name, start_us, end_us)], host spans [(name, start_us,
    end_us)]) of a finished profiler, through its chrome trace."""
    os.makedirs(scratch_dir, exist_ok=True)
    path = os.path.join(scratch_dir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev, spans = [], []
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s = float(e["ts"])
        end = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((e.get("name", "?"), s, end))
        elif cat == "user_annotation":
            spans.append((e.get("name", "?"), s, end))
    return dev, spans


def breakdown(dev, spans, window, top=10):
    """``{"device_ops": [[name, s], ...], "idle_gaps": [[span, s], ...]}``:
    the device operations by total time, and the idle time inside the window
    by the innermost benchmark span open at each gap's start ("none" where
    no span was open)."""
    by_name = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = window
    inner = [sp for sp in spans if sp[0] != "window"]
    idle = {}
    for g0, g1 in gaps([(s, e) for _, s, e in dev], lo, hi):
        open_ = [sp for sp in inner if sp[1] <= g0 < sp[2]]
        name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "none"
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-6
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gap_list]}
