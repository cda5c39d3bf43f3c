"""The benchmark's run: set-up, the measured window, the traced window and
its per-layer readers, and the comparison that decides ``correct``.

Everything of one configuration, traffic mix, per-layer metric or cell is
found by its name in ``BENCHMARK.json``: the configuration at its ``file``
with its plain reference beside it (same stem, ``.py``), the mix at
``<paths[0]>/traffic/<name>.json``, a metric's reader at
``<paths[0]>/metrics/<name>.py`` or, where there is none, at the file of
the name's first part (``render_roofline.rollout`` and
``render_roofline.render`` share ``metrics/render_roofline.py``), a cell's
limits at ``<paths[0]>/limits/<cell>.json``.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import random
import sys
import time

BANNED = ("jax", "jaxlib", "flax", "visfly_tpu")


def process_age_s():
    """Seconds since this process started, from its own /proc entries."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of a ``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root, name, bench_file="BENCHMARK.json"):
        self.root = os.path.abspath(root)
        with open(os.path.join(self.root, bench_file)) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in {bench_file}: {sorted(cells)}")
        self.name, self.work = name, cells[name]
        cfg = {c["name"]: c for c in self.bench["configs"]}[self.work["config"]]
        self.config_path = os.path.join(self.root, cfg["file"])
        with open(self.config_path) as f:
            self.config = json.load(f)
        self.config_name = cfg["name"]
        self.home = os.path.join(self.root, self.bench["paths"][0])
        with open(os.path.join(self.home, "traffic", f"{self.work['traffic']}.json")) as f:
            self.traffic = json.load(f)
        limits = os.path.join(self.home, "limits", f"{name}.json")
        self.limits = {}
        if os.path.isfile(limits):
            with open(limits) as f:
                self.limits = json.load(f)["limits"]

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self):
        return [m for m in self.bench["per_layer"]
                if "workloads" not in m or self.name in m["workloads"]]

    def reader(self, metric):
        for stem in (metric, metric.split(".")[0]):
            path = os.path.join(self.home, "metrics", f"{stem}.py")
            if os.path.isfile(path):
                return load_module(path, "portbench_metric_" + stem.replace(".", "_"))
        raise FileNotFoundError(f"no reader for {metric!r} under {self.home}/metrics")

    def reference(self, device, dtype=None):
        import torch

        mod = load_module(os.path.splitext(self.config_path)[0] + ".py",
                          "portbench_ref_" + self.config_name)
        return mod.Reference(self.config, device, dtype or torch.float32)


def scratch_dir(*parts):
    """A fixed directory under the run's TMPDIR."""
    base = os.environ.get("TMPDIR") or os.path.join(os.path.expanduser("~"), ".cache")
    path = os.path.join(base, "portbench", *parts)
    os.makedirs(path, exist_ok=True)
    return path


def build_env(cell, device):
    """The program's env of the cell's configuration."""
    from visfly_tpu_torch import envs

    kw = copy.deepcopy(cell.config["env_kwargs"])
    env = getattr(envs, cell.config["env_class"])(device=device, **kw)
    env.terminal_obs_in_info = bool(cell.config.get("terminal_obs_in_info", False))
    return env


def window_metrics(entry, agents, n, wall, gaps_ms):
    """The window's end-to-end numbers: a rate over all its work and all its
    time (agents × units ÷ the seconds from its start to the synchronize
    after its last unit), and for steps the 95th percentile of the gaps
    between all consecutive step boundaries."""
    if entry == "step":
        return {"env_steps_per_s": agents * n / wall,
                "step_ms_p95": p95(gaps_ms) if gaps_ms else float("nan")}
    return {"frames_per_s": agents * n / wall}


def p95(values):
    """The 95th percentile, nearest rank, of all values."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


class Reservoir:
    """A sample of ``k`` of the window's units, drawn from the seed."""

    def __init__(self, k, seed):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def wants(self):
        self.seen += 1
        if len(self.items) < self.k:
            return len(self.items)
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None

    def put(self, slot, item):
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


def banned_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def checked(cell, samples, check_agents, seed):
    """Each sampled unit with the cameras it is judged on, drawn from the seed."""
    import torch

    rng = random.Random(seed ^ 0x9E3779B9)
    step = cell.traffic["entry"] == "step"
    for item in samples:
        n = item[0].dyn.pos.shape[0] if step else item[0][0].shape[0]
        yield item, torch.tensor(sorted(rng.sample(range(n), min(check_agents, n))))


def judge(cell, samples, ref_device, check_agents, seed):
    """The numbers of the sampled units against their limits → (numbers,
    units that failed)."""
    from portbench.reference import common

    ref = cell.reference(ref_device)
    check = common.check_step if cell.traffic["entry"] == "step" else common.check_frames
    all_nums, failed = [], 0
    for item, cams in checked(cell, samples, check_agents, seed):
        nums = check(ref, (*item, cams))
        all_nums.append(nums)
        failed += any(v > cell.limits.get(k, 0.0) for k, v in nums.items())
    return common.merge(all_nums), failed


def run(cell, seed, seconds, trace, device="cuda", require_cuda=True, wrap_env=None):
    """One run of ``cell`` → the result dict (the last line's object)."""
    import torch

    from portbench.traffic import Traffic

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.work["chips"]):
            raise SystemExit(f"{cell.name} needs {cell.work['chips']} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tp = cell.traffic
    env = build_env(cell, device)
    if wrap_env is not None:
        env = wrap_env(env)
    load = Traffic(env, tp, seed)
    for _ in range(int(tp["warmup"])):
        load.step()
    sync()
    reservoir = Reservoir(int(tp["check_samples"]), seed)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}, "device": {}}
    setup_s = process_age_s()
    if trace:
        from portbench import trace as tr

        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        n = int(tp["trace_units"])
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("window"):
                for _ in range(n):
                    slot = reservoir.wants()
                    item = load.step(traced=True, keep=slot is not None)
                    if slot is not None:
                        reservoir.put(slot, item)
                sync()
        dev, spans = tr.events_of(prof, scratch_dir("trace"))
        win = [sp for sp in spans if sp[0] == "window"][0]
        window = (win[1], win[2])
        busy = tr.union_length([(max(s, window[0]), min(e, window[1])) for _, s, e in dev
                                if e > window[0] and s < window[1]]) * 1e-6
        window_s = (window[1] - window[0]) * 1e-6
        result["breakdown"] = tr.breakdown(dev, spans, window)
        result["device"].update(busy_s=busy, window_s=window_s)
        ctx = ReaderContext(cell, env, load, reservoir, busy, window_s, device)
        for m in cell.per_layer():
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["attempted"] = n
    else:
        gaps_ms, events = [], []
        t0 = time.perf_counter()
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        n = 0
        while time.perf_counter() - t0 < seconds:
            slot = reservoir.wants()
            item = load.step(keep=slot is not None)
            if slot is not None:
                reservoir.put(slot, item)
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            n += 1
        sync()
        wall = time.perf_counter() - t0
        if cuda:
            gaps_ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
        result["attempted"] = n
        vals = {"setup_s": setup_s, **window_metrics(tp["entry"], load.agents, n, wall, gaps_ms)}
        for m in cell.end_to_end():
            if m["name"] in vals:
                result["metrics"][m["name"]] = {"value": float(vals[m["name"]]),
                                                "unit": m["unit"]}
    if cuda:
        result["device"].update(platform="gpu", kind=torch.cuda.get_device_name(0),
                                count=int(cell.work["chips"]),
                                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    else:
        result["device"].update(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    sync()
    # the program's live state goes before the reference runs; the sampled
    # units it keeps are what is judged
    load.state = load.pool = None
    del env
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nums, failed = judge(cell, reservoir.items, device, int(tp["check_agents"]), seed)
    print(f"the reference took {time.perf_counter() - t0:.1f} s for {len(reservoir.items)} "
          f"sampled units", file=sys.stderr)
    result["failed"] = failed
    result["correct"] = failed == 0 and len(reservoir.items) > 0 and all(
        math.isfinite(v) for v in nums.values())
    result["checks"] = {k: {"value": v, "limit": cell.limits.get(k, 0.0)} for k, v in nums.items()}
    return result


class ReaderContext:
    """What a per-layer reader reads: the cell, the program's env, the
    traced window's busy and wall seconds, its sampled units, and helpers
    that time calls into the program on them."""

    def __init__(self, cell, env, load, reservoir, busy_s, window_s, device):
        self.cell, self.env, self.load = cell, env, load
        self.samples = reservoir.items
        self.busy_s, self.window_s, self.device = busy_s, window_s, device

    @property
    def cuda(self):
        import torch

        return torch.device(self.device).type == "cuda"

    def states(self):
        """(pose source state, action) of each sampled unit: for a step its
        state before and its action, for a frame batch its pose state."""
        if self.cell.traffic["entry"] == "step":
            return [(s[0], s[1]) for s in self.samples]
        pool = self.load.pool
        return [(pool[i % len(pool)], None) for i in range(len(self.samples))]

    def host_ms(self, fn, args_list):
        """Mean host-clock ms of ``fn(*args)`` over ``args_list``, a
        synchronize before and after each call, after one call unclocked."""
        import torch

        fn(*args_list[0])
        total = 0.0
        for args in args_list:
            if self.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            if self.cuda:
                torch.cuda.synchronize()
            total += time.perf_counter() - t0
        return total / len(args_list) * 1e3

    def event_ms(self, fn, args_list):
        """Mean ms of ``fn(*args)`` by CUDA events around each call, after
        one call unmeasured."""
        import torch

        fn(*args_list[0])
        total = 0.0
        for args in args_list:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(*args)
            b.record()
            torch.cuda.synchronize()
            total += a.elapsed_time(b)
        return total / len(args_list)

    def device_s_under_span(self, fn, args_list, name):
        """Device seconds a call of the kernels launched inside the
        benchmark's span ``name`` around each ``fn(*args)``, from a profiler
        window of those calls alone."""
        import torch

        from portbench import trace as tr

        fn(*args_list[0])
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for args in args_list:
                with torch.profiler.record_function(name):
                    fn(*args)
            torch.cuda.synchronize()
        dev, _spans = tr.events_of(prof, scratch_dir("trace"))
        return tr.union_length([(s, e) for _, s, e in dev]) * 1e-6 / len(args_list)
