"""The tiny fixture cells of the benchmark's tests: the crossing
configuration cut to two scenes and 32×32 cameras, under the rollout and the
render mix, on the CPU, with limits of their own."""
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def cell(name):
    from portbench.harness import Cell

    c = Cell(ROOT, name, os.path.join(FIXTURES, "BENCHMARK.json"))
    with open(os.path.join(FIXTURES, "limits.json")) as f:
        c.limits = json.load(f)[name]
    return c


def run(name, seed=5, seconds=1.0, wrap_env=None):
    import torch

    from portbench.harness import run as run_cell

    torch.set_num_threads(2)
    return run_cell(cell(name), seed, seconds, False, device="cpu", require_cuda=False,
                    wrap_env=wrap_env)
