"""The benchmark of ``visfly_tpu_torch`` on one H100.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It prints the numbers it compared, each beside
its limit, as its last lines on standard error, and one JSON object as the
last line of standard output. It exits with another code than 0, and prints
no result, where the card the cell asks for is missing or where JAX or the
JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build and kernel caches at fixed paths in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    from portbench.harness import Cell, banned_modules, run

    cell = Cell(ROOT, args.workload)
    result = run(cell, args.seed, args.seconds, bool(args.trace))
    found = banned_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
