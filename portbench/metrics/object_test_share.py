"""The share of the drones' mesh-hit tests that could find a hit, in %:
100 · ``object_hits.candidate_tests`` (tests on rays that meet the object's
bounding sphere ahead, from outside it) ÷ ``object_hits.tests`` (every ray
against every triangle of every posed template), the program's counters
over the program trace's window (``portbench/program_trace.py``)."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.window(ctx)
    counts = pt["counters"] if pt is not None else {}
    if not counts.get("object_hits.tests"):
        return None
    return 100.0 * counts.get("object_hits.candidate_tests", 0) / counts["object_hits.tests"]
