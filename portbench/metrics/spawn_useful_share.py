"""The share of the spawn rejection's drawn agents that take the spawn, in
%: 100 · ``reset.respawned`` (the done agents an auto-reset respawns) ÷
``spawn.agents`` (the agents each spawn draws and tests, every agent every
step), the program's counters over the program trace's window
(``portbench/program_trace.py``)."""
from portbench import program_trace


def read(ctx):
    pt = program_trace.window(ctx)
    counts = pt["counters"] if pt is not None else {}
    if not counts.get("spawn.agents"):
        return None
    return 100.0 * counts.get("reset.respawned", 0) / counts["spawn.agents"]
