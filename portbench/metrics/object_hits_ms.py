"""Device ms a unit (an env step, a frame batch) of the drones' mesh hits:
the union of the intervals of the kernels launched inside the program's
``render.object_hits`` spans in the program trace's window
(``portbench/program_trace.py``), over its units."""
from portbench import program_trace


def read(ctx):
    return program_trace.per_unit(ctx, "kernel_ms", ("render.object_hits",))
