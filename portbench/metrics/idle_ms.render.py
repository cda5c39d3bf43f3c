"""Idle ms of the card a step under the render: the idle gaps of the
program trace's window (``portbench/program_trace.py``) whose innermost
span is ``render.sensors``, ``render.scene_trace`` or
``render.object_hits``, over its steps."""
from portbench import program_trace


def read(ctx):
    return program_trace.per_unit(
        ctx, "idle_ms", ("render.sensors", "render.scene_trace", "render.object_hits"))
