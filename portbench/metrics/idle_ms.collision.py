"""Idle ms of the card a step under the collision query (the scene's SDF
and the inter-drone override): the idle gaps of the program trace's window
(``portbench/program_trace.py``) whose innermost span is ``env.collision``,
over its steps."""
from portbench import program_trace


def read(ctx):
    return program_trace.per_unit(ctx, "idle_ms", ("env.collision",))
