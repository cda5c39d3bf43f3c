"""The render's share of its roofline, in %: the least time the chip could
take for a render of every camera (``portbench/bounds.py``, from the rays,
the scene and the posed templates) ÷ the device time of the kernels
launched inside the benchmark's span around ``env.sensor_observations(state)``
on the traced window's states."""

from portbench import bounds


def read(ctx):
    if not ctx.cuda:
        return None
    states = [s for s, _a in ctx.states()]
    device_s = ctx.device_s_under_span(ctx.env.sensor_observations, [(s,) for s in states],
                                       "sensor_observations")
    ref = ctx.cell.reference(ctx.device)
    work = [ref.work(s.dyn.pos, s.dyn.q) for s in states]
    ops = sum(w[0] for w in work) / len(work)
    nbytes = sum(w[1] for w in work) / len(work)
    if device_s <= 0:
        return None
    return 100.0 * bounds.bound_s(ops, nbytes)[0] / device_s
