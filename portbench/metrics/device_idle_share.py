"""The device's idle share of the traced window, in %: 1 − (the union of the
intervals in which a kernel, a copy or a set ran ÷ the window's wall time)."""


def read(ctx):
    if not ctx.cuda or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
