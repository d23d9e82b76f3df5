"""Device: the share of the traced slice in which no kernel, copy or set
ran, from the profiler's own timeline."""
UNIT = "%"


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
