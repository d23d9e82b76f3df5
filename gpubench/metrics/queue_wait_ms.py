"""Entry and queue: the mean time from a request's due time to the start
of its batch's call (host clock), over the requests whose batch ended
before the profiler started."""
UNIT = "ms"


def read(ctx):
    w = ctx.waits
    return float(w.mean() * 1e3) if len(w) else None
