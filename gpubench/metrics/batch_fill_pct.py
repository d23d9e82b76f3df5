"""Engine: requests over the bucket rows that ran them, the share of the
pow2 buckets' rows that served a request (the rest is padding), over the
batches that ended before the profiler started."""
UNIT = "%"


def read(ctx):
    b = ctx.batches
    if not b:
        return None
    return 100.0 * sum(len(x.ids) for x in b) / sum(x.rows for x in b)
