"""Engine: the mean host time from the end of one batch's call to the
start of the next while requests were waiting (forming the batch, the
queue's bookkeeping), over the batches that ended before the profiler
started; nothing to read when none of them found a queue."""
from gpubench.lib.stats import host_gaps

UNIT = "ms"


def read(ctx):
    gaps, _ = host_gaps(ctx.batches)
    return float(gaps.mean() * 1e3) if len(gaps) else None
