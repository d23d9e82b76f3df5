"""Model step: the operations the served requests need (``lib.flops``:
real prompt tokens, causal attention's pairs, routed top-k and shared
experts, the served positions' unembedding, each decode step) over the
time the model's calls took, against the card's bf16 peak; over the
batches that ended before the profiler started."""
from gpubench.lib.peaks import BF16_FLOPS

UNIT = "%"


def read(ctx):
    b = ctx.batches
    if not b:
        return None
    busy = sum(x.t_end - x.t_call for x in b)
    work = ctx.request_flops * sum(len(x.ids) for x in b)
    return 100.0 * work / (busy * BF16_FLOPS)
