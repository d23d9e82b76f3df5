"""Kernels, B3 (``kernels/flash_attention.py``'s entry): the least time
of the traced slice's prefill-attention calls, from their shapes
(``lib.flops.flash_bound_s``), over the device time of the kernels
launched inside those calls."""
from gpubench.lib.flops import flash_bound_s
from gpubench.lib.port import ATTN_RANGE

UNIT = "%"


def read(ctx):
    t = ctx.trace
    calls = [c for c in ctx.calls if c[0] == "attn"]
    if t is None or not calls or not t.in_range.get(ATTN_RANGE):
        return None
    least = sum(flash_bound_s(q, k, v, elt, causal, window)
                for _, q, k, v, elt, causal, window in calls)
    return 100.0 * least / t.in_range[ATTN_RANGE]
