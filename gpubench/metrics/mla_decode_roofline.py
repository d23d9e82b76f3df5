"""Kernels, MLA decode (``kernels/mla_decode.py``'s entry): the least
time of the traced slice's absorbed-decode calls, from their shapes and
admitted cache positions (``lib.flops.mla_decode_bound_s``), over the
device time of the kernels launched inside those calls."""
from gpubench.lib.flops import mla_decode_bound_s
from gpubench.lib.port import MLA_RANGE

UNIT = "%"


def read(ctx):
    t = ctx.trace
    calls = [c for c in ctx.calls if c[0] == "mla"]
    if t is None or not calls or not t.in_range.get(MLA_RANGE):
        return None
    least = sum(mla_decode_bound_s(q, rope, cache, elt, admitted)
                for _, q, rope, cache, elt, admitted in calls)
    return 100.0 * least / t.in_range[MLA_RANGE]
