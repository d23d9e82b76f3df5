"""Model step, MoE: device time of the kernels launched inside the
program's ``apply_moe`` calls over all device time of the traced slice;
nothing to read in a model without MoE layers."""
from gpubench.lib.port import MOE_RANGE

UNIT = "%"


def read(ctx):
    t = ctx.trace
    if t is None or not t.in_range.get(MOE_RANGE):
        return None
    return 100.0 * t.in_range[MOE_RANGE] / t.kernel_s
