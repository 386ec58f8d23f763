"""pool_bwd_roofline: percent, the least time of K3's work in the traced
steps (the four relu-fused pool backwards, ``work/flops.pool_bwd_work``,
bound by bytes) over the traced time of ``pool_bwd_kernel``."""

from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "pool_bwd", ("pool_bwd_kernel",))
