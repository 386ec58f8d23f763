"""gram_bwd_roofline: percent, the least time of K1's backward work in the
traced steps (``work/flops.gram_bwd_work``) over the traced time of
``gram_bwd_kernel``."""

from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "gram_bwd", ("gram_bwd_kernel",))
