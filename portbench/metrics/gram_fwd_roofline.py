"""gram_fwd_roofline: percent, the least time of K1's forward work in the
traced steps (the five style Grams, symmetric: ``work/flops.gram_fwd_work``)
over the traced time of its kernels (``csrc/gram.cu``: the partial Grams
and their split-K reduce)."""

from portbench import readers


def read(ctx):
    return readers.kernel_roofline(ctx, "gram_fwd", ("gram_fwd_kernel", "gram_reduce_kernel"))
