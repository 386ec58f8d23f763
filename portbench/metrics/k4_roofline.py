"""k4_roofline: percent, the least time of K4's work in the traced
requests (SAM's global attention, ``work/sam_attn.k4_bound_s``: 4 N T^2 d
a global layer, three times for 3xTF32, at the card's TF32 peak) over the
traced time of its kernels (``csrc/sam_attn.cu``: the attention and its
split combine)."""

from portbench import readers
from portbench.work import sam_attn


def read(ctx):
    return readers.roofline(ctx, ("sam_attn",), sam_attn.k4_bound_s(ctx.config["sam"],
                                                                      ctx.peaks))
