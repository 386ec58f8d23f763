"""idle_depth_bwd_ms_per_step: milliseconds a step that the card sits idle while the
host is in Depth Anything's backward (``tbist.depth.backward``, opened and
closed by gradient hooks on the autograd thread), the mean over the traced
steps (program span over device trace)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "depth_bwd")
