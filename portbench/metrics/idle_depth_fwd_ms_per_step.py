"""idle_depth_fwd_ms_per_step: milliseconds a step that the card sits idle while the
host is in Depth Anything's forward (``tbist.depth.forward``), the mean over
the traced steps (program span over device trace)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "depth_fwd")
