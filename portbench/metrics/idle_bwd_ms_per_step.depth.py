"""idle_bwd_ms_per_step.depth: milliseconds a step that the card sits idle while the
host is in the step's backward outside Depth Anything's
(``tbist.step.backward``: autograd through VGG-19 and the loss), the mean
over the traced steps (program span over device trace)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "bwd")
