"""idle_fwd_ms_per_step.depth: milliseconds a step that the card sits idle while the
host is in the step's forward outside Depth Anything (``tbist.step.forward``:
VGG-19 and the loss terms), the mean over the traced steps (program span
over device trace)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "fwd")
