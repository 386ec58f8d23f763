"""idle_update_ms_per_step.gatys: milliseconds a step that the card sits idle while the
host is in the L-BFGS update (``tbist.step.update``), the mean over the traced
steps (program span over device trace)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "update")
