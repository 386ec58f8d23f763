"""idle_other_ms_per_step.depth: milliseconds a step that the card sits idle while the
host is in no phase of a step (between them, or in no program range),
the mean over the traced steps (program span over device trace)."""

from portbench import program_spans


def read(ctx):
    return program_spans.read(ctx, "other")
