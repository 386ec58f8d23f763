"""device_busy_ms_per_step.gatys: milliseconds a step in which the card runs an
operation, the union of its operations over the traced steps (device
trace), the mean over the cell's cards. The device's share of the step:
steady where the host's pace, and with it ``gatys_image_s``, is not."""

from portbench import tracing


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops():
        return None
    return tracing.busy(t)["mean_busy_us"] / 1e3 / t.steps
