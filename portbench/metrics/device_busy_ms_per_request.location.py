"""device_busy_ms_per_request.location: milliseconds a request in which the
card runs an operation, the union of its operations over the traced
requests (device trace), the mean over the cell's cards. The device's
share of the request: steady where the host's pace is not."""

from portbench import tracing


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops():
        return None
    return tracing.busy(t)["mean_busy_us"] / 1e3 / t.steps
