"""idle_sam_ms_per_request: milliseconds a request that the card sits idle
while the host queues SAM (``tbist.location.sam_encode``: the image
encoder; ``tbist.location.sam_decode``: the boxes' decode and the resize
back), the mean over the traced requests (program span over device
trace)."""

from portbench import location_spans


def read(ctx):
    return location_spans.read(ctx, "sam")
