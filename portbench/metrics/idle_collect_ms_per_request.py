"""idle_collect_ms_per_request: milliseconds a request that the card sits
idle while the host is in ``tbist.location.collect`` (DINO's logits read
back, thresholded, the phrases decoded), the mean over the traced requests
(program span over device trace)."""

from portbench import location_spans


def read(ctx):
    return location_spans.read(ctx, "collect")
