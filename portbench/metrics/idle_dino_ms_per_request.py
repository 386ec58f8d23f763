"""idle_dino_ms_per_request: milliseconds a request that the card sits idle
while the host queues GroundingDINO (``tbist.location.dino``: the text
features, Swin-T, the fusion, the deformable layers), the mean over the
traced requests (program span over device trace)."""

from portbench import location_spans


def read(ctx):
    return location_spans.read(ctx, "dino")
