"""dino_ms_per_request: device milliseconds a request of the kernels
launched under the range the harness puts around GroundingDINO's forward
(``portbench.dino``, at ``dino_sam._dino_forward``: Swin-T, BERT's fusion,
the deformable encoder and decoder), in the traced requests."""


def read(ctx):
    t = ctx.trace
    if t is None or "portbench.dino" not in t.ranges_us:
        return None
    return t.ranges_us["portbench.dino"] / 1e3 / t.steps
