"""sam_encoder_ms_per_request: device milliseconds a request of the kernels
launched under the range the harness puts around SAM's image encoder
(``portbench.sam_encoder``, at ``sam.encode_uint8``: the resize, ViT-B with
K4 in its global layers, the neck), in the traced requests."""


def read(ctx):
    t = ctx.trace
    if t is None or "portbench.sam_encoder" not in t.ranges_us:
        return None
    return t.ranges_us["portbench.sam_encoder"] / 1e3 / t.steps
