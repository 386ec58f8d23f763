"""sam_decoder_ms_per_request: device milliseconds a request of the kernels
launched under the range the harness puts around SAM's mask decoder
(``portbench.sam_decoder``, at ``sam.decode_masks``: the prompt encoding,
the two-way transformer, the upscaling, every box of the request), in the
traced requests."""


def read(ctx):
    t = ctx.trace
    if t is None or "portbench.sam_decoder" not in t.ranges_us:
        return None
    return t.ranges_us["portbench.sam_decoder"] / 1e3 / t.steps
