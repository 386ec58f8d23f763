"""depth_fwd_ms_per_step: device milliseconds a step of the kernels
launched under the range the harness puts around the depth model's
forward (``portbench.depth_fwd``), in the traced steps. Its backward runs
outside the range."""


def read(ctx):
    t = ctx.trace
    if t is None or "portbench.depth_fwd" not in t.ranges_us:
        return None
    return t.ranges_us["portbench.depth_fwd"] / 1e3 / t.steps
