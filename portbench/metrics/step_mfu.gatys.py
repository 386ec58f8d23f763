"""step_mfu.gatys: percent of the f32 peak of the cell's cards that one
step's model FLOPs take at the step time of the unprofiled requests
(``work/flops.step_flops`` over ``RunMetrics.timings_s``)."""

from portbench import readers


def read(ctx):
    return readers.step_mfu(ctx)
