"""front_ms_per_image.gatys: milliseconds of a request outside the
optimisation: the request's wall time less the program's own span of it
(``RunMetrics.timings_s["gatys"]``, which ends in the loss history's
read-back), the mean over the unprofiled requests. Upload, bucketing, the
API's conversions and the uint8 read-back of the image."""

from portbench import readers


def read(ctx):
    rows = readers.steady(ctx)
    if not rows:
        return None
    return 1e3 * sum(r["wall_s"] - r["timings"]["program_s"] for r in rows) / len(rows)
