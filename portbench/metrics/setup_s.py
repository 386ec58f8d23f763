"""setup_s: seconds from the process's start to the window's start:
imports, the card, the kernels' build or load, the seeded weights, the
images and the warm-up request (host clock)."""


def read(ctx):
    return ctx.setup_s
