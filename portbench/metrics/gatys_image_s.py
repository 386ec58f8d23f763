"""gatys_image_s: window seconds over the 512px Gatys images completed in it, the
wait of a user who sends one request at a time (host clock)."""

from portbench import readers


def read(ctx):
    return readers.image_s(ctx)
