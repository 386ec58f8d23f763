"""device_idle_share.gatys: percent of the traced window in which a card
runs no operation, the mean over the cell's cards (device trace)."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
