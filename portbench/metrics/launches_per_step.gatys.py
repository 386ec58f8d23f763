"""launches_per_step.gatys: kernels a step and a card in the traced slice
(device trace): the host's issue work a step."""

from portbench import readers


def read(ctx):
    return readers.launches_per_step(ctx)
