"""launches_per_request.location: kernels a request and a card in the traced
slice (device trace): the launches the host makes for a location request."""

from portbench import readers


def read(ctx):
    return readers.launches_per_step(ctx)
