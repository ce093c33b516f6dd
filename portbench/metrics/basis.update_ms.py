"""``basis.update_ms`` (ms): the card's milliseconds a Langevin step
outside the score spans: ``anneal.noise`` (the draw) and ``basis.update``
(the score clip, the mixing ``g`` and its gradient, the in-place update),
from the CUDA event pairs the traced level (level 1) captured into its
graph, as its last replay ran them. Nothing to read where the program
records no such spans."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx.record, ("anneal.noise", "basis.update"))
