"""``score.pool_ms`` (ms): the card's milliseconds a Langevin step in the
``pool`` spans of both sources' score forwards (an NCSN v2 forward's 8
5x5 max pools of its CRPs and 2 2x2 average pools), from the CUDA event
pairs the traced level (level 1) captured into its graph, as its last
replay ran them. Nothing to read where the program captures no such
spans."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx.record, ("pool",))
