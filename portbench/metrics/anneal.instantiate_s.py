"""``anneal.instantiate_s`` (s): a level's ``anneal.instantiate`` span, the
mean over the window's levels after level 0, from the program's own
``separation.graphs.Record`` (host clock): ``cudaStreamEndCapture`` and
``cudaGraphInstantiate`` of the level's graph. With ``anneal.capture`` it
makes the capture seconds that ``anneal.level_overhead_s`` adds. Nothing
to read where the program records no spans or captured no graph after
level 0."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(ctx.record, "anneal.instantiate")
