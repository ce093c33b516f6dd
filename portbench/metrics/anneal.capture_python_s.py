"""``anneal.capture_python_s`` (s): a level's ``anneal.capture`` span, the
mean over the window's levels after level 0, from the program's own
``separation.graphs.Record`` (host clock): from the warm-up's end to the
step body's return under stream capture. It holds
``anneal.begin_capture`` (the graph made; ``torch.cuda.graph``'s entry:
a wait for the card, a garbage collection, the allocator's cache emptied,
``cudaStreamBeginCapture``), then the Python and autograd that build the
graph while the card runs nothing. Level 1 of a ``--trace 1`` run records
its captured module spans here too (a RefineNet step's 156, a Glow
step's 8). Nothing to read where the program records no spans or captured
no graph after level 0."""

from portbench import spans


def read(ctx):
    return spans.mean_seconds(ctx.record, "anneal.capture")
