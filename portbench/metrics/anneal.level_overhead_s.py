"""``anneal.level_overhead_s`` (s): a level's eager warm-up step plus its
CUDA graph's capture and instantiation, the mean over the window's levels
after level 0 (levels 1 to 9 of a separation are alike; level 0, which
pays the process's first capture, is ``anneal.first_level_overhead_s``),
from the program's own ``separation.graphs.Record`` (``captures[*]
.warmup_s`` and ``.capture_s``, host clock; the warm-up ends in a wait for
the card). A ``--trace 1`` run holds levels 0 and 1 at least and traces
level 1 on the profiler's CUDA rows alone, whose cost in the capture is
small. Nothing to read where the window captured no graph after level 0."""


def read(ctx):
    caps = [c for c in ctx.record.captures if c.level > 0]
    if not caps:
        return None
    return sum(c.warmup_s + c.capture_s for c in caps) / len(caps)
