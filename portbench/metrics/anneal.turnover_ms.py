"""``anneal.turnover_ms`` (ms): the time a level costs besides its steps,
the program's ``anneal.turnover`` span (host clock; from the end of the
last level's replays to the start of this level's: the release, the
benchmark's callback, ``make_step``, the eager warm-up step, the capture
and the instantiation), the mean over the window's levels from level 3
on. Level 0 pays the process's first capture; a ``--trace 1`` run starts
the profiler in level 1's turnover and stops it in level 1's replays, so
levels 1 and 2 carry its start and the first capture after it. Nothing to
read where the program records no such span."""

from portbench import spans


def read(ctx):
    found = [s.seconds for s in spans.all_spans(ctx.record)
             if s.name == "anneal.turnover" and s.level is not None
             and s.level >= 3]
    return 1e3 * sum(found) / len(found) if found else None
