"""``anneal.warmup_idle_s`` (s): the seconds the card idles inside the
traced level's ``anneal.warmup`` span (level 1: its eager warm-up step
and the wait for it, which no module span marks), the span placed on the
trace's clock by ``portbench.spans.clock`` and the idle time taken from
``torch.profiler``'s device rows (kernels, copies, sets). Nothing to read
without a trace, without the program's spans, or where the clock's check
fails (its third edge more than 0.1 ms off)."""

from portbench import spans


def read(ctx):
    return spans.warmup_idle_s(ctx.record, ctx.trace)
