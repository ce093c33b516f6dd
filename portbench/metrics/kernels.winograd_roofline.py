"""``kernels.winograd_roofline`` (%): over the traced span, the least time
of the convs the hand-written Winograd kernels ran (``portbench.counts``:
their work and bytes from shapes alone, whatever computes them), summed,
over those kernels' device time (``torch.profiler`` rows whose name holds
``winograd_f23``), summed.

Which convs: the routable 3x3 convs of a step, counted by the
configuration's reference on the ``meta`` device, held to the program's
launch counters (``separation.graphs.Record.captures[0].launches``, the
launches of one replay, from ``ops.winograd.counters_since``): the two
must agree, and the kernels in the span must be a whole number of steps
(the eager warm-up step and the traced replays). Nothing to read
otherwise."""

from portbench.counts import least_s, peaks


def read(ctx):
    peak = peaks(ctx.device_name)
    if ctx.trace is None or peak is None or not ctx.record.captures:
        return None
    per_step = ctx.record.captures[0].launches["launch_count"]
    if per_step == 0 or per_step != len(ctx.routed):
        return None
    kernels = [(t0, t1) for n, t0, t1 in ctx.trace.kernels
               if "winograd_f23" in n]
    if not kernels or len(kernels) % per_step:
        return None
    steps = len(kernels) // per_step
    device_s = sum(t1 - t0 for t0, t1 in kernels) * 1e-6
    least = steps * least_s(ctx.routed,
                            ctx.cell.traffic["compute_dtype"], peak)
    return 100.0 * least / device_s
