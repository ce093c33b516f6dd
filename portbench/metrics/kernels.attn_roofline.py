"""``kernels.attn_roofline`` (%): over the traced span, the least time of
the attention calls the program ran (``portbench.attn_counts``: their work
and bytes, forward and input gradient, from shapes alone, whatever
computes them), summed, over the device time of the attention kernels,
forward and backward (``torch.profiler`` rows whose name holds one of
the program's attention kernels, ``ops.attention.KERNELS``: PyTorch's
memory-efficient attention), summed.

Which calls: one step's, ``(N, heads, T, d)`` each, counted by the
configuration's reference on the ``meta`` device
(``arch/<arch>.attention_calls``), held to the program's counter
(``separation.graphs.Record.captures[i].launches["attn"]``, the calls of
one replay of the traced level's graph, from ``ops.counting``): the two
must agree shape for shape, and the span's forward and backward kernels
must each be a whole number of steps, the same number (the eager warm-up
step and the traced replays). Nothing to read otherwise: without a trace,
a card in ``peaks.json``, the program's counter and kernel names, or an
arch that counts attention."""

import collections

from portbench import spec, spans
from portbench.attn_counts import least_s
from portbench.counts import peaks


def read(ctx):
    peak = peaks(ctx.device_name)
    if ctx.trace is None or peak is None:
        return None
    try:
        from audiosourcesep_tpu_torch.ops.attention import KERNELS
    except ImportError:
        return None
    forward, backward = KERNELS
    arch = spec.arch(ctx.cell.config["arch"])
    if not hasattr(arch, "attention_calls"):
        return None
    calls = arch.attention_calls(ctx.cell.config, ctx.cell.traffic)
    level = spans.traced_level(ctx.record)
    caps = [c for c in ctx.record.captures if c.level == level]
    if not calls or not caps or "attn" not in caps[0].launches:
        return None
    counted = caps[0].launches["attn"]
    per_step = counted["launch_count"]
    shapes = {k: n for k, n in counted["shapes"].items() if n}
    if per_step != len(calls) or shapes != collections.Counter(calls):
        return None
    fwd = [t1 - t0 for n, t0, t1 in ctx.trace.kernels if forward in n]
    bwd = [t1 - t0 for n, t0, t1 in ctx.trace.kernels if backward in n]
    if not fwd or len(fwd) % per_step or len(bwd) != len(fwd):
        return None
    steps = len(fwd) // per_step
    device_s = (sum(fwd) + sum(bwd)) * 1e-6
    least = steps * least_s(calls, ctx.cell.traffic["compute_dtype"], peak)
    return 100.0 * least / device_s
