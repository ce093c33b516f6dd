"""``device.idle_share.sep`` (%): the share of a separation level in which
no operation runs on the card, from ``torch.profiler``'s device rows (the
union of kernel, memcpy and memset intervals) over the traced span.

The span holds level 1's eager warm-up step, capture and instantiation
(the part before the first replay) and R replays; a level runs T replays.
So the level's share is composed at the separation's own ratio:
``1 - (busy_pre + T/R busy_replays) / (pre + T/R replays)``. The profiler
shows the kernels inside graph replays one by one on an H100; where a
trace holds no replay, or no kernel inside the replays, nothing is
read."""

from portbench.trace import busy_us, first


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    lo, hi = tr.span
    rep = first(tr, "replay")
    if rep is None or tr.replays == 0:
        return None
    busy_rep = busy_us(tr, rep[0], hi)
    if busy_rep == 0.0:
        return None
    pre, reps = rep[0] - lo, hi - rep[0]
    busy_pre = busy_us(tr, lo, rep[0])
    scale = ctx.cell.config["T"] / tr.replays
    return 100.0 * (1.0 - (busy_pre + scale * busy_rep)
                    / (pre + scale * reps))
