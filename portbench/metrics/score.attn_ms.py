"""``score.attn_ms`` (ms): the card's milliseconds a Langevin step in the
``attn`` spans of both sources' score forwards (a Flow++ forward's 90
attention cores: ``ops.attention``, softmax(q k^T / sqrt(d)) v over every
position), from the CUDA event pairs the traced level (level 1) captured
into its graph, as its last replay ran them. The input gradient's
attention kernels run under ``score.backward`` and are not in it. Nothing
to read where the program captures no such spans."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx.record, ("attn",))
