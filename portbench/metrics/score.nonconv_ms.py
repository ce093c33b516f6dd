"""``score.nonconv_ms`` (ms): the card's milliseconds a Langevin step in
both sources' ``score.forward`` spans less their ``conv`` spans (convs
with their layout copies and bias adds): the score nets' norms,
activations, pools, resizes and the rest. From the CUDA event pairs the
traced level (level 1) captured into its graph (a RefineNet forward asks
for its convs' pairs), as its last replay ran them. Nothing to read where
a forward holds no timed conv."""

from portbench import spans


def read(ctx):
    return spans.nonconv_ms(ctx.record)
