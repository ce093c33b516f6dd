"""``score.backward_ms`` (ms): the card's milliseconds a Langevin step in
the ``score.backward`` spans of both sources (a flow's input gradient,
``FlowModel.score``'s ``torch.autograd.grad``), from the CUDA event pairs
the traced level (level 1) captured into its graph, as its last replay
ran them. Nothing to read where the program records no such spans."""

from portbench import spans


def read(ctx):
    return spans.device_ms(ctx.record, ("score.backward",))
