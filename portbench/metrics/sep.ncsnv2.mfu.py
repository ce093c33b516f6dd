"""``sep.ncsnv2.mfu`` (%): ``sep.mfu``'s share of the chip's peak for the
NCSN v2 cell: both sources' RefineNet forwards a Langevin step, counted as
direct convolutions by the v2 reference on the ``meta`` device
(``arch/ncsn_v2.step_count``), times the window's steps, over the window's
wall-clock less the tracer's own seconds, over the bf16 peak
(``peaks.json``). Nothing to read on a card ``peaks.json`` does not
list."""

from portbench import spec


def read(ctx):
    return spec.metric_reader("sep.mfu")(ctx)
