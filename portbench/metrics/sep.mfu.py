"""``sep.mfu`` (%): the separation's model FLOPs a Langevin step (both
sources' score nets: convolutions counted as direct ones and the flows'
matmuls, from shapes, by the configuration's plain reference on the
``meta`` device; a flow's score counts its forward and its input-gradient
backward) times the window's steps, over the window's wall-clock less the
tracer's own seconds in it, over the chip's peak in the traffic's compute
dtype (``peaks.json``: bf16 989 TFLOP/s; f32 495, TF32 dense). Nothing to
read on a card ``peaks.json`` does not list."""

from portbench.counts import peaks


def read(ctx):
    peak = peaks(ctx.device_name)
    if peak is None or ctx.steps == 0:
        return None
    seconds = ctx.window_s - ctx.instrument_s
    rate = ctx.step_flops * ctx.steps / seconds
    return 100.0 * rate / peak["flops"][ctx.cell.traffic["compute_dtype"]]
