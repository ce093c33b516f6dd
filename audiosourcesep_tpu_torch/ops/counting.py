"""Launch counters of the port's hand-written kernels.

:data:`COUNTS` holds every count, as one nested dict of ints declared
here and nowhere else: ``ops.winograd``'s at the top level (a CUDA graph
replay's ``launch_count`` is its routed convs), each other op module's
under its own key. A wrapper counts a launch (or a layout copy) with one
call of :func:`add`, with only the counts it moves.

:func:`snapshot`, :func:`since` and :func:`add` are the arithmetic a CUDA
graph's owner (``separation.graphs``) needs: a launch made while a graph
captures runs nothing then, so the owner takes the capture's counts back
off and adds them again at every replay, and the counters hold what the
card ran. None of the three names a kernel. A new kernel module adds its
counts to the layout below, under its key.
"""

from __future__ import annotations

COUNTS = {
    # ops.winograd: launches in all, by kernel, by the bf16 kernel's
    # producer path (winograd.bf16_path) and by the f32 kernel's design
    # (winograd.f32_path)
    "launch_count": 0,
    "launch_counts": {"winograd_f23_fwd_f32": 0, "winograd_f23_fwd_bf16": 0},
    "bf16_path_counts": {"tma": 0, "plain": 0},
    "f32_path_counts": {"wide": 0, "thin_in": 0, "thin_out": 0},
    # ops.instnorm: norms the kernel ran, and inputs copied into
    # channels_last memory before it
    "instnorm": {"launch_count": 0, "layout_copies": 0},
    # ops.pool: pools the kernels ran, in all and by kind, and inputs
    # copied into channels_last memory before them
    "pool": {"launch_count": 0,
             "launch_counts": {"avg5": 0, "max5": 0, "avg2": 0},
             "layout_copies": 0},
    # ops.bias_relu_bn: launches of the Glow coupling nets' fused bias ->
    # ReLU -> frozen BN, in all and by kernel (the forward; the input
    # gradient by its gradient's layout), and inputs copied into
    # channels_last memory before them
    "bias_relu_bn": {"launch_count": 0,
                     "launch_counts": {"fwd": 0, "bwd_nhwc": 0,
                                       "bwd_nchw": 0},
                     "layout_copies": 0},
    # ops.attention: the Flow++ nets' attention calls, in all and by
    # (N, heads, T, d); a shape's key is made at its first call
    "attn": {"launch_count": 0, "shapes": {}},
}


def snapshot(counts: dict = COUNTS) -> dict:
    """A copy of ``counts`` (every counter), in its layout."""
    return {k: snapshot(n) if isinstance(n, dict) else n
            for k, n in counts.items()}


def since(before: dict, counts: dict = COUNTS) -> dict:
    """The counts since :func:`snapshot` gave ``before``, in its layout (a
    key made since counts from 0)."""
    return {k: since(before.get(k, {}), n) if isinstance(n, dict)
            else n - before.get(k, 0) for k, n in counts.items()}


def add(launches: dict, times: int = 1, into: dict = COUNTS) -> None:
    """Add ``times`` x ``launches`` to the counters ``into``. ``launches``
    has the counters' layout, or only some of its keys (a wrapper's one
    launch); a non-zero count at a key the layout lacks raises KeyError. A
    graph's replays add what its capture counted, and the capture, which
    ran nothing, takes it off (``times = -1``). Zero counts are passed
    over: a replay, most of whose counts are 0, adds in less host time."""
    for k, n in launches.items():
        if type(n) is dict:
            add(n, times, into[k])
        elif n:
            into[k] += times * n
