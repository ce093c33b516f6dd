"""The benchmark's Flow++ configuration on the CPU: its plain reference
(portbench/reference/flowpp.py) against the port's melspec Flow++, what
the reference loads, one step's count at the published widths, and the
readers of the cell's three per-layer metrics on synthetic records."""

import ast
import collections
import math
import subprocess
import sys

import pytest
import torch

from audiosourcesep_tpu_torch import nn
from audiosourcesep_tpu_torch.models import build_flowpp
from audiosourcesep_tpu_torch.separation import graphs
from audiosourcesep_tpu_torch.utils.profiling import Span
from portbench import attn_counts, spec, weights
from portbench.arch import flowpp as arch
from portbench.harness import Context
from portbench.reference import flowpp
from portbench.reference.precision import Precision, stack
from portbench.trace import Reading

torch.set_num_threads(2)

CELL = "sep-flowpp-f32-5f"
TINY = {"n_filters": 8, "n_blocks": 2, "n_components": 4, "heads": 4,
        "data_shape": [16, 16, 1], "data_range": [-100.0, 20.0],
        "init": {"conv_out_std": 0.05}}


def _port(seed):
    """The port's melspec Flow++ at TINY's widths, on the reference's
    weights."""
    specs = flowpp.param_specs(TINY)
    m = build_flowpp(TINY["data_shape"], n_components=4, n_blocks_flow=2,
                     filters=8, heads=4, data_type="melspec",
                     device="meta")
    state = m.state_dict()
    assert set(state) == {n for n, _, _ in specs}
    assert all(tuple(state[n].shape) == tuple(s) for n, s, _ in specs)
    w = weights.make(specs, seed, "cpu")
    m = m.to_empty(device="cpu")
    m.load_state_dict(w)
    return m.eval().requires_grad_(False), w


def _inputs():
    g = torch.Generator().manual_seed(0)
    return torch.rand(2, 3, 16, 16, 1, generator=g) * 120.0 - 100.0


def test_flowpp_reference_equals_the_port():
    """Two sources' log p and scores at 8 filters, 2 blocks, 4 components
    and 4 heads on 16x16 frames in float32, routed or not: the scores
    within 1e-5 of the largest, log p within 1e-5 of the largest up to
    its constant (the reference leaves out the log-determinants that do
    not depend on x: the rescaling's, ActNorm's, the 1x1 convs' and the
    prior's normaliser); a control in tf32 or bf16 measurably off."""
    (m0, w0), (m1, w1) = _port(11), _port(12)
    x = _inputs()
    params = stack([w0, w1])
    want_lp = flowpp.log_prob(params, x, TINY)
    want = flowpp.score(params, x, TINY)
    assert want.abs().max() > 0.1
    for routed in (False, True):
        nn.set_winograd(routed)
        try:
            with torch.no_grad():
                lp = torch.stack([m0.log_prob(x[0]), m1.log_prob(x[1])])
            got = torch.stack([m0.score(x[0]), m1.score(x[1])])
        finally:
            nn.set_winograd(False)
        const = (lp - want_lp).double()
        assert (const - const.mean()).abs().max() <= \
            1e-5 * want_lp.abs().max()
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for mode, lo in (("tf32", 1e-4), ("bf16", 1e-3)):
        low = flowpp.score(params, x, TINY, Precision(mode))
        assert (low - want).abs().max() > lo * want.abs().max()


def test_flowpp_reference_loads_neither_jax_nor_the_port():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, portbench.reference.flowpp, "
         "portbench.weights\nprint(sorted({m.split('.')[0] for m in "
         "sys.modules}))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "audiosourcesep_tpu",
                         "audiosourcesep_tpu_torch"}
    tree = ast.parse((spec.HERE / "reference" / "flowpp.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.level or node.module.split(".")[0] in (
                "__future__", "typing", "torch")
        elif isinstance(node, ast.Import):
            assert {a.name.split(".")[0] for a in node.names} <= {"torch",
                                                                  "math"}


def test_step_count_at_the_published_widths_is_the_hand_count():
    """One step of the cell (2 sources x 4 frames at 96x64, 96 filters, 10
    blocks, 4 heads, 32 components): each coupling net's convs (conv_in,
    10 conv1, conv_out), dense layers (10 x the gated conv's GLU, qkv and
    the attention's GLU) and attention products, and each layer's 1x1
    conv, at 2 k^2 N H W C_in C_out FLOPs a conv or dense layer and 4 N
    heads T^2 d an attention; the input gradient one product of the same
    size a conv or dense layer and four an attention."""
    cell = spec.cell(CELL)
    n, k_src, f, heads = 4, 2, 96, 4
    assert cell.traffic["frames"] == n
    # (couplings, H, W and C of the net's input, W and C of the flow's)
    stages = [(4, 96, 32, 1, 64, 1), (2, 48, 32, 2, 32, 4),
              (3, 48, 16, 4, 32, 4)]
    convs, dense, attn, inv = 0, 0, 0, 0
    routed = collections.Counter()
    calls = collections.Counter()
    for layers, h, w, c, w_flow, c_flow in stages:
        px = n * h * w
        out = c * (2 + 3 * 32)
        per = [(c, f), *[(2 * f, f)] * 10, (f, out)]
        convs += layers * sum(2 * 9 * px * ci * co for ci, co in per)
        dense += layers * 10 * 2 * px * (2 * f * 2 * f + f * 3 * f
                                         + f * 2 * f)
        attn += layers * 10 * 4 * n * heads * (h * w) ** 2 * (f // heads)
        inv += layers * 2 * n * h * w_flow * c_flow ** 2
        for ci, co in per:
            routed[(n, h, w, ci, co)] += k_src * layers
        calls[(n, heads, h * w, f // heads)] += k_src * layers * 10
    hand = k_src * (2 * (convs + dense + inv) + 3 * attn)
    flops, got_routed = arch.step_count(cell.config, cell.traffic)
    assert flops == hand
    assert round(flops / 1e12, 3) == 5.559
    assert round(3 * k_src * attn / flops, 2) == 0.73
    assert collections.Counter(got_routed) == routed
    assert sum(routed.values()) == 2 * 9 * 12
    assert collections.Counter(arch.attention_calls(
        cell.config, cell.traffic)) == calls
    assert sum(calls.values()) == 2 * 90


def test_reference_scores_keep_no_attention_weights_for_the_backward():
    """The reference's scores (all frames at once, its attention weights
    recomputed for the backward) equal the scores a frame at a time, and
    the autograd graph of its log p holds no ``[K, N, heads, T, T]``
    tensor."""
    cfg = dict(TINY, init={"conv_out_std": 0.05})
    x = _inputs()
    cache = {}
    whole = arch.reference_scores(cfg, {"sources": 2}, 5, 0, "cpu",
                                  Precision(), cache)(x)
    params, w1x1 = cache["flowpp"]
    assert cache["flowpp_level"] == 0
    one = torch.cat([flowpp.score(params, xc, cfg, None, w1x1)
                     for xc in x.split(1, dim=1)], dim=1)
    assert (whole - one).abs().max() <= 1e-6 * whole.abs().max()
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        flowpp.log_prob(params, x.requires_grad_(True), cfg, None, w1x1)
    t = 16 * 8
    assert saved and not [s for s in saved if s[-2:] == (t, t)
                          or s[-2:] == (t // 4, t // 4)]


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

H100 = "NVIDIA H100 80GB HBM3"


def _span(record, name, level, phase, seconds=0.0, device_ms=None,
          parent=None):
    s = Span(len(record.spans), name, level, phase, parent)
    s.start_ns, s.end_ns = 10 ** 9, 10 ** 9 + int(seconds * 1e9)
    s.device_ms = device_ms
    record.spans.append(s)
    return s


def _ctx(record, trace=None, device_name=H100, steps=100, window_s=40.0,
         instrument_s=6.0):
    return Context(spec.cell(CELL), device_name, record, window_s,
                   instrument_s, steps, 5.56e12, [], trace)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def _calls():
    cell = spec.cell(CELL)
    return arch.attention_calls(cell.config, cell.traffic)


def _capture(record, level, calls):
    counted = collections.Counter(calls)
    record.captures.append(graphs.Capture(
        level, 1.0, 2.0, {"launch_count": 216,
                          "attn": {"launch_count": len(calls),
                                   "shapes": dict(counted)}}))


def _trace(calls, steps, fwd_us=100.0, bwd_us=300.0, extra=()):
    kernels, t = [], 0.0
    for _ in range(steps):
        for _ in calls:
            kernels.append(("fmha_cutlassF_f32_aligned_64x64_rf_sm80", t,
                            t + fwd_us))
            t += fwd_us
        for _ in calls:
            kernels.append(("fmha_cutlassB_f32_aligned_64x64_k32_sm80", t,
                            t + bwd_us))
            t += bwd_us
    kernels += [(n, t, t + 10.0) for n in extra]
    return Reading((0.0, t + 10.0), kernels, [], 2)


def test_attn_ms_reads_the_traced_levels_captured_attention():
    """Both forwards' captured attention cores in the traced level (level
    1), as its last replay timed them; not the warm-up's, not another
    level's."""
    record = graphs.Record()
    record.traced.append(1)
    _span(record, "attn", 0, "capture", device_ms=9.0)
    _span(record, "attn", 1, "warmup", device_ms=7.0)
    for _ in range(2):
        f = _span(record, "score.forward", 1, "capture", device_ms=90.0)
        for ms in (0.5, 0.25):
            _span(record, "attn", 1, "capture", device_ms=ms,
                  parent=f.index)
        _span(record, "mixlog", 1, "capture", device_ms=4.0, parent=f.index)
    assert _read("score.attn_ms", _ctx(record)) == pytest.approx(1.5)


def test_attn_roofline_reads_the_least_time_over_the_kernels():
    """Three steps of kernels (the warm-up and two replays) against three
    steps' least time: the calls' FLOPs (12 N heads T^2 d each) at the
    float32 peak."""
    calls = _calls()
    record = graphs.Record()
    record.traced.append(1)
    _capture(record, 0, calls)
    _capture(record, 1, calls)
    tr = _trace(calls, 3, extra=("sm80_xmma_gemm_f32f32", "fmha_other"))
    peak = 495e12
    least = 3 * sum(max(attn_counts.attn_ops(*c) / peak,
                        attn_counts.attn_bytes(*c, "float32") / 3.35e12)
                    for c in calls)
    device_s = 3 * len(calls) * 400e-6
    got = _read("kernels.attn_roofline", _ctx(record, tr))
    assert got == pytest.approx(100.0 * least / device_s)
    assert 0.0 < got < 100.0
    # the first stage's call is bound by its operations
    big = (5, 4, 3072, 24)
    assert attn_counts.attn_ops(*big) == 12 * 5 * 4 * 3072 ** 2 * 24
    assert attn_counts.attn_ops(*big) / peak > \
        attn_counts.attn_bytes(*big, "float32") / 3.35e12


@pytest.mark.parametrize("broken", ["no_trace", "cpu", "no_counter",
                                    "no_names", "other_shapes",
                                    "partial_step", "unpaired",
                                    "no_kernels"])
def test_attn_roofline_reads_nothing_where_it_cannot_hold_its_counts(
        broken, monkeypatch):
    """Without a trace, on a card ``peaks.json`` lacks, without the
    program's attention counter or its attention kernels' names (the
    parent's program), with counts that are not the reference's, with
    kernels that are not a whole number of steps or whose forward and
    backward differ in number, or without attention kernels: None, and
    nothing raised."""
    calls = _calls()
    record = graphs.Record()
    record.traced.append(1)
    tr = _trace(calls, 3)
    device = H100
    if broken == "no_counter":
        record.captures.append(graphs.Capture(1, 1.0, 2.0,
                                              {"launch_count": 216}))
    else:
        _capture(record, 1, calls[1:] + [(5, 4, 64, 24)]
                 if broken == "other_shapes" else calls)
    if broken == "no_trace":
        tr = None
    elif broken == "no_names":
        monkeypatch.setitem(sys.modules,
                            "audiosourcesep_tpu_torch.ops.attention", None)
    elif broken == "cpu":
        device = "cpu"
    elif broken == "partial_step":
        tr = tr._replace(kernels=tr.kernels[1:])
    elif broken == "unpaired":
        tr = tr._replace(kernels=[k for k in tr.kernels
                                  if "cutlassB" not in k[0]] + tr.kernels[
            -len(calls) * 2:])
    elif broken == "no_kernels":
        tr = tr._replace(kernels=[])
    assert _read("kernels.attn_roofline",
                 _ctx(record, tr, device_name=device)) is None


def test_attn_roofline_reads_nothing_for_an_arch_without_attention():
    record = graphs.Record()
    ctx = _ctx(record, _trace([(5, 4, 64, 24)], 1))
    cell = ctx.cell._replace(config=spec.cell("sep-glow-f32-30f").config)
    assert _read("kernels.attn_roofline", ctx._replace(cell=cell)) is None


def test_flowpp_mfu_reads_the_window_less_the_tracer_at_the_f32_peak():
    """``sep.mfu`` in the Flow++ cell: its step's FLOPs over the window
    less the tracer, at the float32 peak; nothing on a card without
    peaks."""
    ctx = _ctx(graphs.Record())
    want = 100.0 * 5.56e12 * 100 / (40.0 - 6.0) / 495e12
    assert _read("sep.mfu", ctx) == pytest.approx(want)
    assert _read("sep.mfu", _ctx(graphs.Record(),
                                 device_name="cpu")) is None


def test_attn_ms_reads_nothing_without_its_spans():
    """A program without the span (the parent's Flow++ has no ``attn``
    leaf, nor a flowpp arch) reads None and raises nothing."""
    class Old:                  # a record from before spans
        captures, levels = [], []

    record = graphs.Record()
    record.traced.append(1)
    f = _span(record, "score.forward", 1, "capture", device_ms=90.0)
    _span(record, "score.backward", 1, "capture", device_ms=120.0,
          parent=f.index)
    for rec in (record, Old(), graphs.Record()):
        assert _read("score.attn_ms", _ctx(rec)) is None


def test_attention_least_time_counts_forward_and_gradient():
    """12 N heads T^2 d FLOPs (the forward's two products, the input
    gradient's four) and 12 tensors of N heads T d elements."""
    peak = {"flops": {"float32": 1e12}, "hbm_bytes_per_s": 1e9}
    call = (2, 4, 16, 8)
    ops = 12 * 2 * 4 * 16 ** 2 * 8
    assert attn_counts.attn_ops(*call) == ops
    assert attn_counts.attn_bytes(*call, "float32") == 4 * 12 * 2 * 4 * 16 * 8
    assert attn_counts.least_s([call, call], "float32", peak) == \
        pytest.approx(2 * max(ops / 1e12, 4 * 12 * 2 * 4 * 16 * 8 / 1e9))
    assert math.isclose(arch.attention_flops(call) * 3, ops)
