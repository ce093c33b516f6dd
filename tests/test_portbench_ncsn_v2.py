"""The benchmark's NCSN v2 configuration on the CPU: its plain reference
(portbench/reference/ncsn_v2.py) against the port's v2 RefineNetDilated,
what the reference loads, one step's count at the published widths, and
the readers of the cell's three per-layer metrics on synthetic records."""

import ast
import collections
import subprocess
import sys

import pytest
import torch

from audiosourcesep_tpu_torch import nn
from audiosourcesep_tpu_torch.models.ncsn import get_score_model, get_sigmas
from audiosourcesep_tpu_torch.separation import graphs
from audiosourcesep_tpu_torch.utils.profiling import Span
from portbench import spec, weights
from portbench.arch import ncsn_v2 as arch
from portbench.harness import Context
from portbench.reference import ncsn_v2
from portbench.reference.precision import Precision, stack

torch.set_num_threads(2)

CELL = "sep-ncsnv2-bf16-30f"
# gamma and alpha near 1, so that every norm's terms weigh in the scores
TINY = {"n_filters": 8, "data_shape": [16, 16, 1], "init": {"norm_mean": 1.0}}
SIGMAS = get_sigmas(1.0, 0.1, 4, "logarithmic")


def _port(seed):
    """The port's v2 at TINY's widths, on the reference's weights."""
    specs = ncsn_v2.param_specs(TINY)
    m = get_score_model("v2", TINY["data_shape"], 8, 4, sigmas=SIGMAS,
                        device="meta")
    state = m.state_dict()
    assert set(state) == {n for n, _, _ in specs}
    assert all(tuple(state[n].shape) == s for n, s, _ in specs)
    w = weights.make(specs, seed, "cpu")
    m = m.to_empty(device="cpu")
    m.load_state_dict(w)
    m.sigmas.copy_(torch.as_tensor(SIGMAS))
    return m.eval().requires_grad_(False), w


def test_v2_reference_equals_the_port():
    """Two sources' scores at 8 filters, 16x16 and 4 levels in float32,
    routed or not: within float32 rounding (1e-5 of the largest); a
    control in tf32, bf16 or fp8 measurably off."""
    (m0, w0), (m1, w1) = _port(11), _port(12)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 3, 16, 16, 1, generator=g)
    y = torch.tensor([0, 1, 3])
    params, sigmas = stack([w0, w1]), torch.as_tensor(SIGMAS)
    want = ncsn_v2.score(params, x, y, TINY, sigmas=sigmas)
    for routed in (False, True):
        nn.set_winograd(routed)
        try:
            with torch.no_grad():
                got = torch.stack([m0(x[0], y), m1(x[1], y)])
        finally:
            nn.set_winograd(False)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for mode, lo in (("tf32", 1e-5), ("bf16", 1e-4), ("fp8", 1e-3)):
        low = ncsn_v2.score(params, x, y, TINY, Precision(mode), sigmas)
        assert (low - want).abs().max() > lo * want.abs().max()


def test_v2_reference_loads_neither_jax_nor_the_port():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, portbench.reference.ncsn_v2, "
         "portbench.weights\nprint(sorted({m.split('.')[0] for m in "
         "sys.modules}))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        timeout=300)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "audiosourcesep_tpu",
                         "audiosourcesep_tpu_torch"}
    tree = ast.parse((spec.HERE / "reference" / "ncsn_v2.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.level or node.module in ("__future__", "typing")
        elif isinstance(node, ast.Import):
            assert {a.name.split(".")[0] for a in node.names} <= {"torch"}


def test_step_count_at_the_published_widths_is_the_hand_count():
    """One step of the cell (2 sources x 30 frames at 96x64, 128 filters):
    every conv of a v2 forward, by class (count, H, W, C_in, C_out, k,
    dilated), at 2 k^2 N H W C_in C_out FLOPs; the routable ones the
    undilated 3x3s."""
    cell = spec.cell(CELL)
    forward = [(1, 96, 64, 1, 128, 3, False),      # begin_conv
               (18, 96, 64, 128, 128, 3, False),   # res1, res2_1.conv1,
                                                   # refine4 at 96x64
               (1, 96, 64, 128, 256, 3, False),    # res2_1.conv2
               (1, 96, 64, 128, 256, 1, False),    # res2_1.shortcut
               (1, 96, 64, 128, 1, 3, False),      # end_conv
               (32, 48, 32, 256, 256, 3, False),   # res2_2, refine1-3
               (10, 48, 32, 256, 256, 3, True),    # res3, res4
               (2, 48, 32, 256, 128, 3, False),    # refine3.msf
               (9, 48, 32, 128, 128, 3, False)]    # refine3-4 at 48x32
    n, k_src = 30, 2
    hand = k_src * sum(c * 2 * k * k * n * h * w * ci * co
                       for c, h, w, ci, co, k, _ in forward)
    flops, routed = arch.step_count(cell.config, cell.traffic)
    assert flops == hand
    assert round(flops / 1e12, 3) == 7.12
    want = collections.Counter()
    for c, h, w, ci, co, k, dilated in forward:
        if k == 3 and not dilated:
            want[(n, h, w, ci, co)] += k_src * c
    assert collections.Counter(routed) == want
    assert sum(want.values()) == 2 * 64


def _span(record, name, level, phase, seconds=0.0, device_ms=None,
          parent=None):
    s = Span(len(record.spans), name, level, phase, parent)
    s.start_ns, s.end_ns = 10 ** 9, 10 ** 9 + int(seconds * 1e9)
    s.device_ms = device_ms
    record.spans.append(s)
    return s


def _ctx(record, device_name="NVIDIA H100 80GB HBM3", steps=800,
         window_s=40.0, instrument_s=8.0):
    return Context(spec.cell(CELL), device_name, record, window_s,
                   instrument_s, steps, 7.12e12, [], None)


def _read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_turnover_reads_the_mean_span_from_level_3():
    record = graphs.Record()
    for level, seconds in enumerate((1.5, 0.9, 0.4, 0.12, 0.10, 0.14)):
        _span(record, "anneal.turnover", level, "eager", seconds)
        _span(record, "anneal.replays", level, "eager", 0.2)
    assert _read("anneal.turnover_ms", _ctx(record)) == \
        pytest.approx(120.0, rel=1e-6)


def test_pool_reads_the_traced_levels_captured_pools():
    """Both forwards' captured pools in the traced level (level 1), as its
    last replay timed them; not the warm-up's, not another level's."""
    record = graphs.Record()
    record.traced.append(1)
    _span(record, "pool", 0, "capture", device_ms=9.0)
    _span(record, "pool", 1, "warmup", device_ms=7.0)
    for _ in range(2):
        f = _span(record, "score.forward", 1, "capture", device_ms=12.0)
        for ms in (0.5, 0.25):
            _span(record, "pool", 1, "capture", device_ms=ms,
                  parent=f.index)
        _span(record, "conv", 1, "capture", device_ms=4.0, parent=f.index)
    assert _read("score.pool_ms", _ctx(record)) == pytest.approx(1.5)


def test_mfu_reads_the_window_less_the_tracer_at_the_bf16_peak():
    ctx = _ctx(graphs.Record())
    want = 100.0 * 7.12e12 * 800 / (40.0 - 8.0) / 989e12
    assert _read("sep.ncsnv2.mfu", ctx) == pytest.approx(want)
    assert _read("sep.ncsnv2.mfu", _ctx(graphs.Record(),
                                        device_name="cpu")) is None


@pytest.mark.parametrize("name", ["anneal.turnover_ms", "score.pool_ms"])
def test_span_readers_read_nothing_without_their_spans(name):
    """A program without the spans (the parent's: no turnover span, a v2
    forward that times its convs alone) or with no level from 3 on reads
    None, and raises nothing."""
    class Old:                  # a record from before spans
        captures, levels = [], []

    record = graphs.Record()
    record.traced.append(1)
    for level in range(5):
        _span(record, "anneal.replays", level, "eager", 0.2)
    f = _span(record, "score.forward", 1, "capture", device_ms=12.0)
    _span(record, "conv", 1, "capture", device_ms=4.0, parent=f.index)
    early = graphs.Record()
    for level in range(3):
        _span(early, "anneal.turnover", level, "eager", 0.3)
    for rec in (record, Old(), graphs.Record(), early):
        assert _read(name, _ctx(rec)) is None
