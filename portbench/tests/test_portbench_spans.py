"""``portbench/spans.py`` and the readers of the program's spans on a
synthetic record and trace: the clock's two anchors and its check (anchors
that disagree read nothing), each reader's number, nothing read from a
program without spans, nor from a level whose captured events gave no
time, and the idle gaps under their innermost spans."""

import pytest

from audiosourcesep_tpu_torch.separation import graphs
from audiosourcesep_tpu_torch.utils.profiling import Span
from portbench import spans, spec
from portbench.harness import Context
from portbench.trace import Reading

HOST0 = 10 ** 12            # ns
TRACE0 = 5.0e6              # us: where HOST0 lies on the trace's clock
READERS = ("anneal.capture_python_s", "anneal.instantiate_s",
           "anneal.warmup_idle_s", "score.nonconv_ms", "score.backward_ms",
           "basis.update_ms")


def _us(ms):
    """Trace microseconds of host millisecond ``ms``."""
    return TRACE0 + ms * 1e3


def _add(record, name, level, phase, parent, t0, t1, device_ms=None):
    s = Span(len(record.spans), name, level, phase,
             None if parent is None else parent.index)
    s.start_ns, s.end_ns = HOST0 + int(t0 * 1e6), HOST0 + int(t1 * 1e6)
    s.device_ms = device_ms
    record.spans.append(s)
    return s


def _record(captured=True):
    """Level 0 untraced, level 1 traced as inside ``every_leaf`` (its
    spans in ms of host time; device ms on the warm-up's module spans,
    and on the capture's where ``captured``), level 2 untraced."""
    r = graphs.Record()
    for name, t0, t1 in (("anneal.warmup", -400, -300),
                         ("anneal.capture", -300, -250),
                         ("anneal.instantiate", -250, -240),
                         ("anneal.replays", -240, -20),
                         ("anneal.release", -20, 0)):
        _add(r, name, 0, "eager", None, t0, t1)
    r.traced.append(1)
    warm = _add(r, "anneal.warmup", 1, "warmup", None, 0, 100)
    _add(r, "conv.weights", 1, "warmup", warm, 10, 30, 1.0)
    sw = _add(r, "score", 1, "warmup", warm, 35, 95, 41.0)
    _add(r, "score.forward", 1, "warmup", sw, 38, 92, 36.0)
    cap = _add(r, "anneal.capture", 1, "capture", None, 100, 300)
    _add(r, "anneal.begin_capture", 1, "capture", cap, 100, 104)
    dev = (lambda ms: ms) if captured else (lambda ms: None)
    _add(r, "anneal.noise", 1, "capture", cap, 101, 102, dev(0.01))
    for first, (fwd, convs, back) in zip((110, 200), (
            (35.0, (10.0, 8.0), 4.0), (30.0, (12.0,), 6.0))):
        sc = _add(r, "score", 1, "capture", cap, first, first + 85,
                  dev(fwd + back + 1))
        f = _add(r, "score.forward", 1, "capture", sc, first + 1,
                 first + 60, dev(fwd))
        for i, ms in enumerate(convs):
            c = _add(r, "conv", 1, "capture", f, first + 2 + 10 * i,
                     first + 8 + 10 * i, dev(ms))
            if i == 0:      # a nested conv counts once, in its parent
                _add(r, "conv", 1, "capture", c, first + 3, first + 4,
                     dev(ms / 2))
        _add(r, "norm", 1, "capture", f, first + 40, first + 50, dev(5.0))
        _add(r, "score.backward", 1, "capture", sc, first + 61,
             first + 80, dev(back))
    _add(r, "basis.update", 1, "capture", cap, 291, 299, dev(0.5))
    _add(r, "anneal.instantiate", 1, "capture", None, 300, 320)
    rep = _add(r, "anneal.replays", 1, "eager", None, 320, 1000)
    _add(r, "anneal.first_replay", 1, "eager", rep, 320.2, 330)
    _add(r, "anneal.release", 1, "eager", None, 1000, 1010)
    for name, t0, t1 in (("anneal.warmup", 1010, 1100),
                         ("anneal.capture", 1100, 1200),
                         ("anneal.instantiate", 1200, 1240)):
        _add(r, name, 2, name.split(".")[1] if name != "anneal.instantiate"
             else "capture", None, t0, t1)
    return r


def _reading(third_edge_us=20.0):
    """Level 1 on the trace's clock: the card busy 50 of the warm-up's 100
    ms (10 to 40, 60 to 80), idle through the capture, busy in the
    replays; the instantiation's row ``third_edge_us`` off its span."""
    kernels = [("k", _us(10), _us(40)), ("k", _us(60), _us(80)),
               ("k", _us(322), _us(990))]
    host = [("sync", _us(-1), _us(-0.5)),
            ("capture_begin", _us(104) - 3.0, _us(104)),
            ("capture_end", _us(300) + 1.0, _us(301)),
            ("instantiate", _us(301), _us(320) + third_edge_us),
            ("replay", _us(320.3), _us(330))]
    return Reading((_us(-0.5), _us(990)), kernels, host, 2)


def _ctx(record, reading):
    cell = spec.cell("sep-ncsnv1-bf16-30f")
    return Context(cell, "NVIDIA H100 80GB HBM3", record, 40.0, 0.0, 300,
                   1.0, [], reading)


def test_clock_maps_from_two_anchors_and_checks_the_third():
    c = spans.clock(_record(), _reading())
    assert c is not None and c.error_us == pytest.approx(20.0, abs=1e-3)
    assert c.slope == pytest.approx(1.0)
    assert c.us(HOST0 + 500 * 10 ** 6) == pytest.approx(_us(500))


@pytest.mark.parametrize("off_us", [101.0, -150.0, 5e3])
def test_anchors_that_disagree_read_nothing(off_us):
    record, reading = _record(), _reading(off_us)
    assert spans.clock(record, reading) is None
    assert spans.idle_gaps(record, reading) is None
    assert spec.metric_reader("anneal.warmup_idle_s")(
        _ctx(record, reading)) is None


@pytest.mark.parametrize("name,want", [
    ("anneal.capture_python_s", (0.2 + 0.1) / 2),
    ("anneal.instantiate_s", (0.02 + 0.04) / 2),
    ("anneal.warmup_idle_s", 0.05),
    ("score.nonconv_ms", (35.0 - 10.0 - 8.0) + (30.0 - 12.0)),
    ("score.backward_ms", 4.0 + 6.0),
    ("basis.update_ms", 0.01 + 0.5)])
def test_reader_on_a_synthetic_record(name, want):
    got = spec.metric_reader(name)(_ctx(_record(), _reading()))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_from_a_program_without_spans(name):
    """A program older than its spans: a record with captures and levels
    alone, in a traced run or not."""
    class Old:
        captures, levels = [], []

    for reading in (None, _reading()):
        assert spec.metric_reader(name)(_ctx(Old(), reading)) is None
    assert spec.metric_reader(name)(_ctx(graphs.Record(), None)) is None


def test_no_captured_device_time_reads_nothing():
    """No time on the captured events: the device readers read nothing,
    and the warm-up step's spans, another workload, are not read in
    their place."""
    record = _record(captured=False)
    assert spans.device_spans(record) == []
    ctx = _ctx(record, _reading())
    for name in ("score.nonconv_ms", "score.backward_ms", "basis.update_ms"):
        assert spec.metric_reader(name)(ctx) is None


def test_nonconv_reads_nothing_where_a_forward_times_no_conv():
    """A flow's forward asks for no conv spans in the capture: its
    forward less nothing would read the convs as non-conv time."""
    record = _record()
    record.spans = [s for s in record.spans
                    if not (s.name == "conv" and s.phase == "capture")]
    assert spec.metric_reader("score.nonconv_ms")(
        _ctx(record, _reading())) is None


def test_a_gap_across_spans_sits_under_the_deepest_holding_most():
    """A gap from the warm-up's wait into the capture's begin: the
    deepest span that holds more than half of it."""
    record, reading = _record(), _reading()
    cap = next(s for s in record.spans if s.name == "anneal.begin_capture")
    cap.end_ns = HOST0 + 150 * 10 ** 6          # begin 100 to 150 ms
    reading = reading._replace(kernels=[
        ("k", _us(10), _us(40)), ("k", _us(60), _us(80)),
        ("k", _us(140), _us(141)), ("k", _us(322), _us(990))], host=[
        (n, _us(150) - 3.0, _us(150)) if n == "capture_begin" else
        (n, t0, t1) for n, t0, t1 in reading.host])
    gaps = spans.idle_gaps(record, reading)
    assert ("anneal.begin_capture (capture, level 1)",
            pytest.approx(0.06), pytest.approx(0.08)) in gaps


def test_idle_gaps_sit_under_the_innermost_span():
    gaps = spans.idle_gaps(_record(), _reading())
    assert [g[0] for g in gaps] == ["anneal.capture (capture, level 1)",
                                    "score.forward (warmup, level 1)",
                                    "anneal.warmup (warmup, level 1)"]
    for got, (seconds, at) in zip(gaps, ((0.242, 0.08), (0.02, 0.04),
                                         (0.0105, -0.0005))):
        assert got[1:] == (pytest.approx(seconds), pytest.approx(at))


def test_breakdown_of_the_traced_level():
    out = spans.breakdown(_record(), _reading())
    assert out["level"] == 1
    assert out["top_device_ms"] == pytest.approx(
        0.01 + 0.5 + (35 + 4 + 1) + (30 + 6 + 1))
    assert out["device_ms_self"]["score"] == pytest.approx(2.0)
    assert out["host_s_self"]["capture"]["anneal.instantiate"] == \
        pytest.approx(0.02)
    assert out["warmup_idle_s"] == pytest.approx(0.05)
    assert out["clock_error_us"] == pytest.approx(20.0, abs=1e-3)
