"""The port's spans (audiosourcesep_tpu_torch/utils/profiling.py, recorded
in separation.graphs.Record) on the CPU: what a recording holds with
tracing off and on, how spans nest, how the anneal's spans tile each level
of the graphed loop (with test_torch_graphs.py's stand-in for the CUDA
capture), the score nets' module spans against the calls they mark, and
results that tracing leaves bit for bit as they were. The card's device
spans are tested in tests/test_torch_cuda.py."""

import collections
import contextlib
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from audiosourcesep_tpu_torch.models import build_glow
from audiosourcesep_tpu_torch.models.ncsn import RefineNetDilated, get_sigmas
from audiosourcesep_tpu_torch.models.ncsn.layers import \
    ConditionalInstanceNorm2dPlus
from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                 basis_separate_per_level,
                                                 glow_score_fn, graphs,
                                                 ncsn_score_fn)
from audiosourcesep_tpu_torch.utils import profiling
from test_torch_graphs import stand_in_graphs  # noqa: F401  (fixture)

torch.set_num_threads(2)

SHAPE = (16, 16, 1)
GLOW_SHAPE = (8, 8, 1)
ANNEAL = ("anneal.warmup", "anneal.capture", "anneal.instantiate",
          "anneal.replays", "anneal.release")


def _ncsn(L=2):
    return [RefineNetDilated(SHAPE, 4, num_classes=L).reset_parameters(
        torch.Generator().manual_seed(s)).eval().requires_grad_(False)
        for s in (1, 2)]


def _glow():
    mb = torch.from_numpy(np.random.default_rng(5).uniform(
        -100.0, 20.0, (4, *GLOW_SHAPE)).astype(np.float32))
    flows = []
    for s in (1, 2):
        m = build_glow(GLOW_SHAPE, L=2, K=1, n_filters=4, learntop=True,
                       data_type="melspec")
        m.init(mb, torch.Generator().manual_seed(s))
        with torch.no_grad():       # couplings that do work
            for name, p in m.named_parameters():
                if "conv3" in name:
                    p.add_(0.05 * torch.randn(
                        p.shape, generator=torch.Generator().manual_seed(s)))
        flows.append(m.eval().requires_grad_(False))
    return flows


def _separate(score, shape, L=2, T=2, graphed=False, seed=3):
    rng = np.random.default_rng(seed)
    lo, hi = (0.0, 1.0) if shape == SHAPE else (-80.0, 0.0)
    mixed = torch.from_numpy(rng.uniform(lo, hi, (3, *shape)).astype(
        np.float32))
    x0 = torch.from_numpy(rng.uniform(lo, hi, (2, 3, *shape)).astype(
        np.float32))
    sigmas = get_sigmas(1.0, 0.1, L) if L > 1 else np.asarray([0.5])
    return basis_separate_per_level(
        score, mixed, x0, sigmas, torch.Generator().manual_seed(seed),
        BasisConfig(T=T, delta=2e-3 if shape == SHAPE else 2e-2),
        graphed=graphed)[0]


def _traced(run):
    """``run()`` inside a recording, under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]), \
            graphs.recording() as record:
        out = run()
    return out, record


def test_tracing_off_records_only_the_anneal_spans():
    with graphs.recording() as record:
        _separate(ncsn_score_fn(_ncsn()), SHAPE)
    assert [(s.level, s.name, s.phase, s.parent) for s in record.spans] == [
        (0, "anneal.steps", "eager", None),
        (0, "anneal.turnover", "eager", None),
        (0, "anneal.release", "eager", None),
        (1, "anneal.steps", "eager", None),
        (1, "anneal.turnover", "eager", None),
        (1, "anneal.release", "eager", None)]
    assert record.traced == [] and not profiling.profiler_running()
    steps = [s for s in record.spans if s.name == "anneal.steps"]
    assert [lv.host_s for lv in record.levels] == [s.seconds for s in steps]


def test_spans_nest_with_parents_and_self_time():
    spans = profiling.Spans()
    with spans.block("outer", 0, "eager") as outer:
        time.sleep(0.002)
        with spans.block("a") as a:
            time.sleep(0.002)
        with profiling.tracing(spans, 0, "capture"):
            with profiling.span("b") as b:
                with profiling.span("c") as c:
                    time.sleep(0.002)
    assert profiling.span("b") is profiling._OFF          # off again
    assert (a.parent, b.parent, c.parent) == (outer.index, outer.index,
                                              b.index)
    assert (b.level, b.phase, a.phase) == (0, "capture", "eager")
    assert spans.children(outer) == [a, b] and spans.children(b) == [c]
    assert spans.traced == [0]
    for s in (outer, a, b, c):
        assert s.start_ns < s.end_ns and s.events is None      # no card
    assert spans.self_seconds(outer) == pytest.approx(
        outer.seconds - a.seconds - b.seconds, abs=1e-12)
    assert spans.self_seconds(outer) >= 0.002
    assert spans.self_seconds(b) == pytest.approx(b.seconds - c.seconds)
    b.device_ms, c.device_ms = 5.0, 3.5
    assert spans.self_device_ms(b) == 1.5
    assert spans.self_device_ms(a) is None


@pytest.mark.parametrize("mode", ["off", "traced", "every_leaf"])
def test_graphed_loop_spans_tile_each_level(stand_in_graphs, mode):
    """warm-up, capture, instantiate, replays, release: a level's anneal
    spans, one after another, at the top; their seconds are the
    captures' and the levels' records. Traced, the capture holds the
    module spans (an NCSN step's convs, no other leaf) and the warm-up
    none; inside ``every_leaf`` both hold every leaf kind."""
    run = lambda: _separate(ncsn_score_fn(_ncsn()), SHAPE, L=2,  # noqa
                            graphed=True)
    if mode == "off":
        with graphs.recording() as record:
            run()
    elif mode == "traced":
        record = _traced(run)[1]
    else:
        with profiling.every_leaf():
            record = _traced(run)[1]
    assert stand_in_graphs == [0, 1]
    for level in (0, 1):
        top = [s for s in record.spans if s.parent is None
               and s.level == level and s.name != "anneal.turnover"]
        assert [s.name for s in top] == list(ANNEAL)
        assert [s.phase for s in top] == ["warmup", "capture", "capture",
                                          "eager", "eager"]
        for before, after in zip(top, top[1:]):
            assert before.end_ns <= after.start_ns
        first = [s for s in record.spans if s.name == "anneal.first_replay"
                 and s.level == level]
        assert len(first) == 1 and first[0].parent == top[3].index
        begin = record.children(top[1])[0]
        assert begin.name == "anneal.begin_capture"
        assert begin.start_ns >= top[1].start_ns
        cap, steps = record.captures[level], record.levels[level]
        assert cap.level == steps.level == level
        assert cap.warmup_s == top[0].seconds
        assert cap.capture_s == top[1].seconds + top[2].seconds
        assert steps.host_s == top[3].seconds
    assert record.warmup_s == sum(s.seconds for s in record.spans
                                  if s.name == "anneal.warmup")
    assert record.capture_s == pytest.approx(sum(
        s.seconds for s in record.spans
        if s.name in ("anneal.capture", "anneal.instantiate")))
    modules = [s for s in record.spans if not s.name.startswith("anneal.")
               or s.name == "anneal.noise"]
    assert record.traced == ([] if mode == "off" else [0, 1])
    kinds = {phase: collections.Counter(s.name for s in modules
                                        if s.phase == phase)
             for phase in ("warmup", "capture")}
    if mode == "off":
        assert modules == []
    elif mode == "traced":
        assert kinds["warmup"] == {}
        assert set(kinds["capture"]) == {"anneal.noise", "score",
                                         "score.forward", "basis.update",
                                         "conv"}
        assert kinds["capture"]["score.forward"] == \
            kinds["capture"]["score"]
    else:
        for phase in ("warmup", "capture"):
            assert {"conv", "norm", "act", "pool"} <= set(kinds[phase])
        # the stand-in's T = 2 replays run the captured Python again
        assert 2 * kinds["warmup"]["conv"] == kinds["capture"]["conv"]
    for s in modules:       # the module spans sit in their phase's span
        phase = s.phase
        while s.parent is not None:
            s = record.spans[s.parent]
        # (and in the replays: the stand-in's run the captured Python)
        assert s.name in {"warmup": ("anneal.warmup",),
                          "capture": ("anneal.capture",
                                      "anneal.replays")}[phase]


def _count_calls(monkeypatch):
    """Calls of the ops that each kind of leaf span wraps once."""
    calls = collections.Counter()

    def counting(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped

    for kind, name in (("conv", "conv2d"), ("act", "elu"),
                       ("pool", "avg_pool2d"), ("resize", "interpolate")):
        monkeypatch.setattr(F, name, counting(kind, getattr(F, name)))
    monkeypatch.setattr(ConditionalInstanceNorm2dPlus, "__call__", counting(
        "norm", ConditionalInstanceNorm2dPlus.__call__))
    return calls


@pytest.mark.parametrize("kind", ["conv", "norm", "act", "pool", "resize"])
def test_ncsn_forward_spans_count_the_calls(monkeypatch, kind):
    """One NCSN v1 step under a CPU profiler (routing off: every conv is
    one ``F.conv2d``): as many leaf spans of each kind as the two
    forwards make calls, each inside its source's ``score.forward``,
    inside that source's ``score``."""
    models = _ncsn(L=1)
    calls = _count_calls(monkeypatch)
    _, record = _traced(lambda: _separate(ncsn_score_fn(models), SHAPE, L=1,
                                          T=1))
    names = collections.Counter(s.name for s in record.spans)
    assert calls[kind] > 0 and names[kind] == calls[kind]
    assert names["score"] == names["score.forward"] == 2
    for s in record.spans:
        if s.name == kind:
            up = record.spans[s.parent]
            while up.name != "score.forward":
                assert up.name in ("conv", "norm", "act", "pool", "resize")
                up = record.spans[up.parent]
            assert record.spans[up.parent].name == "score"
            assert s.phase == "eager" and s.level == 0


@pytest.mark.parametrize("chunk", [None, 2])
def test_glow_score_spans_a_forward_and_backward_per_chunk(chunk):
    """A Glow score: for each source one ``score``, and in it one
    ``score.forward`` and one ``score.backward`` a chunk of frames; the
    flows' convs and norms inside the forwards, the coupling nets' relus
    fused into their norms (two a coupling, beside its actnorm)."""
    _, record = _traced(lambda: _separate(
        glow_score_fn([_glow()], frame_chunk=chunk), GLOW_SHAPE, L=1,
        T=2))
    chunks = 2 if chunk else 1
    scores = [s for s in record.spans if s.name == "score"]
    assert len(scores) == 2
    for s in scores:
        kids = [c.name for c in record.children(s)]
        assert kids == ["score.forward", "score.backward"] * chunks
        for f in record.children(s)[::2]:
            inside = collections.Counter(
                c.name for c in record.spans if c.parent == f.index)
            assert inside["conv"] > 0 and inside["norm"] > 0
    kinds = collections.Counter(s.name for s in record.spans)
    assert kinds["norm"] == 2 * chunks * 2 * 3 and kinds["act"] == 0


@pytest.mark.parametrize("case", ["ncsn_eager", "ncsn_graphed",
                                  "ncsn_graphed_every_leaf", "glow_eager"])
def test_tracing_changes_no_result(stand_in_graphs, case):
    """An anneal is bit for bit the same with its spans recorded or not."""
    if case.startswith("ncsn"):
        models = _ncsn()
        run = lambda: _separate(ncsn_score_fn(models), SHAPE,  # noqa
                                graphed="graphed" in case)
    else:
        flows = _glow()
        run = lambda: _separate(glow_score_fn([flows], 2),  # noqa
                                GLOW_SHAPE, L=1)
    with graphs.recording() as off:
        plain = run()
    with profiling.every_leaf() if case.endswith("every_leaf") \
            else contextlib.nullcontext():
        traced, on = _traced(run)
    assert not off.traced and on.traced
    assert len(on.spans) > len(off.spans)
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("every_leaf", [False, True])
def test_a_capture_spans_the_leaves_its_spans_ask_for(monkeypatch,
                                                      every_leaf):
    """Captured event pairs cost every replay and captured spans the
    capture's time: a captured step spans its outer blocks and, of the
    leaves, only the kinds a span asks for (an NCSN forward's convs; a
    flow's forward asks for none); a leaf it does not span makes no
    span at all. Inside ``every_leaf``, every leaf. Warm-up spans record
    eager events, captured ones external events. (Stand-in events: the
    CPU has none.)"""
    class Event:
        def __init__(self, enable_timing=False, external=False):
            self.external = external

        def record(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    spans = profiling.Spans()
    with profiling.every_leaf() if every_leaf else contextlib.nullcontext():
        leaves = profiling.graphed_leaves()
    assert leaves == (profiling.LEAVES if every_leaf else frozenset())
    for phase in ("warmup", "capture"):
        with profiling.tracing(spans, 1, phase, "cuda", leaves):
            with profiling.span("anneal.noise"):
                pass
            for asks in (("conv",), ()):
                with profiling.span("score"), \
                        profiling.span("score.forward", leaves=asks):
                    for _ in range(3):
                        with profiling.span("conv"), \
                                profiling.span("norm"):
                            pass
                with profiling.span("conv"):      # outside the forward
                    pass
            with profiling.span("basis.update"):
                pass
    made = collections.Counter((s.phase, s.name) for s in spans.spans)
    for phase in ("warmup", "capture"):
        assert made[(phase, "conv")] == (8 if every_leaf else 3)
        assert made[(phase, "norm")] == (6 if every_leaf else 0)
        for name in ("score", "score.forward"):
            assert made[(phase, name)] == 2
        for name in ("anneal.noise", "basis.update"):
            assert made[(phase, name)] == 1
    assert all(s.events is not None for s in spans.spans)
    assert all(s.events[0].external == (s.phase == "capture")
               for s in spans.spans)
    assert spans._leaves == frozenset()             # restored


def _ncsn_v2(L=2):
    sigmas = get_sigmas(1.0, 0.1, L)
    return [RefineNetDilated(SHAPE, 4, sigmas=sigmas).reset_parameters(
        torch.Generator().manual_seed(s)).eval().requires_grad_(False)
        for s in (1, 2)]


@pytest.mark.parametrize("graphed", [False, True])
def test_one_turnover_span_a_level_between_the_levels_steps(
        stand_in_graphs, graphed):
    """``anneal.turnover``: one a level, in order, at the top, on the host
    clock; level 0's from the anneal's entry, each later one from the end
    of the last level's steps to the start of this level's, holding the
    last level's release and the caller's callback and, graphed, this
    level's warm-up, capture and instantiation."""
    L = 3
    rng = np.random.default_rng(3)
    mixed = torch.from_numpy(rng.uniform(size=(3, *SHAPE)).astype(
        np.float32))
    x0 = torch.from_numpy(rng.uniform(size=(2, 3, *SHAPE)).astype(
        np.float32))
    called = []
    with graphs.recording() as record:
        entry = time.perf_counter_ns()
        basis_separate_per_level(
            ncsn_score_fn(_ncsn(L)), mixed, x0, get_sigmas(1.0, 0.1, L),
            torch.Generator().manual_seed(3), BasisConfig(T=2, delta=2e-3),
            callback=lambda level, x: called.append(time.perf_counter_ns()),
            graphed=graphed)
    steps = [s for s in record.spans if s.name == ("anneal.replays"
                                                   if graphed else
                                                   "anneal.steps")]
    turns = [s for s in record.spans if s.name == "anneal.turnover"]
    assert [s.level for s in turns] == [s.level for s in steps] == \
        list(range(L))
    assert all(s.parent is None and s.phase == "eager" and s.events is None
               for s in turns)
    assert entry <= turns[0].start_ns
    for level, (turn, step) in enumerate(zip(turns, steps)):
        assert turn.start_ns < turn.end_ns == step.start_ns
        if level:
            assert turn.start_ns == steps[level - 1].end_ns
            assert turn.start_ns < called[level - 1] < turn.end_ns
    inside = {"anneal.release": 1}
    if graphed:
        inside.update({"anneal.warmup": 0, "anneal.capture": 0,
                       "anneal.instantiate": 0})
    for s in record.spans:
        if s.name in inside and s.level + inside[s.name] < L:
            turn = turns[s.level + inside[s.name]]
            assert turn.start_ns <= s.start_ns <= s.end_ns <= turn.end_ns


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_a_traced_capture_times_v1_convs_and_v2_convs_and_pools(
        stand_in_graphs, version):
    """A traced graphed level's capture spans, inside each RefineNet
    forward, its convs (75 a forward: v1's 150 event pairs a step of two
    sources) and, in v2 alone, its pools (the CRPs' 8 max pools and the
    2 average pools of ``res2_1``); no other leaf."""
    models = _ncsn(L=1) if version == "v1" else _ncsn_v2(L=1)
    _, record = _traced(lambda: _separate(ncsn_score_fn(models), SHAPE,
                                          L=1, T=1, graphed=True))
    forwards = [s for s in record.spans if s.name == "score.forward"
                and s.phase == "capture"]
    assert len(forwards) == 2
    want = {"conv": 75} if version == "v1" else {"conv": 75, "pool": 10}
    for f in forwards:
        assert collections.Counter(
            c.name for c in record.children(f)) == want
    assert models[0].traced_leaves == tuple(want)
