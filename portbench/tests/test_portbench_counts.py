"""The yardstick's arithmetic against hand-worked small cases: a conv's
operations, bytes and least time, a step's FLOPs and routable convs, and
the reduction of a trace to busy time, idle gaps and the metrics."""

import pytest
import torch

from portbench import counts, spec, trace
from portbench.harness import Context

PEAK = {"flops": {"bfloat16": 1000.0, "float32": 500.0},
        "hbm_bytes_per_s": 100.0}


def test_conv_ops_bytes_and_least_time():
    conv = (2, 4, 4, 3, 5)
    assert counts.conv_ops(*conv) == 2 * 2 * 4 * 4 * 3 * 5 == 960
    assert counts.conv_bytes(*conv, "bfloat16") == 2 * (2 * 16 * 8 + 135)
    assert counts.conv_bytes(*conv, "float32") == 4 * (2 * 16 * 8 + 135)
    assert counts.conv_least_s(conv, "bfloat16", PEAK) == \
        pytest.approx(782 / 100.0)                 # bytes bound it
    big = (1, 64, 64, 100, 100)
    assert counts.conv_least_s(big, "float32", PEAK) == \
        pytest.approx(2 * 4096 * 1e4 / 500.0)       # operations bound it
    assert counts.least_s([conv, big], "float32", PEAK) == pytest.approx(
        counts.conv_least_s(conv, "float32", PEAK)
        + counts.conv_least_s(big, "float32", PEAK))


def test_h100_peaks():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p["flops"] == {"bfloat16": 989e12, "float32": 495e12}
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert counts.peaks("cpu") is None


def _ncsn_convs(c, H, W):
    """RefineNetDilated v1's convs by hand: (H, W, C_in, C_out, k, d)."""
    h, w = H // 2, W // 2
    out = [(H, W, 1, c, 3, 1)] + [(H, W, c, c, 3, 1)] * 4
    out += [(H, W, c, c, 3, 1), (H, W, c, 2 * c, 3, 1), (H, W, c, 2 * c, 1, 1)]
    out += [(h, w, 2 * c, 2 * c, 3, 1)] * 2
    for d in (2, 4):
        out += [(h, w, 2 * c, 2 * c, 3, d)] * 5
    out += [(h, w, 2 * c, 2 * c, 3, 1)] * (8 + 14)
    out += [(h, w, 2 * c, 2 * c, 3, 1)] * 8 + [(h, w, 2 * c, c, 3, 1)] * 2 \
        + [(h, w, c, c, 3, 1)] * 4
    # refine4: the lower input's RCU and MSF conv run at its own size
    out += [(H, W, c, c, 3, 1)] * 13 + [(h, w, c, c, 3, 1)] * 5
    out += [(H, W, c, 1, 3, 1)]
    return out


def test_ncsn_step_count_by_hand():
    arch = spec.arch("ncsn_v1")
    cfg = {"n_filters": 4, "num_classes": 3, "data_shape": [8, 8, 1],
           "init": {"norm_embed_mean": 1.0}}
    traffic = {"frames": 3, "sources": 2}
    flops, routed = arch.step_count(cfg, traffic)
    hand = _ncsn_convs(4, 8, 8)
    assert len(hand) == 75
    assert flops == 2 * sum(2 * k * k * 3 * h * w * ci * co
                            for h, w, ci, co, k, d in hand)
    want = [(3, h, w, ci, co) for h, w, ci, co, k, d in hand
            if k == 3 and d == 1]
    assert len(want) == 64
    assert sorted(routed) == sorted(want * 2)


def test_glow_step_count_by_hand():
    arch = spec.arch("glow")
    cfg = {"L": 2, "K": 1, "n_filters": 4, "data_shape": [8, 8, 1],
           "data_range": [-100.0, 20.0],
           "init": {"coupling_conv3_std": 1e-3}}
    f = 4
    forward, want = 0, []
    for level, (hw, c) in enumerate(((4 * 4, 4), (2 * 2, 8))):
        forward += 2 * hw * (9 * (c // 2) * f + f * f + 9 * f * c + c * c)
        side = 4 >> level
        want += [(side, side, c // 2, f), (side, side, f, c)]
    for chunk, frames in ((0, 5), (2, 5)):
        flops, routed = arch.step_count(cfg, {"frames": frames,
                                              "sources": 2,
                                              "frame_chunk": chunk})
        assert flops == 2 * 2 * frames * forward
        sizes = [frames] if chunk == 0 else [2, 2, 1]
        assert sorted(routed) == sorted(
            [(n, *c) for n in sizes for c in want] * 2)


def _reading():
    """A window of: warm-up kernels [10, 30], capture [35, 38), capture
    end [38, 48], replays from 48 (kernels [50, 60] and [60, 70], one a
    Winograd kernel), span end 70 (microseconds)."""
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": n, "ts": t, "dur": d}
          for n, t, d in (("cudaDeviceSynchronize", -5, 5),
                          ("cudaStreamBeginCapture", 35, 1),
                          ("cudaLaunchKernel", 36, 1),
                          ("cudaStreamEndCapture", 38, 2),
                          ("cudaGraphInstantiateWithFlags", 40, 8),
                          ("cudaGraphLaunch", 48, 1),
                          ("cudaGraphLaunch", 49, 1))]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": t, "dur": d}
           for n, t, d in (("x", -9, 2), ("a", 10, 10), ("b", 15, 15),
                           ("winograd_f23_bf16_wgmma", 50, 10),
                           ("a", 60, 10))]
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1,
               "dur": 1})
    return trace.reduce_events(ev)


def test_trace_reduction():
    r = _reading()
    assert r.span == (0.0, 70.0) and r.replays == 2
    assert trace.union([(1, 3), (2, 5), (7, 8)], 0, 10) == [(1, 5), (7, 8)]
    assert trace.busy_us(r, 0, 70) == 20 + 20
    gaps = trace.idle_gaps(r)
    assert gaps[0] == (trace.PHASE_LABELS["instantiate"],
                       pytest.approx(20e-6))
    assert sorted(g[1] for g in gaps) == pytest.approx([10e-6, 20e-6])
    ops = dict(trace.device_ops(r))
    assert ops["a"] == pytest.approx(20e-6)
    assert trace.reduce_events([]) is None


class _Record:
    def __init__(self, captures, levels=()):
        self.captures, self.levels = captures, list(levels)


class _Capture:
    def __init__(self, level, warmup_s, capture_s, launches):
        self.level, self.warmup_s, self.capture_s = level, warmup_s, capture_s
        self.launches = {"launch_count": launches}


def _ctx(reading, routed, launches, dtype="bfloat16", T=100):
    cell = spec.Cell("c", 1, {"T": T}, {"compute_dtype": dtype}, {}, [], [])
    record = _Record([_Capture(0, 0.1, 0.2, launches),
                      _Capture(1, 0.3, 0.4, launches),
                      _Capture(2, 0.5, 0.6, launches)])
    return Context(cell, "NVIDIA H100 80GB HBM3", record, 10.0, 1.0, 200,
                   1e12, routed, reading)


def test_metric_readers_on_a_made_up_run():
    r = _reading()
    conv = (30, 96, 64, 192, 192)
    ctx = _ctx(r, [conv], 1)
    assert spec.metric_reader("anneal.level_overhead_s")(ctx) == \
        pytest.approx(0.9)
    assert spec.metric_reader("anneal.first_level_overhead_s")(ctx) == \
        pytest.approx(0.3)
    assert spec.metric_reader("sep.mfu")(ctx) == pytest.approx(
        100 * 1e12 * 200 / 9.0 / 989e12)
    roof = spec.metric_reader("kernels.winograd_roofline")(ctx)
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert roof == pytest.approx(
        100 * counts.conv_least_s(conv, "bfloat16", peak) / 10e-6)
    # counters that disagree with the routed convs leave it silent
    assert spec.metric_reader("kernels.winograd_roofline")(
        _ctx(r, [conv, conv], 1)) is None
    idle = spec.metric_reader("device.idle_share.sep")(ctx)
    pre, busy_pre, reps, busy_rep = 48.0, 20.0, 22.0, 20.0
    s = 100 / 2
    assert idle == pytest.approx(
        100 * (1 - (busy_pre + s * busy_rep) / (pre + s * reps)))
    # no kernel inside the replays: nothing to read, not a share of 100%
    quiet = r._replace(kernels=[k for k in r.kernels if k[1] < 48])
    assert spec.metric_reader("device.idle_share.sep")(
        _ctx(quiet, [conv], 1)) is None
    none = _ctx(None, [conv], 1)
    assert spec.metric_reader("device.idle_share.sep")(none) is None
    assert spec.metric_reader("kernels.winograd_roofline")(none) is None


def test_weights_repeat_and_follow_their_draws():
    from portbench import weights
    specs = [("k", (4, 3, 3, 3), ("glorot",)), ("b", (4,), ("zeros",)),
             ("n", (2, 5), ("normal", 1.0, 0.02)), ("g", (4,), ("ones",))]
    specs += [(f"c.{n}", s, ("plu", 4)) for n, s in (
        ("P", (4, 4)), ("L", (4, 4)), ("U", (4, 4)), ("sign_s", (4,)),
        ("log_s", (4,)))]
    a, b = weights.make(specs, 7, "cpu"), weights.make(specs, 7, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert list(a) == [n for n, _, _ in specs]
    assert a["k"].abs().max() <= weights.glorot_limit((4, 3, 3, 3))
    assert torch.equal(a["b"], torch.zeros(4))
    w = a["c.P"] @ (torch.tril(a["c.L"], -1) + torch.eye(4)) @ (
        torch.triu(a["c.U"], 1) + torch.diag(a["c.sign_s"]
                                             * a["c.log_s"].exp()))
    assert torch.allclose(w @ w.t(), torch.eye(4), atol=1e-5)
