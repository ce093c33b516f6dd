"""The traced span of a ``--trace 1`` run and what the per-layer metrics
read from it.

:class:`Tracer` starts ``torch.profiler`` on the card's rows alone (CUDA:
kernels, copies, and the CUDA runtime calls the host made; no CPU op rows,
whose cost would land in the traced level's warm-up and capture), marks
the span's start with a ``cudaDeviceSynchronize``, and stops after
``replays`` replays of a CUDA graph (it wraps ``torch.cuda.CUDAGraph
.replay`` to count them, for the span's length only). The harness starts
it between levels 0 and 1, so the span holds level 1's eager warm-up
step, its capture and instantiation, and a few replays. Where the program
captures no graph, it stops after that level.

The host rows that cut the span into the anneal's phases are the runtime
calls: ``cudaStreamBeginCapture``, ``cudaStreamEndCapture``,
``cudaGraphInstantiate*`` and ``cudaGraphLaunch``. The trace is written
under ``TMPDIR``, read and deleted.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ROWS = {"cudaDeviceSynchronize": "sync",
             "cudaStreamBeginCapture": "capture_begin",
             "cudaStreamEndCapture": "capture_end",
             "cudaGraphInstantiate": "instantiate",
             "cudaGraphInstantiateWithFlags": "instantiate",
             "cudaGraphLaunch": "replay"}
PHASE_LABELS = {"warmup": "eager warm-up step",
                "capture": "capture (Python under stream capture)",
                "instantiate": "capture end and cudaGraphInstantiate",
                "replays": "graph replays"}

Interval = Tuple[float, float]          # microseconds


class Reading(NamedTuple):
    """A trace reduced to what the metrics read (times in microseconds):
    device intervals by name, and the host rows of ``HOST_ROWS`` by their
    short names."""
    span: Interval
    kernels: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    replays: int


class Tracer:
    def __init__(self, replays: int):
        self.replays = replays
        self.count = 0
        self.start_s = 0.0
        self.stop_s = 0.0
        self.prof = None
        self._replay = None

    def start(self) -> None:
        """Start the profiler and mark the span's start; its seconds are
        the instrumentation's own (``start_s``)."""
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._replay = torch.cuda.CUDAGraph.replay
        tracer, original = self, self._replay

        def replay(g, *a, **k):
            out = original(g, *a, **k)
            tracer.count += 1
            if tracer.count >= tracer.replays:
                tracer.stop()
            return out

        torch.cuda.CUDAGraph.replay = replay
        torch.cuda.synchronize()
        self.start_s = time.perf_counter() - t0

    @property
    def running(self) -> bool:
        return self._replay is not None

    def stop(self) -> None:
        """Wait for the card, put ``replay`` back, stop the profiler; its
        seconds are the instrumentation's own (``stop_s``)."""
        if not self.running:
            return
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.CUDAGraph.replay = self._replay
        self._replay = None
        self.prof.stop()
        self.stop_s = time.perf_counter() - t0

    def read(self) -> Optional[Reading]:
        self.stop()
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_events(events)


def reduce_events(events) -> Optional[Reading]:
    """The chrome trace's complete events reduced to device intervals and
    the host rows that mark the phases; the span runs from the first
    ``cudaDeviceSynchronize`` (the span's mark; without one, the first
    row) to the last device interval's end."""
    kernels, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        if cat in DEVICE_CATS:
            kernels.append((name, t0, t1))
        elif name in HOST_ROWS:
            host.append((HOST_ROWS[name], t0, t1))
    host.sort(key=lambda h: h[1])
    if not kernels:
        return None
    syncs = [t1 for n, _, t1 in host if n == "sync"]
    start = syncs[0] if syncs else min(t0 for _, t0, _ in kernels + host)
    kernels = sorted(k for k in kernels if k[2] > start)
    if not kernels:
        return None
    end = max(t1 for _, _, t1 in kernels)
    replays = sum(1 for n, _, _ in host if n == "replay")
    return Reading((start, end), kernels, host, replays)


def union(intervals: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_us(reading: Reading, lo: float, hi: float) -> float:
    return sum(b - a for a, b in union(
        [(t0, t1) for _, t0, t1 in reading.kernels], lo, hi))


def first(reading: Reading, name: str) -> Optional[Tuple[float, float]]:
    for n, t0, t1 in reading.host:
        if n == name:
            return t0, t1
    return None


def phases(reading: Reading) -> List[Tuple[str, float, float]]:
    """The span cut into the anneal's phases (see ``PHASE_LABELS``) by the
    runtime rows: warm-up until the capture begins, the capture until it
    ends, its end and the instantiation, then the replays."""
    lo, hi = reading.span
    begin = first(reading, "capture_begin")
    end = first(reading, "capture_end")
    inst = first(reading, "instantiate")
    rep = first(reading, "replay")
    out = []
    if begin:
        out.append(("warmup", lo, begin[0]))
        if end:
            out.append(("capture", begin[0], end[0]))
            done = max(end[1], inst[1] if inst else end[1])
            out.append(("instantiate", end[0], done))
    if rep:
        out.append(("replays", rep[0], hi))
    return out


def idle_gaps(reading: Reading, top: int = 10):
    """The longest idle gaps of the device in the span (seconds), each
    named by the phase the host was in over most of it."""
    lo, hi = reading.span
    busy = union([(t0, t1) for _, t0, t1 in reading.kernels], lo, hi)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    cuts = phases(reading)
    out = []
    for a, b in gaps:
        best, label = 0.0, "other"
        for name, p0, p1 in cuts:
            overlap = min(b, p1) - max(a, p0)
            if overlap > best:
                best, label = overlap, PHASE_LABELS[name]
        out.append((label, (b - a) * 1e-6))
    out.sort(key=lambda g: -g[1])
    return out[:top]


def device_ops(reading: Reading, top: int = 10):
    """The device operations that took most time in the span (seconds),
    by name."""
    total = {}
    for name, t0, t1 in reading.kernels:
        total[name[:160]] = total.get(name[:160], 0.0) + (t1 - t0) * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])[:top]
