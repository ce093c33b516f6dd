"""Profiling on ``torch.profiler`` (port of ``trace`` in
``audiosourcesep_tpu/utils/profiling.py``) and the port's spans.

A span is a named block of host time: its level, its phase (``warmup``,
``capture`` or ``eager``), the span it sits in, and its start and end on
``time.perf_counter_ns``. :class:`Spans` holds them in memory; the port's
one recorder, ``separation.graphs.Record``, is one, and the anneal opens
its own spans in it (``anneal.warmup``, ``anneal.capture``, ...) whenever a
``graphs.recording()`` block is open.

Module spans (:func:`span`, :func:`spanned`) mark blocks of the score nets
and of the BASIS step: ``score``, ``score.forward``, ``score.backward``,
``basis.update`` and ``anneal.noise``, and the leaves (``LEAVES``):
``conv``, ``conv.weights``, ``norm``, ``act``, ``pool``, ``resize``, and
Flow++'s ``attn`` (an attention core) and ``mixlog`` (a coupling's
mixture CDF and density). They
are recorded only inside :func:`tracing`, which the anneal enters for a
level whose warm-up and capture (or, eager, whose first step) start while
a ``torch.profiler`` profile runs (:func:`profiler_running`): :func:`trace`
is how an operator turns them on. Off, a module span costs one check. On a
CUDA device a module span also records a pair of timing events
(``external`` under a stream capture, so that the graph holds event
nodes); once the card has run them, :meth:`Spans.read_device` reads each
pair's milliseconds: inside a graph, those of its last replay.

A leaf is spanned only where the block allows its kind: :func:`tracing`'s
``leaves``, widened inside a span that names ``leaves`` of its own. Each
captured pair is two event nodes, 10-15 microseconds of every replay on an
H100, and every span the capture's Python makes lands in the traced
level's capture time. So the anneal traces a graphed level's capture with
no leaves, and not its warm-up step: the captured step holds the outer
spans, and the convs of a RefineNet forward, which asks for them (150 a
step of two sources), as a Flow++ prior asks for its ``attn`` and
``mixlog`` (198 a step). An eager level's first step spans every leaf; inside
an :func:`every_leaf` block, a diagnostic, so do a graphed level's warm-up
and capture.

The JAX module's TPU workarounds are not ported: ``fence`` (a completion
fence for a backend whose ``block_until_ready`` could return early; here
``torch.cuda.synchronize`` is exact), ``steady_state`` (a harness around
remote compiles) and ``enable_compilation_cache`` (XLA's cache).
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the CPU and, where there is
    one, the CUDA device into ``log_dir`` (a ``*.pt.trace.json`` that
    TensorBoard and chrome://tracing read) when it is set; no-op
    otherwise. An anneal level that starts inside records its module
    spans. Yields the profiler (or ``None``)."""
    if not log_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=(
            torch.profiler.tensorboard_trace_handler(log_dir))) as prof:
        yield prof


def profiler_running() -> bool:
    """Whether a ``torch.profiler`` profile runs in this thread."""
    return torch._C._autograd._profiler_enabled()


LEAVES = frozenset(("conv", "conv.weights", "norm", "act", "pool",
                    "resize", "attn", "mixlog"))

_EVERY_LEAF: contextvars.ContextVar = contextvars.ContextVar(
    "every_leaf", default=False)


@contextlib.contextmanager
def every_leaf():
    """Anneal levels traced in this block span every leaf kind in their
    warm-up step and their capture too, each with an event pair: a
    diagnostic, whose captured pairs slow each replay (NCSN's ~370 a step
    +3%, Glow's ~2,200 +5% on an H100) and whose spans lengthen the
    capture."""
    token = _EVERY_LEAF.set(True)
    try:
        yield
    finally:
        _EVERY_LEAF.reset(token)


def graphed_leaves() -> frozenset:
    """The leaf kinds a graphed level's warm-up and capture span: every
    kind inside :func:`every_leaf`, else none."""
    return LEAVES if _EVERY_LEAF.get() else frozenset()


class Span:
    """One block: ``name``, ``level``, ``phase``, ``parent`` (the index of
    the span it sits in, or None), ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``), and ``device_ms``, the card's time between
    its events where it recorded and read them."""

    __slots__ = ("index", "name", "level", "phase", "parent", "start_ns",
                 "end_ns", "device_ms", "events")

    def __init__(self, index, name, level, phase, parent):
        self.index, self.name, self.level = index, name, level
        self.phase, self.parent = phase, parent
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None
        self.events = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Block:
    """A span as a ``with`` block; ``leaves`` widens the leaf kinds
    spanned inside it."""

    __slots__ = ("record", "name", "level", "phase", "timed", "leaves",
                 "span", "outer")

    def __init__(self, record, name, level, phase, timed, leaves=()):
        self.record, self.name, self.timed = record, name, timed
        self.level, self.phase, self.leaves = level, phase, leaves

    def __enter__(self) -> Span:
        self.span = self.record.open(self.name, self.level, self.phase,
                                     self.timed)
        if self.leaves:
            self.outer = self.record._leaves
            self.record._leaves = self.outer | frozenset(self.leaves)
        return self.span

    def __exit__(self, *exc) -> None:
        if self.leaves:
            self.record._leaves = self.outer
        self.record.close(self.span)


class Spans:
    """Spans in the order they opened (``spans``), nested; ``traced`` the
    levels whose module spans were on."""

    def __init__(self):
        self.spans: List[Span] = []
        self.traced: List[int] = []
        self._stack: List[int] = []
        self._unread = 0
        self._level = None
        self._phase = "eager"
        self._device = None          # a CUDA device while tracing there
        self._leaves = frozenset()   # the leaf kinds spanned now
        self._children = None

    def open(self, name: str, level=None, phase=None,
             timed: bool = False) -> Span:
        """Open a span inside the innermost open one; ``level`` and
        ``phase`` default to those :func:`tracing` set. ``timed`` records
        the span's first event where tracing runs on a CUDA device."""
        s = Span(len(self.spans), name,
                 self._level if level is None else level,
                 phase or self._phase,
                 self._stack[-1] if self._stack else None)
        if timed and self._device is not None:
            s.events = tuple(torch.cuda.Event(
                enable_timing=True, external=self._phase == "capture")
                for _ in "ab")
            s.events[0].record()
        self._stack.append(s.index)
        self.spans.append(s)
        s.start_ns = time.perf_counter_ns()
        return s

    def close(self, s: Span) -> None:
        s.end_ns = time.perf_counter_ns()
        if s.events is not None:
            s.events[1].record()
        self._stack.pop()

    def add(self, name: str, level, phase: str, start_ns: int,
            end_ns: int) -> Span:
        """A span of given stamps, closed, at the top level: one that no
        open span holds (the anneal's turnover between two levels'
        steps)."""
        s = Span(len(self.spans), name, level, phase, None)
        s.start_ns, s.end_ns = start_ns, end_ns
        self.spans.append(s)
        return s

    def block(self, name: str, level=None, phase=None) -> _Block:
        """:meth:`open` and :meth:`close` as a ``with`` block (host time
        only)."""
        return _Block(self, name, level, phase, False)

    def read_device(self) -> None:
        """``device_ms`` of every span recorded since the last call whose
        events the card ran (call it after a wait for the card); a pair
        the card gives no time for raises. The events are freed."""
        for s in self.spans[self._unread:]:
            if s.events is not None:
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        self._unread = len(self.spans)

    def children(self, s: Span) -> List[Span]:
        if self._children is None or self._children[0] != len(self.spans):
            kids: Dict[int, List[Span]] = {}
            for c in self.spans:
                if c.parent is not None:
                    kids.setdefault(c.parent, []).append(c)
            self._children = (len(self.spans), kids)
        return self._children[1].get(s.index, [])

    def self_seconds(self, s: Span) -> float:
        """The span's seconds less the part its children cover."""
        return s.seconds - sum(c.seconds for c in self.children(s))

    def self_device_ms(self, s: Span) -> Optional[float]:
        """The span's device ms less its children's, or None unread."""
        if s.device_ms is None:
            return None
        return s.device_ms - sum(c.device_ms for c in self.children(s)
                                 if c.device_ms is not None)


_TRACED: Optional[Spans] = None
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def tracing(record: Optional[Spans], level: int, phase: str, device=None,
            leaves=frozenset()):
    """Module spans go to ``record`` in this block, as ``level`` and
    ``phase``, with events where ``device`` is a CUDA device; of the
    leaves (``LEAVES``), only the kinds in ``leaves`` and those a span
    inside asks for. ``None`` leaves them as they are (off, outside any
    traced phase)."""
    global _TRACED
    if record is None:
        yield
        return
    before = (_TRACED, record._level, record._phase, record._device,
              record._leaves)
    if level not in record.traced:
        record.traced.append(level)
    record._level, record._phase = level, phase
    record._leaves = frozenset(leaves)
    record._device = (device if device is not None
                      and torch.device(device).type == "cuda" else None)
    _TRACED = record
    try:
        yield
    finally:
        _TRACED = before[0]
        (record._level, record._phase, record._device,
         record._leaves) = before[1:]


def _block(name: str, leaves):
    """The traced block of a module span, or None where it is not
    recorded."""
    record = _TRACED
    if record is None or (name in LEAVES and name not in record._leaves):
        return None
    return _Block(record, name, None, None, True, leaves)


def span(name: str, leaves=()):
    """A module span as a ``with`` block: recorded inside :func:`tracing`
    (a leaf where its kind is allowed), a shared no-op otherwise.
    ``leaves`` are leaf kinds spanned inside it besides those allowed."""
    return _block(name, leaves) or _OFF


def spanned(name: str, leaves=()):
    """Decorator: each call of the function is a module span ``name``
    (:func:`span`)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            block = _block(name, leaves)
            if block is None:
                return fn(*args, **kwargs)
            with block:
                return fn(*args, **kwargs)
        return wrapped
    return deco
