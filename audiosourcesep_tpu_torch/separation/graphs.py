"""The anneal's step runner: on a CUDA device each noise level's Langevin
step is captured as one CUDA graph and replayed T times.

The JAX package compiles its anneals: BASIS runs each noise level as one
jitted T-step ``lax.scan`` with the iterate donated
(``audiosourcesep_tpu/separation/basis.py:273-289``), and the NCSN sampler
is a jitted double scan (``audiosourcesep_tpu/models/ncsn/utils.py:86-103``).
PyTorch runs eagerly and launches every op of every step from the host; a
CUDA graph of one step is the port's counterpart of the compiled level: one
host call replays the whole step, the hand-written kernels inside it.

:func:`anneal` takes, for each level, a step body ``body(x, noise)`` that
updates ``x`` in place from static buffers: ``x`` itself, a noise buffer
of ``x``'s shape and dtype, and what the caller binds in (the level's
labels and constants, the mixture, the models). Per level, graphed:

1. warm-up: the body runs once eagerly on a side stream, on a copy of
   ``x`` (the generator is not drawn from), as PyTorch requires before a
   capture: it fills every lazy cache the capture must find full (the
   kernels' library, the convs' Winograd weights, cuBLAS and autograd
   state). Its launches run on the card and are counted as such;
2. capture: the draw of the noise (``noise.normal_`` from the caller's
   ``torch.Generator``, registered with the graph so that every replay
   draws the next numbers, as the eager loop would) and the body, into one
   graph, then its instantiation;
3. replay, T times. Where ``noise_fn`` gives the noise (tests feed the JAX
   package's draws), each step's noise is copied into the buffer before
   its replay, and the graph draws nothing.

Every level's warm-up and capture run on one side stream, the one the
process keeps for the device (:func:`_side_stream`), and every level's
graph is captured into one memory pool, which the last level's graph
keeps alive until the next capture ends: a capture reuses the pool the
last one filled, a warm-up the blocks the last one cached on that stream,
so one step's working memory is held at a time and no cache is emptied
between levels. (``torch.cuda.graph``'s entry empties the allocator's
caches at every capture, so that each level allocated its memory anew, in
host time that swung from level to level; and blocks are cached per
stream, so a new side stream a level would leave the blocks of the
earlier ones cached and unused.) That holds a step's working
memory twice, once cached by the warm-up and once in the graph's pool. So
an anneal empties the cache once, before its first warm-up, and the blocks
that warm-up leaves cached are then its step's working memory. Where the
card's free memory is under that plus a tenth of the card (the
allocator's rounding: a Flow++ score over 30 frames keeps ~43 GB), the
anneal runs tight: each level frees the last graph before its warm-up and
empties the allocator's cache after it, so that the capture, which
cannot free cached blocks itself, finds the memory on the card.

The eager path (the CPU, or ``graphed=False``) runs the same body on the
same buffers, drawing or copying the noise before each step: the two
paths do the same math in the same order. A capture or replay failure
raises; nothing falls back to the eager loop. Per-level callbacks and
snapshots run between levels, outside any graph.

Kernel launches made while a graph captures run nothing: the launch
counters (``ops.counting``) take the capture's counts back off and add
them again at every replay (:class:`StepGraph`), so they count what the
card ran.

Inside a :func:`recording` block every level is cut into spans
(``utils.profiling``, host clock), one after another: ``anneal.warmup``
(the warm-up step and the wait for it), ``anneal.capture`` (from the
graph's making to the body's return: in it ``anneal.begin_capture``, the
graph made, a wait for the card and ``cudaStreamBeginCapture``; then the
Python and autograd that build the graph, while the card runs nothing),
``anneal.instantiate``
(``cudaStreamEndCapture`` and ``cudaGraphInstantiate``),
``anneal.replays`` (the T replays and the wait that ends them; the first
replay's launch, which uploads the graph, in ``anneal.first_replay``;
``anneal.steps`` for T eager steps) and ``anneal.release`` (the events
read, ``after_level``; the last level's graph is freed in the next
capture). Across them, ``anneal.turnover`` runs from the end of the last
level's replays (or steps; for level 0, from the anneal's entry) to the
start of this level's: the release, the caller's callback, ``make_step``,
the warm-up, the capture and the instantiation, the time a level costs
besides its steps. It is stamped on the host clock alone, with no wait
and no work on the card. A level whose warm-up and capture start while a
``torch.profiler`` profile runs also records module spans
(``utils.profiling``): a graphed level in its capture, with CUDA events
that the capture puts into the graph as event nodes; an eager level in
its first step.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import time
from typing import Callable, Iterator, List, NamedTuple, Optional

import torch

from ..ops import counting
from ..utils import profiling

Body = Callable[[torch.Tensor, torch.Tensor], None]


class Capture(NamedTuple):
    """One level's graph: the seconds of its warm-up step (run to its end
    on the card; the ``anneal.warmup`` span) and of its capture (host
    time from the warm-up's end: ``anneal.capture`` plus
    ``anneal.instantiate``), and the kernel
    launches of one replay (``ops.counting.since``' layout)."""
    level: int
    warmup_s: float
    capture_s: float
    launches: dict


class LevelSteps(NamedTuple):
    """One level's T steps (replays, or eager steps): host seconds from the
    first step's launch to the last one's end, and the stream's
    milliseconds between two CUDA events around them (None on the CPU)."""
    level: int
    steps: int
    host_s: float
    device_ms: Optional[float]


class Record(profiling.Spans):
    """What :func:`anneal` did inside a :func:`recording` block: its spans
    (:class:`utils.profiling.Spans`), and per level its capture and its
    steps."""

    def __init__(self):
        super().__init__()
        self.captures: List[Capture] = []
        self.levels: List[LevelSteps] = []

    @property
    def capture_s(self) -> float:
        return sum(c.capture_s for c in self.captures)

    @property
    def warmup_s(self) -> float:
        return sum(c.warmup_s for c in self.captures)


_RECORD: contextvars.ContextVar = contextvars.ContextVar("anneal_record",
                                                         default=None)


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Record every capture, every level's step times and spans that
    :func:`anneal` makes in this block (the CLIs print the capture time).
    Each level's steps then end in a wait for the card."""
    record = Record()
    token = _RECORD.set(record)
    try:
        yield record
    finally:
        _RECORD.reset(token)


def print_capture(record: Record) -> None:
    """The CLIs' ``Capture:`` line, where the anneal captured graphs."""
    if record.captures:
        print(f"Capture: {round(record.capture_s, 3)} seconds, "
              f"{len(record.captures)} graphs (warm-up steps "
              f"{round(record.warmup_s, 3)} seconds)")


def use_graphs(graphed: Optional[bool], device, ranks: int = 1) -> bool:
    """Whether the anneal on ``device`` over ``ranks`` ranks runs graphed:
    ``None`` means on a single-rank CUDA run. ``True`` on the CPU, or over
    several ranks (whose NCCL collectives a graph does not capture yet),
    raises; so does any device but the CPU and CUDA."""
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the anneal runs on a CPU or a CUDA device, not "
                         f"{device}")
    if graphed is None:
        return device.type == "cuda" and ranks == 1
    if graphed and device.type != "cuda":
        raise ValueError(f"a CUDA graph of the anneal needs a CUDA device, "
                         f"got {device}")
    if graphed and ranks > 1:
        raise ValueError(f"the anneal over {ranks} ranks runs eagerly: its "
                         f"collectives are not captured in a CUDA graph")
    return bool(graphed)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of every anneal's warm-ups and captures on
    ``device``, one for the process. Anneals on one device run one after
    another."""
    return torch.cuda.Stream(device=device)


class LevelGraph:
    """The CUDA side of an anneal's graphs, one level's at a time (the CPU
    tests stand in for it): the warm-up and the capture on the device's
    side stream, the capture into the memory pool of the last level's
    graph (a new pool at the anneal's first), the instantiation, the
    replays. ``generator``, if not None, is registered with each graph."""

    def __init__(self, device, generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator
        self.graph = None
        self.side = _side_stream(self.device)
        # whether a step's working memory does not fit on the card twice:
        # decided at the first warm-up
        self.tight = None

    def warm_up(self, fn: Callable[[], None]) -> None:
        """``fn()`` on the side stream, then a wait for the card. The
        first empties the cache before; tight, each frees the last graph
        first and empties the cache after."""
        if self.tight is not False:
            self.graph = None
            torch.cuda.empty_cache()
        current = torch.cuda.current_stream(self.device)
        self.side.wait_stream(current)
        with torch.cuda.stream(self.side):
            fn()
        current.wait_stream(self.side)
        torch.cuda.synchronize(self.device)
        if self.tight is None:
            cached = torch.cuda.memory_reserved(self.device) \
                - torch.cuda.memory_allocated(self.device)
            free, total = torch.cuda.mem_get_info(self.device)
            self.tight = free < cached + total // 10
        if self.tight:
            torch.cuda.empty_cache()

    def capture(self, fn: Callable[[], None], begun: Callable[[], None],
                ended: Callable[[], None]) -> None:
        """Make a graph, capture ``fn()`` into the last graph's memory pool
        (a new one at the first capture) and instantiate the graph;
        ``begun()`` runs just after the capture begins, ``ended()`` after
        ``fn``. The last graph is freed once the capture ends: the caching
        allocators drop a pool that no graph holds."""
        last = self.graph
        # kept until freed, so that the instantiation is a call of its own
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None:
            self.graph.register_generator_state(self.generator)
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self.side):
            self.graph.capture_begin(
                pool=None if last is None else last.pool())
            try:
                begun()
                fn()
                ended()
            finally:
                self.graph.capture_end()
        del last
        self.graph.instantiate()

    def replay(self) -> None:
        self.graph.replay()


class StepGraph:
    """A captured step: ``replay()`` runs ``graph`` and adds the kernel
    launches counted during ``capture()`` (``launches``, in
    ``ops.counting``'s layout) to the counters, from which the capture,
    which ran nothing on the card, took them off."""

    def __init__(self, graph, capture: Callable[[], None]):
        before = counting.snapshot()
        capture()
        self.launches = counting.since(before)
        counting.add(self.launches, -1)
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        counting.add(self.launches)


def _traced(record: Optional[Record]) -> Optional[Record]:
    """``record`` where a level starting now records its module spans."""
    if record is not None and profiling.profiler_running():
        return record
    return None


def capture_step(body: Body, x: torch.Tensor, noise: torch.Tensor,
                 draw: Optional[Callable[[], None]], graph: LevelGraph,
                 level: int = 0) -> StepGraph:
    """Warm ``body`` up on ``graph``'s side stream, on a copy of ``x``,
    then capture ``draw()`` (if given: the noise drawn into ``noise``) and
    ``body(x, noise)`` into ``graph``'s next graph."""
    record = _RECORD.get()
    spans = record if record is not None else profiling.Spans()
    traced = _traced(record)
    leaves = profiling.graphed_leaves()
    with spans.block("anneal.warmup", level, "warmup") as warm, \
            profiling.tracing(traced if leaves else None, level, "warmup",
                              x.device, leaves):
        graph.warm_up(lambda: body(x.clone(), noise))
    held = {}

    def ended():
        spans.close(held["capture"])
        held["instantiate"] = spans.open("anneal.instantiate", level,
                                         "capture")

    def step():
        with profiling.tracing(traced, level, "capture", x.device, leaves):
            if draw is not None:
                draw()
            body(x, noise)

    def capture():
        held["capture"] = spans.open("anneal.capture", level, "capture")
        begin = spans.open("anneal.begin_capture", level, "capture")
        graph.capture(step, lambda: spans.close(begin), ended)
        spans.close(held["instantiate"])

    out = StepGraph(graph, capture)
    if record is not None:
        record.captures.append(Capture(
            level, warm.seconds,
            held["capture"].seconds + held["instantiate"].seconds,
            out.launches))
    return out


def anneal(make_step: Callable[[int], Body], x: torch.Tensor,
           n_levels: int, T: int, graphed: bool,
           generator: Optional[torch.Generator] = None,
           noise_fn: Optional[Callable] = None,
           after_level: Optional[Callable] = None) -> torch.Tensor:
    """Run ``n_levels`` x ``T`` steps on ``x`` in place and return it.

    Args:
        make_step: ``make_step(level) -> body``, ``body(x, noise)`` one step
            of that level on the static buffers.
        x: the iterate, updated in place (the graphs' static input).
        graphed: one CUDA graph a level (:func:`use_graphs` decides), or
            eager.
        generator: draws the standard-normal noise (``None``: the
            device's default generator).
        noise_fn: ``(level, step) -> noise`` of ``x``'s shape, copied into
            the noise buffer instead of a draw.
        after_level: ``after_level(level, x)`` after each level.
    """
    record = _RECORD.get()
    spans = record if record is not None else profiling.Spans()
    timed = record is not None and x.device.type == "cuda"
    noise = torch.zeros_like(x)

    def draw():
        with profiling.span("anneal.noise"):
            noise.normal_(generator=generator)

    graph = LevelGraph(x.device, generator if noise_fn is None else None) \
        if graphed else None
    turnover_ns = time.perf_counter_ns()
    for level in range(n_levels):
        body = make_step(level)
        traced = None if graphed else _traced(record)
        step = capture_step(body, x, noise,
                            None if noise_fn is not None else draw,
                            graph, level) if graphed else None
        if timed:
            events = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            events[0].record()
        with spans.block("anneal.replays" if graphed else "anneal.steps",
                         level, "eager") as steps:
            spans.add("anneal.turnover", level, "eager", turnover_ns,
                      steps.start_ns)
            for t in range(T):
                if noise_fn is not None:
                    noise.copy_(noise_fn(level, t))
                if step is not None:
                    if t == 0:
                        with spans.block("anneal.first_replay", level,
                                         "eager"):
                            step.replay()
                    else:
                        step.replay()
                    continue
                # module spans of an eager level: its first step only
                with profiling.tracing(traced if t == 0 else None, level,
                                       "eager", x.device,
                                       profiling.LEAVES):
                    if noise_fn is None:
                        draw()
                    body(x, noise)
            if timed:
                events[1].record()
                events[1].synchronize()
        if record is not None:
            record.levels.append(LevelSteps(
                level, T, steps.seconds,
                events[0].elapsed_time(events[1]) if timed else None))
        with spans.block("anneal.release", level, "eager"):
            if timed:
                record.read_device()
            del step
            if after_level is not None:
                after_level(level, x)
        turnover_ns = steps.end_ns
    return x
