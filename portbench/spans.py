"""The program's spans as the per-layer metrics read them, and on a
``--trace 1`` run's clock.

The program records its spans in ``separation.graphs.Record`` (a
``utils.profiling.Spans``): per level ``anneal.warmup``,
``anneal.capture`` (``anneal.begin_capture`` inside), ``anneal.instantiate``,
``anneal.replays`` (the first replay's launch in ``anneal.first_replay``)
and ``anneal.release`` on the host clock, and, in a level whose warm-up
and capture start while a profiler runs (the traced level: level 1 in a
``--trace 1`` run), the module spans of its capture, each with the card's
milliseconds between its two CUDA events in the level's last replay:
``score``, ``score.forward``, ``score.backward``, ``basis.update``,
``anneal.noise``, and a RefineNet forward's ``conv``. A captured pair the
card gives no time for raises in the program; there is no stand-in.

Host spans are stamped with ``time.perf_counter_ns``, the trace
(``trace.Reading``) in the profiler's microseconds. :func:`clock` maps the
one onto the other from two rows that sit at span edges in the traced
level: the end of ``anneal.begin_capture`` (just after
``cudaStreamBeginCapture`` returns: the row's end) and the end of
``anneal.first_replay`` (just after the level's first ``cudaGraphLaunch``
returns: the row's end). The start of ``anneal.replays`` would not do:
the generator's replay prologue (two fill kernels) and the Python of the
replay's wrappers sit between it and the launch, 0.15-0.2 ms on an H100.
It checks a third edge, the end of ``anneal.instantiate`` against the end
of ``cudaGraphInstantiate*``, and maps nothing where the two lie more than
``TOLERANCE_US`` apart.

A program without spans has no ``spans`` on its record: everything here
then reads nothing, and raises nothing.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell once with ``--trace 1`` and prints, before its result line,
the traced level's :func:`breakdown` on standard error (and writes it to
``chiprun_out/spans_<cell>_<seed>.json``), with the device ms of every
graph replay that ran with the profiler stopped (an event pair around
each), as each level's median: level 1's against level 0's is what its
captured event nodes cost. ``--every-leaf`` runs it inside
``utils.profiling.every_leaf``: the traced level's warm-up and capture
span every leaf kind, each with an event pair, for the breakdown by kind
(its replays and capture then pay for them).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.trace import busy_us, first, union  # noqa: E402

TOLERANCE_US = 100.0


def all_spans(record) -> list:
    return list(getattr(record, "spans", None) or [])


def traced_level(record) -> Optional[int]:
    """The first level whose module spans were on."""
    levels = getattr(record, "traced", None) or []
    return levels[0] if levels else None


def named(record, name: str, level) -> list:
    return [s for s in all_spans(record)
            if s.name == name and s.level == level]


def mean_seconds(record, name: str) -> Optional[float]:
    """The mean seconds of span ``name`` over the levels after level 0."""
    found = [s.seconds for s in all_spans(record)
             if s.name == name and s.level is not None and s.level > 0]
    return sum(found) / len(found) if found else None


def device_spans(record) -> list:
    """The traced level's module spans captured into its graph, with the
    device time of its last replay."""
    level = traced_level(record)
    return [s for s in all_spans(record) if s.level == level
            and s.phase == "capture" and s.device_ms is not None]


def _descendants(record, root) -> list:
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        kids = record.children(s)
        out.extend(kids)
        todo.extend(kids)
    return out


def device_ms(record, names) -> Optional[float]:
    """The device ms of the traced level's spans named in ``names``,
    summed; None where there are none."""
    found = [s.device_ms for s in device_spans(record) if s.name in names]
    return sum(found) if found else None


def nonconv_ms(record) -> Optional[float]:
    """Device ms of the ``score.forward`` spans less their ``conv`` spans
    (the outermost ones), summed; None where a forward holds no timed
    conv (a flow's forward spans none)."""
    forwards = [s for s in device_spans(record) if s.name == "score.forward"]
    total = 0.0
    for f in forwards:
        convs = [c for c in _descendants(record, f) if c.name == "conv"
                 and record.spans[c.parent].name != "conv"]
        if not convs or any(c.device_ms is None for c in convs):
            return None
        total += f.device_ms - sum(c.device_ms for c in convs)
    return total if forwards else None


def top_device_ms(record) -> Optional[float]:
    """Device ms of the traced level's outermost device spans, summed."""
    found = [s for s in device_spans(record) if s.parent is None
             or record.spans[s.parent].device_ms is None]
    return sum(s.device_ms for s in found) if found else None


class Clock(NamedTuple):
    """Trace microseconds of a host ``perf_counter_ns`` stamp."""
    ns0: int
    us0: float
    slope: float
    error_us: float

    def us(self, ns: int) -> float:
        return self.us0 + (ns - self.ns0) * 1e-3 * self.slope


def clock(record, reading) -> Optional[Clock]:
    """The traced level's spans on ``reading``'s clock, or None where a
    row or span is missing or the third edge is off by more than
    ``TOLERANCE_US``."""
    c = _fit(record, reading)
    return c if c is not None and c.error_us <= TOLERANCE_US else None


def _fit(record, reading) -> Optional[Clock]:
    level = traced_level(record)
    if reading is None or level is None:
        return None
    names = ("anneal.begin_capture", "anneal.instantiate",
             "anneal.first_replay")
    spans = {n: named(record, n, level) for n in names}
    begin, launch = first(reading, "capture_begin"), first(reading, "replay")
    made = first(reading, "instantiate")
    if not all(spans.values()) or None in (begin, launch, made):
        return None
    began, inst, rep = (spans[n][0] for n in names)
    host_us = (rep.end_ns - began.end_ns) * 1e-3
    if host_us <= 0:
        return None
    c = Clock(began.end_ns, begin[1], (launch[1] - begin[1]) / host_us, 0.0)
    return c._replace(error_us=abs(c.us(inst.end_ns) - made[1]))


def warmup_idle_s(record, reading) -> Optional[float]:
    """Seconds the card idles inside the traced level's
    ``anneal.warmup``."""
    c = clock(record, reading)
    if c is None:
        return None
    w = named(record, "anneal.warmup", traced_level(record))[0]
    lo, hi = max(c.us(w.start_ns), reading.span[0]), c.us(w.end_ns)
    if hi <= lo:
        return None
    return (hi - lo - busy_us(reading, lo, hi)) * 1e-6


def _depth(record, s) -> int:
    d = 0
    while s.parent is not None:
        s, d = record.spans[s.parent], d + 1
    return d


def idle_gaps(record, reading, top: int = 10) -> Optional[list]:
    """The longest idle gaps of the card in the traced span: (the
    innermost span the host was in, the gap's seconds, its start in
    seconds after the traced level's warm-up began). The innermost span
    is the deepest that holds the whole gap, else the deepest that holds
    more than half of it, else the one that holds most of it."""
    c = clock(record, reading)
    if c is None:
        return None
    lo, hi = reading.span
    busy = union([(t0, t1) for _, t0, t1 in reading.kernels], lo, hi)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    placed = [(s, c.us(s.start_ns), c.us(s.end_ns))
              for s in all_spans(record) if s.end_ns]
    warm = c.us(named(record, "anneal.warmup", traced_level(record))[0]
                .start_ns)
    out = []
    for a, b in gaps:
        holds = [s for s, s0, s1 in placed if s0 <= a and b <= s1]
        if holds:
            s = max(holds, key=lambda s: _depth(record, s))
        else:
            over = [(min(b, s1) - max(a, s0), _depth(record, s), s)
                    for s, s0, s1 in placed if min(b, s1) > max(a, s0)]
            most = [o for o in over if 2 * o[0] > b - a]
            s = (max(most, key=lambda o: o[1]) if most else
                 max(over, key=lambda o: o[:2]) if over else (None,) * 3)[2]
        label = f"{s.name} ({s.phase}, level {s.level})" if s else "none"
        out.append((label, (b - a) * 1e-6, (a - warm) * 1e-6))
    return out


def _by_name(record, spans, seconds: bool) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in spans:
        v = record.self_seconds(s) if seconds else record.self_device_ms(s)
        if v is not None:
            out[s.name] = out.get(s.name, 0.0) + v
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def breakdown(record, reading) -> dict:
    """The traced level: device ms by span name (self time), host seconds
    of its warm-up and capture by span name (self time), the outermost
    device spans against the replays' event-timed device ms a step, and
    the idle gaps under their spans."""
    level = traced_level(record)
    if level is None:
        return {}
    spans = [s for s in all_spans(record) if s.level == level]
    steps = [lv for lv in getattr(record, "levels", []) if lv.level == level]
    fit = _fit(record, reading)
    timed = device_spans(record)
    rows = {n: first(reading, n) for n in ("capture_begin", "capture_end",
                                           "instantiate", "replay")} \
        if reading is not None else {}
    return {
        "level": level,
        "device_ms_self": _by_name(record, timed, False),
        "top_device_ms": top_device_ms(record),
        "replay_device_ms": (steps[0].device_ms / steps[0].steps
                             if steps and steps[0].device_ms else None),
        "host_s_self": {phase: _by_name(record, [
            s for s in spans if s.phase == phase], True)
            for phase in ("warmup", "capture")},
        "spans": {phase: len([s for s in spans if s.phase == phase])
                  for phase in ("warmup", "capture", "eager")},
        "clock_error_us": fit.error_us if fit else None,
        "clock_slope": fit.slope if fit else None,
        "anchors": {
            "host_ms": {s.name: [(s.start_ns - spans[0].start_ns) * 1e-6,
                                 (s.end_ns - spans[0].start_ns) * 1e-6]
                        for s in spans if s.name.startswith("anneal.")
                        and s.name != "anneal.noise"},
            "trace_ms": {n: [(r[0] - reading.span[0]) * 1e-3,
                             (r[1] - reading.span[0]) * 1e-3]
                         for n, r in rows.items() if r is not None}},
        "warmup_idle_s": warmup_idle_s(record, reading),
        "idle_gaps": idle_gaps(record, reading),
    }


def _time_replays() -> list:
    """Wrap ``CUDAGraph.replay`` in an event pair where no profiler runs
    (None where one does); returns the pairs."""
    import torch
    pairs, original = [], torch.cuda.CUDAGraph.replay

    def replay(g, *a, **k):
        if torch._C._autograd._profiler_enabled():
            pairs.append(None)
            return original(g, *a, **k)
        e = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        e[0].record()
        out = original(g, *a, **k)
        e[1].record()
        pairs.append(e)
        return out

    torch.cuda.CUDAGraph.replay = replay
    return pairs


def _replay_medians(record, pairs, T: int) -> dict:
    """Per level, the median device ms of its replays that ran with the
    profiler stopped."""
    import statistics
    out = {}
    for i, lv in enumerate(getattr(record, "levels", [])):
        ms = [p[0].elapsed_time(p[1]) for p in pairs[i * T:(i + 1) * T]
              if p is not None]
        if ms:
            out[lv.level] = statistics.median(ms)
    return out


def main(argv: List[str]) -> int:
    """One ``--trace 1`` run of a cell with its :func:`breakdown`;
    ``--every-leaf`` spans every leaf kind in the traced level's warm-up
    and capture (its replays then pay for some 370 NCSN or 2,200 Glow
    event pairs)."""
    import contextlib
    from audiosourcesep_tpu_torch.utils import profiling
    from portbench import run, spec
    wide = "--every-leaf" in argv
    argv = [a for a in argv if a != "--every-leaf"]
    seen = {}
    reader = spec.metric_reader

    def keeping(name):
        read = reader(name)

        def wrapped(ctx):
            seen["ctx"] = ctx
            return read(ctx)
        return wrapped

    spec.metric_reader = keeping
    args = run.parse(argv + ["--trace", "1"])
    replays = _time_replays()
    with profiling.every_leaf() if wide else contextlib.nullcontext():
        rc = run.main(argv + ["--trace", "1"])
    if "ctx" in seen:
        out = breakdown(seen["ctx"].record, seen["ctx"].trace)
        out["replay_ms_median"] = _replay_medians(
            seen["ctx"].record, replays, seen["ctx"].cell.config["T"])
        text = json.dumps(run.finite(out))
        print(f"spans: {text}", file=sys.stderr)
        path = run.ROOT / "chiprun_out" / \
            f"spans_{args.workload}_{args.seed}.json"
        path.parent.mkdir(exist_ok=True)
        path.write_text(text + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
