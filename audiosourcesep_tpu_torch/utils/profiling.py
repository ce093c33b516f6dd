"""Profiling helpers on ``torch.profiler`` (port of ``trace``,
``PhaseTimer`` and ``annotate`` in ``audiosourcesep_tpu/utils/profiling.py``).

The JAX module's TPU workarounds are not ported: ``fence`` (a completion
fence for a backend whose ``block_until_ready`` could return early; here
``torch.cuda.synchronize`` is exact), ``steady_state`` (a harness around
remote compiles) and ``enable_compilation_cache`` (XLA's cache).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Record a ``torch.profiler`` trace of the CPU and, where there is
    one, the CUDA device into ``log_dir`` (a ``*.pt.trace.json`` that
    TensorBoard and chrome://tracing read) when it is set; no-op
    otherwise. Yields the profiler (or ``None``)."""
    if not log_dir:
        yield None
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=(
            torch.profiler.tensorboard_trace_handler(log_dir))) as prof:
        yield prof


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _synchronize(block_on) -> None:
    """Wait for the CUDA devices of the tensors in ``block_on`` (a
    tensor, or nested sequences and mappings of them)."""
    for device in {t.device for t in _tensors(block_on) if t.is_cuda}:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Named phase wall-clock accumulator; prints a per-phase summary."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block. PyTorch returns before the card finishes, so
        ``block_on`` names what the block computed: the clock stops after
        its CUDA device has synchronised."""
        t0 = time.time()
        try:
            yield
        finally:
            if block_on is not None:
                _synchronize(block_on)
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.time() - t0)

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{name}: {secs:.3f}s ({100 * secs / total:.1f}%)"
                 for name, secs in sorted(self.totals.items(),
                                          key=lambda kv: -kv[1])]
        return "\n".join(lines)


def annotate(name: str):
    """Decorator: the function runs inside ``record_function(name)``, a
    named range in profiler timelines."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco
