"""Launch counters of the port's hand-written kernels.

Each op module that launches a kernel (``ops.winograd``, ``ops.instnorm``,
``ops.pool``) keeps its counters as module globals: whole counts, and dicts
of name -> count. :class:`Counters` gives one module's counters a layout
and the arithmetic a CUDA graph's owner (``separation.graphs``) needs: a
launch made while a graph captures runs nothing then, so the owner takes
the capture's counts back off and adds them again at every replay.
"""

from __future__ import annotations

from typing import Sequence


class Counters:
    """The counters of one module: the whole counts named ``ints`` and the
    dicts of counts named ``dicts``, globals of ``namespace`` (the module's
    ``globals()``). A layout is ``{name: n, ..., name: {key: n}}``."""

    def __init__(self, namespace: dict, ints: Sequence[str],
                 dicts: Sequence[str] = ()):
        self.namespace, self.ints, self.dicts = namespace, ints, dicts

    def get(self) -> dict:
        """A copy of every counter."""
        ns = self.namespace
        return {**{k: ns[k] for k in self.ints},
                **{c: dict(ns[c]) for c in self.dicts}}

    def since(self, before: dict) -> dict:
        """The counts since :meth:`get` gave ``before``, in its layout (keys
        of other modules in ``before`` are passed over)."""
        now = self.get()
        return {**{k: now[k] - before[k] for k in self.ints},
                **{c: {k: n - before[c][k] for k, n in now[c].items()}
                   for c in self.dicts}}

    def add(self, launches: dict, times: int) -> None:
        """Add ``times`` x ``launches`` (:meth:`since`'s layout) to the
        counters: a graph's replays add what its capture counted, and the
        capture, which ran nothing, takes it off (``times = -1``)."""
        ns = self.namespace
        for k in self.ints:
            ns[k] += times * launches[k]
        for c in self.dicts:
            counts = ns[c]
            for k, n in launches[c].items():
                counts[k] += times * n
