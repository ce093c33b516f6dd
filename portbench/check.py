"""What decides ``correct``: the anneal's output checked against the plain
reference on a sample of frames.

The frames of a separation are independent answers (each frame's sources
depend on that frame alone), so the reference follows ``strata`` frames
drawn from the seed, one from each of as many contiguous blocks of the
batch, through the levels the window ran. It draws the Langevin noise
again from the program's generator state saved before the call (a graphed
anneal draws what an eager one draws) and slices it.

The reference runs from ``x_init`` through every level on its own
(it never restarts from the program's state), so each level's output is
checked against an independent chain.

The numbers, in dB (the configuration's ``db_per_unit``), widest over the
window's levels, of |program - reference| over the sampled elements:
``x_p99_db``, its 99th percentile; ``x_rms_db``, its root mean square;
``x_gap_db``, its largest element. The dB mixing amplifies rounding in
rare elements (two sources alike and far from the mixture) by up to 10^4
over a level, so the largest element and the root mean square swing from
seed to seed by float32 rounding alone, while the 99th percentile stays
put. A number is held to ``limit`` in the cell's workload file where it
has one; every number must be finite.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import basis
from .reference.precision import Precision
from .spec import derive


def sample_frames(n_frames: int, strata: int, seed: int) -> List[int]:
    rng = np.random.default_rng(derive(seed, "sample"))
    edges = np.linspace(0, n_frames, min(strata, n_frames) + 1).astype(int)
    return [int(rng.integers(a, b)) for a, b in zip(edges[:-1], edges[1:])]


class Noise:
    """The program's Langevin draws again: ``normal_`` of the iterate's
    full shape from a generator restored to the saved state, in order."""

    def __init__(self, state, shape, device, frames: List[int]):
        self.gen = torch.Generator(device=device)
        self.gen.set_state(state)
        self.buf = torch.empty(shape, device=device)
        self.frames = frames

    def next(self) -> torch.Tensor:
        return self.buf.normal_(generator=self.gen)[:, self.frames].clone()


def anneal(arch, cell, seed: int, inputs, frames: List[int], levels: int,
           prec: Precision, device) -> list:
    """The reference's sources after each of ``levels`` levels on
    ``frames``."""
    cfg, traffic = cell.config, cell.traffic
    noise = Noise(inputs.gen_state, inputs.x_init.shape, device, frames)
    mixed = inputs.mixed[frames]
    x = inputs.x_init[:, frames]
    cache, out = {}, []
    with torch.no_grad(), prec.flags():
        for level in range(levels):
            t0 = time.perf_counter()
            draws = [noise.next() for _ in range(cfg["T"])]
            score = arch.reference_scores(cfg, traffic, seed, level, device,
                                          prec, cache)
            x = basis.run_level(score, x, mixed, inputs.sigmas, level,
                                cfg["T"], cfg["step_lr"],
                                lambda t: draws[t])
            out.append(x)
            log(f"reference ({prec.mode}) level {level}: "
                f"{time.perf_counter() - t0:.3f} s")
    return out


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def numbers(program: list, reference: list, db_per_unit: float
            ) -> Dict[str, float]:
    """``x_p99_db``, ``x_rms_db`` and ``x_gap_db``, widest over the
    levels; a non-finite program output reads inf."""
    out = {"x_p99_db": 0.0, "x_rms_db": 0.0, "x_gap_db": 0.0}
    for p, r in zip(program, reference):
        d = ((p.double() - r.double()) * db_per_unit).abs().flatten()
        if not torch.isfinite(d).all():
            return {k: math.inf for k in out}
        found = {"x_p99_db": torch.quantile(d, 0.99).item(),
                 "x_rms_db": d.square().mean().sqrt().item(),
                 "x_gap_db": d.max().item()}
        out = {k: max(v, found[k]) for k, v in out.items()}
    return out


def judge(found: Dict[str, float], compare: Dict[str, dict]):
    """``(correct, checks)``: every number finite and at most its limit;
    ``checks`` the numbers held to a limit, each with it."""
    checks = {k: {"value": found[k], "limit": v["limit"]}
              for k, v in compare.items()}
    correct = bool(checks) and all(math.isfinite(v) for v in found.values()) \
        and all(c["value"] <= c["limit"] for c in checks.values())
    return correct, checks


def program_check(arch, cell, seed, inputs, snaps: list, device):
    """The program's snapshots against the reference: ``(numbers,
    frames)``."""
    work = cell.workload
    frames = sample_frames(cell.traffic["frames"], work["sample_strata"],
                           seed)
    program = [s[:, frames] for s in snaps]
    ref = anneal(arch, cell, seed, inputs, frames, len(snaps),
                 Precision("f32"), device)
    return numbers(program, ref, cell.config["db_per_unit"]), frames


def control_check(arch, cell, seed, inputs, levels: int, device,
                  mode: Optional[str] = None):
    """The control: the reference in the cell's control precision put in
    the program's place over ``levels`` levels, then checked as the
    program is. ``(numbers, frames)``."""
    work = cell.workload
    frames = sample_frames(cell.traffic["frames"], work["sample_strata"],
                           seed)
    low = anneal(arch, cell, seed, inputs, frames, levels,
                 Precision(mode or work["control"]), device)
    ref = anneal(arch, cell, seed, inputs, frames, levels, Precision("f32"),
                 device)
    return numbers(low, ref, cell.config["db_per_unit"]), frames
