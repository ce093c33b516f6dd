"""One run of one cell: set-up, the measured window, the check, the
metrics and the result line's fields.

Set-up loads the program's kernel library (building it with nvcc on a
checkout's first run: the seconds and whether it built are reported apart,
under ``build``), builds the program's priors from weights drawn from the
seed, draws the mixture, the sources' start and the noise's generator
(``traffic``), and makes one eager score call at the cell's shapes, so
that the process's one-time costs (cuBLAS and cuDNN handles) do not land
in level 0. It does no more: each level's warm-up step and capture belong
to the window, as the separation pays them.

The window is the product call, ``basis_separate_per_level`` with its
default ``graphed=None`` (on one card a CUDA graph of a Langevin step a
level), called as the separation CLI calls it, inside
``graphs.recording()``. It is made of whole levels from level 0: after
each level the benchmark's callback keeps a copy of ``x`` and ends the call
with an exception of its own once another level, judged by the last one's
time, would run past ``--seconds``. A window holds at least one level; a
``--trace 1`` run's holds two, since it traces level 1 (level 0 pays the
process's first capture, once a separation; levels 1 to 9 are alike).
"""

from __future__ import annotations

import collections
import gc
import sys
import time
from typing import NamedTuple, Optional

import torch

from . import check, spec, traffic as traffic_mod
from .trace import Tracer, busy_us, device_ops, idle_gaps

FORBIDDEN = ("jax", "jaxlib", "flax", "audiosourcesep_tpu")


class _WindowEnd(Exception):
    """Raised by the benchmark's callback to end the call between levels."""


class CheckInputs(NamedTuple):
    mixed: torch.Tensor
    x_init: torch.Tensor
    sigmas: object
    gen_state: torch.Tensor


class Context(NamedTuple):
    """What a per-layer metric's ``read(ctx)`` may read."""
    cell: object
    device_name: str
    record: object          # separation.graphs.Record of the window
    window_s: float
    instrument_s: float     # the tracer's own seconds inside the window
    steps: int
    step_flops: float
    routed: list            # the routable convs of one step
    trace: object           # trace.Reading or None


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``audiosourcesep_tpu_torch`` is not
    ``audiosourcesep_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, keep: Optional[dict] = None) -> dict:
    """One run; ``keep``, where given, receives the window's snapshots and
    the check's inputs (``portbench/calibrate.py`` reads them again)."""
    from audiosourcesep_tpu_torch import nn as port_nn
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     graphs)
    cfg, tr = cell.config, cell.traffic
    arch = spec.arch(cfg["arch"])
    device = torch.device(device)
    on_card = device.type == "cuda"

    # ---- set-up ------------------------------------------------------
    build = {"built": False, "seconds": 0.0}
    if on_card and tr["winograd"]:
        from audiosourcesep_tpu_torch.kernels import build as kernels
        before = set(kernels.BUILD_DIR.glob("*.so"))
        t_build = time.perf_counter()
        kernels.load_library()
        build = {"built": bool(set(kernels.BUILD_DIR.glob("*.so")) - before),
                 "seconds": time.perf_counter() - t_build}
    inputs = traffic_mod.make(cfg, tr, seed, device)
    score_fn = arch.build(cfg, tr, inputs.sigmas, seed, device)
    port_nn.set_winograd(tr["winograd"])
    labels = torch.zeros(tr["frames"], dtype=torch.long, device=device)
    with torch.no_grad():
        score_fn(inputs.x_init, labels, 0)
    del labels
    _sync(device)
    gen_state = inputs.generator.get_state()
    basis_cfg = BasisConfig(T=cfg["T"], delta=cfg["step_lr"],
                            data_type="melspec", scale=cfg["scale"],
                            collect_trajectory=True)
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(tr["trace_replays"]) if trace and on_card else None
    log(f"set-up {setup_s:.3f} s; kernel library {build['seconds']:.3f} s"
        f"{', built by nvcc in this run' if build['built'] else ''}")

    # ---- the window ------------------------------------------------------
    snaps, marks = [], []
    t0 = time.perf_counter()
    last = [t0]

    def callback(level, x):
        snaps.append(x.clone())
        if tracer is not None:
            tracer.stop()
        now = time.perf_counter()
        marks.append(now - last[0])
        last[0] = now
        if tracer is not None and level == 0:
            tracer.start()
        elif now - t0 + marks[-1] > seconds:
            raise _WindowEnd

    with graphs.recording() as record:
        try:
            basis_separate_per_level(score_fn, inputs.mixed, inputs.x_init,
                                     inputs.sigmas, inputs.generator,
                                     basis_cfg, callback=callback)
        except _WindowEnd:
            pass
    _sync(device)
    window_s = time.perf_counter() - t0
    port_nn.set_winograd(False)
    levels = len(snaps)
    steps = levels * cfg["T"]
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    for c in record.captures:
        log(f"level {c.level}: warm-up {c.warmup_s:.4f} s, capture "
            f"{c.capture_s:.4f} s, launches a replay {c.launches}")
    for lv, m in zip(record.levels, marks):
        log(f"level {lv.level}: {lv.steps} steps {lv.host_s:.4f} s host, "
            f"{lv.device_ms} ms device, {m:.4f} s with warm-up and capture")
    log(f"window {window_s:.4f} s, {levels} levels, {steps} steps, "
        f"{1e3 * window_s / steps:.4f} ms a step")
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"loaded in the run's process: {found}")

    # ---- what the per-layer metrics read, then the program freed --------
    reading = tracer.read() if tracer is not None else None
    if reading is not None:
        rows = collections.Counter(n for n, _, _ in reading.host)
        log(f"traced span: {tracer.count} replays, profiler start "
            f"{tracer.start_s:.3f} s, stop {tracer.stop_s:.3f} s, "
            f"{len(reading.kernels)} device rows, "
            f"host rows {dict(rows)}")
    failed = sum(cfg["T"] for s in snaps if not torch.isfinite(s).all())
    del score_fn
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # ---- correct ---------------------------------------------------------
    t_check = time.perf_counter()
    ins = CheckInputs(inputs.mixed, inputs.x_init, inputs.sigmas, gen_state)
    if keep is not None:
        keep.update(snaps=snaps, inputs=ins)
    found_numbers, frames = check.program_check(arch, cell, seed, ins,
                                                snaps, device)
    correct, checks = check.judge(found_numbers,
                                  cell.workload.get("compare", {}))
    correct = correct and failed == 0
    if keep is not None:
        keep["numbers"] = found_numbers
    log(f"check on frames {frames}: {found_numbers} in "
        f"{time.perf_counter() - t_check:.3f} s")

    # ---- metrics -------------------------------------------------------
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    if not trace:
        metrics = {"sep_step_ms": {"value": 1e3 * window_s / steps,
                                   "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in cell.end_to_end}
    else:
        step_flops, routed = arch.step_count(cfg, tr)
        ctx = Context(cell, name, record, window_s,
                      tracer.start_s + tracer.stop_s if tracer else 0.0,
                      steps,
                      step_flops, routed, reading)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is None:
                log(f"{m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics, "device": dev}
    if reading is not None:
        lo, hi = reading.span
        dev["busy_s"] = busy_us(reading, lo, hi) * 1e-6
        dev["window_s"] = (hi - lo) * 1e-6
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in device_ops(reading)],
            "idle_gaps": [[n, s] for n, s in idle_gaps(reading)]}
    result["build"] = build
    result["checks"] = checks
    return result
