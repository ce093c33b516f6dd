"""Run one cell of ``BENCHMARK.json`` once on one card and print its result
as the last line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (and the ``breakdown`` of the traced span). Exits with
2, printing no result, without a CUDA device or with fewer than the cell
asks for, when JAX or the JAX package is loaded once the window has
closed, or when anything fails. The numbers compared with the reference
end standard error and the result's line, each beside its limit.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _cache_dirs() -> None:
    """Kernel and build caches inside the checkout, at fixed paths."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def print_checks(checks) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)


def finite(v):
    """``v`` with every non-finite float written as null."""
    if isinstance(v, dict):
        return {k: finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def main(argv=None, device=None, cell_override=None) -> int:
    """Run the cell; ``device`` and ``cell_override`` (a function of the
    loaded cell) are for the CPU rehearsal in the tests, which skips the
    look for a card."""
    args = parse(argv)
    _cache_dirs()
    import torch
    from portbench import harness, spec
    try:
        cell = spec.cell(args.workload, ROOT)
        if cell_override is not None:
            cell = cell_override(cell)
        if device is None:
            if not torch.cuda.is_available() or \
                    torch.cuda.device_count() < cell.chips:
                harness.log(f"needs {cell.chips} CUDA device(s), found "
                            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
                return 2
            device = "cuda:0"
        result = harness.run(cell, args.seed, args.seconds,
                             bool(args.trace), device, T_START)
    except Exception:
        traceback.print_exc()
        return 2
    found = harness.forbidden_modules()
    if found:
        harness.log(f"loaded in this process: {', '.join(found)}")
        return 2
    print_checks(result["checks"])
    print(json.dumps(finite(result)))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
