"""Readings for a cell's limits: for each seed, one run of the cell as
``run.py`` makes it and the control (the reference in the cell's control
precision put in the program's place, over as many levels as the window
ran), each checked against the reference, with the seconds each took. One
JSON line a seed on standard output:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11,12,13 [--control-only --levels 3] [--mode tf32]

``--control-only`` skips the program and reads the control over
``--levels`` levels; ``--mode`` reads a control in another precision
than the cell's (``tf32``, ``bf16``, ``fp8``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--levels", type=int, default=3)
    p.add_argument("--control-only", action="store_true")
    p.add_argument("--mode", default=None)
    args = p.parse_args(argv)
    import torch
    from portbench import check, harness, spec, traffic
    cell = spec.cell(args.workload, ROOT)
    arch = spec.arch(cell.config["arch"])
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        row = {"seed": seed}
        if args.control_only:
            inp = traffic.make(cell.config, cell.traffic, seed, device)
            ins = harness.CheckInputs(inp.mixed, inp.x_init, inp.sigmas,
                                      inp.generator.get_state())
            levels = args.levels
        else:
            keep = {}
            res = harness.run(cell, seed, args.seconds, False, device,
                              time.perf_counter(), keep)
            row["metrics"], row["program"] = res["metrics"], keep["numbers"]
            ins, levels = keep["inputs"], len(keep["snaps"])
            del keep
        t0 = time.perf_counter()
        row["control"] = check.control_check(arch, cell, seed, ins, levels,
                                             device, args.mode)[0]
        row["mode"] = args.mode or cell.workload["control"]
        row["control_s"] = time.perf_counter() - t0
        row["levels"] = levels
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
