"""The NCSNv2 noise-schedule ratio (technique 2) and Langevin step size
(technique 4) (port of the repository's ``technique2and4_ncsnv2.py``, the
same flags and output; scipy root finds, no device).

    python -m audiosourcesep_tpu_torch.technique2and4_ncsnv2 --D 96,64,1 \\
        --T 5 --sigma1 55 --sigmaL 0.01
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .utils import technique2_gamma, technique4_epsilon


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute num_classes and epsilon for NCSNv2")
    parser.add_argument("--D", type=str, default="96,64,1")
    parser.add_argument("--T", type=float, default=5.0)
    parser.add_argument("--sigma1", type=float, default=55.0)
    parser.add_argument("--sigmaL", type=float, default=0.01)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.sigma1 > args.sigmaL:
        raise ValueError("--sigma1 must exceed --sigmaL")
    try:
        D = int(np.prod([int(i) for i in args.D.split(",")]))
    except (ValueError, TypeError):
        print("ERROR: D should be in the form: H,W,C")
        return 1

    print("".join(f"{k} = {v} \n" for k, v in vars(args).items()))
    gamma, _ = technique2_gamma(D, args.sigma1, args.sigmaL)
    technique4_epsilon(args.T, args.sigmaL, gamma)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
