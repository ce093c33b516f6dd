"""sigma_1 for NCSNv2: the largest pairwise distance of the training set
(port of the repository's ``technique1_ncsnv2.py``, the same argument,
output and ``max_norm.txt``).

    python -m audiosourcesep_tpu_torch.technique1_ncsnv2 DATA --device cuda

``DATA`` holds ``train/`` and ``test/`` TFRecords (``wav_to_spec
--tfrecords``); the first 2,000 training spectrograms, rescaled to [0, 1]
from [-100, 20] dB, are compared pairwise as blocked Gram products in
float32 on ``--device``, which defaults to ``cuda`` and never falls back
to the CPU. The result is printed and written to ``DATA/max_norm.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .cli import resolve_device
from .data import load_melspec_ds
from .utils import technique1_sigma1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Compute Sigma1 for NCSNv2")
    parser.add_argument("dataset", type=str, help="dirpath of the dataset")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    return parser


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    ds_train, _, _, n_train, _ = load_melspec_ds(
        os.path.join(args.dataset, "train"),
        os.path.join(args.dataset, "test"), batch_size=None)
    print("Data Loaded")
    print(f"Number of spectrograms in training set: {min(n_train, 2000)}")
    sigma1 = technique1_sigma1(ds_train.data, minval=-100.0, maxval=20.0,
                               max_samples=2000, device=device)
    print(f"Max Euclidean Distance: {sigma1}")
    with open(os.path.join(args.dataset, "max_norm.txt"), "w") as f:
        f.write("Max Euclidean Distance between all pairs of samples in "
                f"the training set = {sigma1}")
    return sigma1


if __name__ == "__main__":
    main(sys.argv[1:])
