"""wav -> mel-spectrogram dataset, on PyTorch.

Port of the repository's ``wav_to_spec.py`` (reference
datasets/wav_to_spec.py:76-105): the same flags and defaults, the same
output layout (one ``<name>.tfrecord`` per wav with ``--tfrecords``, else
``<name>_<i>.npy`` per window) and ``out.log``. The windows of a file go
through one batched mel computation on ``--device``.

    python -m audiosourcesep_tpu_torch.wav_to_spec WAV_DIR OUT_DIR \\
        --use_dB --tfrecords --device cuda

``--device`` defaults to ``cuda`` and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import time

import numpy as np
import torch

from .cli import resolve_device
from .data import load_wav, save_tf_records
from .ops.spectrogram import melspectrogram, melspectrogram_tf_signal


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Compute Mel spectrograms and save them")
    parser.add_argument("INPUT", type=str,
                        help="input dirpath of the wav files")
    parser.add_argument("OUTPUT", type=str,
                        help="output dirpath for saving the spectrograms")
    parser.add_argument("--length_sec", type=float, default=2.04)
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--n_fft", type=int, default=2048)
    parser.add_argument("--hop_length", type=int, default=512)
    parser.add_argument("--n_mels", type=int, default=96)
    parser.add_argument("--fmin", type=int, default=125)
    parser.add_argument("--fmax", type=int, default=7600)
    parser.add_argument("--dbmin", type=int, default=-100)
    parser.add_argument("--dbmax", type=int, default=20)
    parser.add_argument("--use_dB", action="store_true")
    parser.add_argument("--use_signal", action="store_true")
    parser.add_argument("--overlap", type=float, default=0.0,
                        help="fractional window overlap in [0, 1) for data "
                             "augmentation (reference uses 0)")
    parser.add_argument("--tfrecords", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    return parser


def run(args: argparse.Namespace) -> None:
    device = resolve_device(args.device)
    t0 = time.time()
    input_dirpath = os.path.abspath(args.INPUT)
    output_dirpath = os.path.abspath(args.OUTPUT)
    os.makedirs(output_dirpath, exist_ok=True)

    with open(os.path.join(output_dirpath, "out.log"), "w") as logfile:
        template = "".join(f"{k} = {v} \n\t " for k, v in vars(args).items())
        print(template)
        logfile.write(template)

        wav_files = []
        for root, _, files in os.walk(input_dirpath):
            wav_files += [os.path.join(root, f) for f in files
                          if re.match(r".*\.wav$", f)]

        hop_sec = (args.length_sec * (1.0 - args.overlap)
                   if args.overlap > 0 else None)
        for wav_file in sorted(wav_files):
            windows, rate = load_wav(wav_file, args.length_sec, sr=args.sr,
                                     hop_sec=hop_sec)
            print(f"{wav_file} Loaded...")
            windows = torch.as_tensor(windows, device=device)
            if args.use_signal:
                specs = melspectrogram_tf_signal(
                    windows, sr=rate, frame_length=int(rate * args.length_sec),
                    n_fft=args.n_fft, hop_length=args.hop_length,
                    n_mels=args.n_mels)
                print("\t Mel Spectrograms computed using tf.signal semantics")
            else:
                specs = melspectrogram(
                    windows, sr=rate, n_fft=args.n_fft,
                    hop_length=args.hop_length, n_mels=args.n_mels,
                    fmin=args.fmin, fmax=args.fmax, dbmin=args.dbmin,
                    dbmax=args.dbmax, use_dB=args.use_dB)
                print("\t Mel Spectrograms computed using librosa semantics")
            specs = specs.cpu().numpy()

            filename = os.path.join(output_dirpath,
                                    os.path.split(wav_file)[1])[:-4]
            if args.tfrecords:
                save_tf_records(list(specs), filename)
                print(f"\t Saved as tfrecords at {filename}")
            else:
                for i, s in enumerate(specs):
                    np.save(f"{filename}_{i}", s)
                print(f"\tSaved into {len(specs)} spectrograms as npy")

        deltaT = np.round(time.time() - t0, 2)
        msg = (f"{len(wav_files)} wav files saved as spectrograms in "
               f"{deltaT} seconds.")
        print("-" * 40)
        print(msg)
        logfile.write(msg)


def main(argv=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and write the dataset."""
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
