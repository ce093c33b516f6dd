"""Invert the separated mel spectrograms of a BASIS run back to audio, on
PyTorch.

Port of the repository's ``melspec_inversion_basis.py``, with the same
flags and outputs. It reads ``results.npz`` in ``BASIS_RESULTS`` and
inverts the two sources, the two ground truths and the mixture with
Griffin-Lim or mixture-phase reuse (optionally a single-channel Wiener
filter), all frames of a spectrogram in one batched call. It writes, in
``BASIS_RESULTS/inverse_{algorithm}_{method}[_wiener_filter]/`` (or
``--output``, relative to ``BASIS_RESULTS``): ``sep1.wav sep2.wav gt1.wav
gt2.wav mix.wav``, ``inverse_spectrograms.npz`` (``x1_audio x2_audio
gt1_audio gt2_audio mix_audio``) and ``out.log`` with its
``Inversion duration:`` line.

    python -m audiosourcesep_tpu_torch.melspec_inversion_basis BASIS_DIR \\
        --algorithm reuse_phase --wiener_filter --device cuda

``--device`` defaults to ``cuda`` and never falls back to the CPU.
Griffin-Lim draws its initial phases from one ``torch.Generator`` seeded
with ``--seed``, in the order x1, x2, gt1, gt2, mix.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from .cli import resolve_device
from .data import write_wav
from .ops.inversion import invert_melspec_reuse_phase, mel_to_audio
from .ops.mel import db_to_power

SR = 16000
FMIN, FMAX = 125.0, 7600.0
N_FFT, HOP = 2048, 512


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Spectrograms Inversion")
    parser.add_argument("basis_results", type=str,
                        help="directory of basis_results")
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument("--algorithm", type=str, default="reuse_phase",
                        help="griffin or reuse_phase")
    parser.add_argument("--method", type=str, default="frame",
                        help="frame or whole")
    parser.add_argument("--scale", type=str, default="dB")
    parser.add_argument("--wiener_filter", action="store_true")
    parser.add_argument("--debug", action="store_true",
                        help="print to stdout instead of out.log")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    return parser


def concat_frames(audio_frames: np.ndarray) -> np.ndarray:
    """``[n_frames, T]`` per-frame audio -> the concatenated track."""
    return np.concatenate(list(audio_frames), axis=-1)


def run(args: argparse.Namespace, out_dir: str) -> None:
    device = resolve_device(args.device)
    if args.scale not in ("dB", "power"):
        raise ValueError("scale should be dB or power")
    if args.algorithm not in ("griffin", "reuse_phase"):
        raise ValueError("algorithm should be griffin or reuse_phase")
    res = np.load(os.path.join(args.basis_results, "results.npz"))
    specs = [res[k] for k in ("x1", "x2", "gt1", "gt2", "mixed")]
    stft_mixture = res["stft_mixture"]
    if not specs[0].ndim == specs[1].ndim == stft_mixture.ndim == 3:
        raise ValueError("results.npz should hold [n_frames, n_mels, F] "
                         "spectrograms and a [n_frames, bins, F] STFT")

    print("Spectrograms \n\t " + "".join(f"{k} = {v} \n\t "
                                         for k, v in vars(args).items()))

    if args.method == "whole":
        # one long spectrogram of all frames, inverted as a single frame
        specs = [np.concatenate(list(a), axis=-1)[None] for a in specs]
        stft_mixture = np.concatenate(list(stft_mixture), axis=-1)[None]

    kw = dict(sr=SR, n_fft=N_FFT, hop_length=HOP, fmin=FMIN, fmax=FMAX)
    t_init = time.time()
    if args.algorithm == "griffin":
        gen = torch.Generator(device=device).manual_seed(args.seed)

        def invert(mels):
            mels = torch.as_tensor(mels, device=device)
            if args.scale == "dB":
                mels = db_to_power(mels)
            return mel_to_audio(mels, gen, **kw).cpu().numpy()

        audio = [concat_frames(invert(a)) for a in specs]
    else:
        stft_dev = torch.as_tensor(stft_mixture, device=device)

        def invert(mels, wiener_filter):
            out = invert_melspec_reuse_phase(
                torch.as_tensor(np.stack(mels), device=device), stft_dev,
                scale=args.scale, wiener_filter=wiener_filter, **kw)
            return [concat_frames(a) for a in out.cpu().numpy()]

        audio = (invert(specs[0:2], args.wiener_filter)
                 + invert(specs[2:4], args.wiener_filter)
                 + invert(specs[4:5], False))
    print(f"Inversion duration: {round(time.time() - t_init, 4)} seconds")

    for name, a in zip(("sep1", "sep2", "gt1", "gt2", "mix"), audio):
        write_wav(os.path.join(out_dir, f"{name}.wav"), a, SR)
    np.savez(os.path.join(out_dir, "inverse_spectrograms"),
             **{f"{k}_audio": a for k, a in zip(("x1", "x2", "gt1", "gt2",
                                                  "mix"), audio)})


def main(argv=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the inversion.

    Outputs go to ``BASIS_RESULTS/<output>``; unless ``--debug``, stdout
    is written to ``out.log`` there for the duration of the call.
    """
    args = build_parser().parse_args(argv)
    if args.output is None:
        args.output = f"inverse_{args.algorithm}_{args.method}"
        if args.wiener_filter:
            args.output += "_wiener_filter"
    out_dir = os.path.join(args.basis_results, args.output)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "out.log"), "w") as log_file:
        redirect = (contextlib.nullcontext() if args.debug
                    else contextlib.redirect_stdout(log_file))
        with redirect:
            run(args, out_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
