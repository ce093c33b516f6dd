"""BASIS source separation with two NCSN or two Glow priors, on PyTorch.

Port of the repository's ``run_basis_sep.py``: the same positional
``RESTORE1 RESTORE2`` (JAX-format flat-npz checkpoints or directories of
them; for ``--model_type glow``, ``train_noisy_glow`` output directories
with one ``sigma_{s}/ckpts`` per noise level), the same flags, and the
same outputs in ``--output``:
``results.npz`` (``x1 x2 gt1 gt2 mixed stft_mixture``),
``results_convergence.npz`` (the L+1 per-level states), ``out.log`` and the
``mix.wav`` / ``ground_truth{1,2}.wav`` extracts. ``--inverse`` also
inverts the two separated sources, frames concatenated, to ``sep1.wav`` and
``sep2.wav`` (NNLS + Griffin-Lim on the run's device).

    python -m audiosourcesep_tpu_torch.run_basis_sep CKPT1 CKPT2 \\
        --song_dir SONG --device cuda --compute_dtype bf16 --winograd

``--dataset mnist|cifar10`` separates the mean of two dequantised
``--n_mixed`` image batches (``data.get_mixture_toydata``) instead of a
song: ``results.npz`` then holds 32x32 images rounded to [0, 255] and
``stft_mixture`` is None; no wav is written.

NCSN priors separate the mixture rescaled to ``[0, 1]``; Glow priors,
trained on data-scale inputs, separate it in data scale (uniform init
over ``[minval, maxval]``, outputs only clipped), with the score
``grad_x log p(x)`` taken through each level's flow, ``--score_chunk``
frames at a time.

``--device`` defaults to ``cuda`` and never falls back to the CPU.

Under torchrun (``WORLD_SIZE`` > 1) the separation runs over the ranks,
as the JAX script runs over the devices: by default each rank holds both
priors and its shard of the frames; with ``--shard_sources`` (an even
number of ranks) each rank holds ONE prior (for Glow, one source's chain
of noise levels) and its source's frames, JAX's ``(source, data)`` mesh,
and the mixing gathers the other source's frames each step. Ranks that
share a card use gloo. Rank 0 gathers the result and alone writes the
outputs; ``Duration`` is its wall-clock between barriers.

On one CUDA card each noise level runs as a CUDA graph of one Langevin
step, captured once and replayed ``--T`` times (``separation.graphs``);
``Capture:`` (printed before ``Duration:``) gives the captures' time and
their warm-up steps'. Over several ranks the anneal runs eagerly.

    torchrun --nproc_per_node 2 -m audiosourcesep_tpu_torch.run_basis_sep \
        CKPT1 CKPT2 --song_dir SONG --shard_sources --compute_dtype bf16
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import nn as nn_mod
from .cli import (apply_config_override, describe_multihost, multihost,
                  setup_output_dir)
from .parallel import is_main_process, make_layout, world_size
from .data import get_mixture_toydata, get_song_extract, write_wav
from .models import build_glow
from .models.ncsn import get_score_model, get_sigmas
from .ops.inversion import mel_to_audio
from .ops.mel import db_to_power
from .separation import graphs
from .separation import (BasisConfig, basis_separate_per_level,
                         glow_score_fn, ncsn_score_fn, postprocess,
                         preprocess_mixture, source_sharded_glow_score,
                         source_sharded_ncsn_score)
from .training.checkpoint import restore_ncsn_params

SPEC_PARAMS = {"length_sec": 2.04, "dbmin": -100.0, "dbmax": 20.0,
               "fmin": 125.0, "fmax": 7600.0, "n_fft": 2048,
               "hop_length": 512, "n_mels": 96, "sr": 16000}

# run-level flags a --config YAML never overrides
_KEEP = ("dataset", "output", "debug", "restore", "RESTORE", "song_dir",
         "inverse", "model_type", "n_mixed", "RESTORE1", "RESTORE2",
         "device", "winograd", "compute_dtype")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="BASIS Separation")
    parser.add_argument("RESTORE1", type=str,
                        help="checkpoint (or directory) of model 1")
    parser.add_argument("RESTORE2", type=str,
                        help="checkpoint (or directory) of model 2")
    parser.add_argument("--output", type=str, default="basis_sep")
    parser.add_argument("--debug", action="store_true",
                        help="print to stdout instead of out.log")
    parser.add_argument("--dataset", type=str, default="melspec",
                        help="mnist | cifar10 | melspec")
    parser.add_argument("--song_dir", type=str, default=None,
                        help="dir with mix.wav, piano.wav, violin.wav")
    parser.add_argument("--inverse", action="store_true",
                        help="invert the separated sources to sep1.wav and "
                             "sep2.wav (NNLS + Griffin-Lim)")
    parser.add_argument("--model_type", type=str, default="ncsn",
                        help="ncsn or glow")
    parser.add_argument("--version", type=str, default="v1")
    parser.add_argument("--ema", action="store_true",
                        help="restore the EMA weights of the priors")
    parser.add_argument("--compute_dtype", type=str, default="f32",
                        help="f32 or bf16 (convs in bf16, norm statistics "
                             "in f32)")
    parser.add_argument("--winograd", action="store_true",
                        help="route every 3x3 stride-1 undilated conv with "
                             "even H, W through the hand-written Winograd "
                             "CUDA kernel (its plain version on the CPU)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    parser.add_argument("--shard_sources", action="store_true",
                        help="over an even number of ranks (torchrun): "
                             "each rank holds ONE prior and its source's "
                             "frames (JAX's (source, data) mesh); for "
                             "Glow priors, one source's chain of noise "
                             "levels")
    parser.add_argument("--score_chunk", type=int, default=8,
                        help="Glow priors only: take the score's gradient "
                             "through the flow over this many frames at a "
                             "time (bounds its memory); 0 = all frames")
    parser.add_argument("--n_mixed", type=int, default=30)
    parser.add_argument("--config", type=str)
    parser.add_argument("--seed", type=int, default=0)
    # spectrograms
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--scale", type=str, default="dB")
    # BASIS
    parser.add_argument("--T", type=int, default=100)
    parser.add_argument("--step_lr", type=float, default=2e-5,
                        help="Langevin step size delta (eta = delta * "
                             "(sigma/sigmaL)^2)")
    parser.add_argument("--sigma1", type=float, default=1.0)
    parser.add_argument("--sigmaL", type=float, default=0.01)
    parser.add_argument("--score_clip", type=float, default=None,
                        help="clip per-pixel scores to +-score_clip/sigma; "
                             "off by default")
    parser.add_argument("--num_classes", type=float, default=10)
    parser.add_argument("--progression", type=str, default="geometric")
    # model hyperparameters
    parser.add_argument("--n_filters", type=int, default=192)
    parser.add_argument("--L", type=int, default=3)
    parser.add_argument("--K", type=int, default=32)
    parser.add_argument("--l2_reg", type=float, default=None)
    parser.add_argument("--learntop", action="store_true")
    # optimization (unused at separation time; kept for config compat)
    parser.add_argument("--optimizer", type=str, default="adamax")
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--learning_rate", type=float, default=0.001)
    # preprocessing
    parser.add_argument("--use_logit", action="store_true")
    parser.add_argument("--alpha", type=float, default=1e-6)
    return parser


def _restore_ncsn_models(args, data_shape, sigmas, device, sources):
    """The NCSN priors of ``sources`` (a slice of the two), built on
    ``meta`` and loaded strictly."""
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bf16" else None
    models = []
    for i, path in list(enumerate((args.RESTORE1, args.RESTORE2)))[sources]:
        model = get_score_model(args.version, data_shape, args.n_filters,
                                int(args.num_classes), sigmas=sigmas,
                                logit_transform=args.use_logit,
                                compute_dtype=compute_dtype, device="meta")
        sd = restore_ncsn_params(path, model.state_dict(), ema=args.ema)
        model = model.to_empty(device=device)
        model.load_state_dict(sd)
        if model.sigmas is not None:   # v2: a buffer, not a checkpoint entry
            model.sigmas.copy_(torch.as_tensor(sigmas))
        models.append(model.eval().requires_grad_(False))
        print(f"Model {i + 1} restored from {path}"
              + (" (EMA weights)" if args.ema else ""))
    return models


def _restore_glow(root, sigma, args, data_shape, data_type, minval, maxval,
                  alpha, device):
    """The Glow prior of noise level ``sigma``, built on ``meta`` and
    loaded strictly from the newest checkpoint in
    ``root/sigma_{round(sigma, 2)}/ckpts``; its parameters take no
    gradient (the score differentiates with respect to the input only)."""
    path = os.path.join(root, f"sigma_{round(float(sigma), 2)}", "ckpts")
    model = build_glow(data_shape, L=args.L, K=args.K,
                       n_filters=args.n_filters, learntop=args.learntop,
                       data_type=data_type, use_logit=args.use_logit,
                       alpha=alpha, minval=minval, maxval=maxval,
                       device="meta")
    sd = restore_ncsn_params(path, model.state_dict())
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    print(f"Model at noise level {sigma} restored from {path}")
    return model.eval().requires_grad_(False)


def run(args: argparse.Namespace, device: torch.device) -> None:
    describe_multihost()
    sigmas = get_sigmas(args.sigma1, args.sigmaL, int(args.num_classes),
                        args.progression)
    if args.dataset in ("mnist", "cifar10"):
        data_shape = [32, 32, 1 if args.dataset == "mnist" else 3]
        data_type = "image"
        minval, maxval = 0.0, 256.0
    else:
        if args.song_dir is None:
            raise ValueError("song_dir is None")
        data_shape = [args.height, args.width, 1]
        data_type = "melspec"
        if args.scale == "power":
            minval, maxval = 1e-10, 100.0
        elif args.scale == "dB":
            minval, maxval = -100.0, 20.0
        else:
            raise ValueError("scale should be 'power' or 'dB'")
    alpha = args.alpha or 1e-6
    out_dir = args.output
    # Glow priors are trained on data-scale patches (their preprocessing
    # bijector rescales inside the flow), so they separate in data scale;
    # NCSN priors on [0,1]-rescaled ones
    model_scale = args.model_type == "glow"

    # ---------------- data -------------------------------------------------
    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    spec = dict(SPEC_PARAMS, use_dB=(args.scale == "dB"), n_mels=args.height)
    if data_type == "image":
        mixed, gt1, gt2, _ = get_mixture_toydata(
            args.dataset, args.n_mixed, args.seed,
            generator=torch.Generator().manual_seed(args.seed))
        stft_mixture = None
    else:
        song_dir = os.path.abspath(args.song_dir)
        mel_spec, raw_audio, stft_mixture = get_song_extract(
            os.path.join(song_dir, "mix.wav"),
            os.path.join(song_dir, "piano.wav"),
            os.path.join(song_dir, "violin.wav"),
            spec["length_sec"] * args.n_mixed, **spec, device=device)
        mixed, gt1, gt2 = mel_spec
        for name, audio in zip(("mix.wav", "ground_truth1.wav",
                                "ground_truth2.wav"), raw_audio):
            if is_main_process():
                write_wav(os.path.join(out_dir, name), audio, spec["sr"])
    mixed = torch.as_tensor(mixed, device=device)
    x_init = torch.rand((2, *mixed.shape), generator=gen, device=device)
    if model_scale:
        x_init = x_init * (maxval - minval) + minval
    else:
        mixed = preprocess_mixture(mixed, minval, maxval, args.use_logit,
                                   alpha)
    print(f"Data Loaded in {round(time.time() - t0, 3)} seconds")

    # ---------------- models ----------------------------------------------
    n_ranks = world_size()
    shard_sources = args.shard_sources and n_ranks > 1 and n_ranks % 2 == 0
    if args.shard_sources and not shard_sources:
        print("--shard_sources ignored (needs an even device count > 1)")
    # every rank: its frame shard of both sources, or with --shard_sources
    # JAX's (source, data) layout, one source (and one prior) per rank
    layout = make_layout(2 if shard_sources else 1) if n_ranks > 1 else None
    sources = layout.sources if layout is not None else slice(None)
    nn_mod.set_winograd(args.winograd)
    if model_scale:
        chains = [[_restore_glow(root, sigma, args, data_shape, data_type,
                                 minval, maxval, alpha, device)
                   for root in (args.RESTORE1, args.RESTORE2)[sources]]
                  for sigma in sigmas]
        score_fn = (source_sharded_glow_score if shard_sources
                    else glow_score_fn)(
            chains, *([layout] if shard_sources else []),
            frame_chunk=args.score_chunk or None)
    else:
        models = _restore_ncsn_models(args, data_shape, sigmas, device,
                                      sources)
        score_fn = (source_sharded_ncsn_score(models, layout)
                    if shard_sources else ncsn_score_fn(models))
    print("Parameters \n\t " + "".join(f"{k} = {v} \n\t "
                                       for k, v in vars(args).items()))

    # ---------------- separation ------------------------------------------
    cfg = BasisConfig(T=args.T, delta=args.step_lr, data_type=data_type,
                      scale=args.scale, collect_trajectory=True,
                      score_clip=args.score_clip)

    def progress(level, x):
        print(f"Sigma = {sigmas[level]} ({level + 1} / {len(sigmas)}) done")

    if layout is not None:
        print(f"Layout: rank {layout.rank} of {layout.world_size} holds "
              f"source(s) {list(range(2))[sources]}, frame shard "
              f"{layout.data_index} of {layout.data_size}")
        dist.barrier()
    t0 = time.time()
    with graphs.recording() as record:
        x_final, traj = basis_separate_per_level(
            score_fn, mixed, x_init, sigmas, gen, cfg, callback=progress,
            layout=layout)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if layout is not None:
        dist.barrier()
    graphs.print_capture(record)
    print(f"Duration: {round(time.time() - t0, 3)} seconds")
    if not is_main_process():
        return      # rank 0 holds the gathered result and writes it

    # ---------------- save results ----------------------------------------
    def post(x):
        return postprocess(x, minval, maxval, args.use_logit, alpha,
                           data_type, rescale=not model_scale).cpu().numpy()

    def squeeze_ch(a):
        # drop only the trailing channel axis (a plain squeeze would also
        # drop a singleton frame axis)
        return a[..., 0] if a.shape[-1] == 1 else a

    x1_out = post(squeeze_ch(x_final[0]))
    x2_out = post(squeeze_ch(x_final[1]))
    np.savez(os.path.join(out_dir, "results"), x1=x1_out, x2=x2_out,
             gt1=squeeze_ch(gt1), gt2=squeeze_ch(gt2),
             mixed=post(squeeze_ch(mixed)), stft_mixture=stft_mixture)
    np.savez(os.path.join(out_dir, "results_convergence"),
             x1=post(traj[:, 0]), x2=post(traj[:, 1]))

    if args.inverse and data_type == "melspec":
        t0 = time.time()
        # the separated frames concatenated along time, as one spectrogram
        mels = torch.as_tensor(np.stack([np.concatenate(list(x), axis=-1)
                                         for x in (x1_out, x2_out)]),
                               device=device)
        if args.scale == "dB":
            mels = db_to_power(mels)
        audio = mel_to_audio(
            mels, gen, sr=spec["sr"], n_fft=spec["n_fft"],
            hop_length=spec["hop_length"], fmin=spec["fmin"],
            fmax=spec["fmax"]).cpu().numpy()
        print(f"Inversion duration: {round(time.time() - t0, 3)} seconds")
        write_wav(os.path.join(out_dir, "sep1.wav"), audio[0], spec["sr"])
        write_wav(os.path.join(out_dir, "sep2.wav"), audio[1], spec["sr"])


def main(argv=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the separation.

    Outputs go to ``--output``; unless ``--debug``, stdout is written to
    ``out.log`` there (``out_rank{r}.log`` on rank ``r > 0``) for the
    duration of the call. With ``WORLD_SIZE`` > 1 in the environment
    (torchrun) it joins the process group first and leaves it at the end.
    """
    args = build_parser().parse_args(argv)
    args.RESTORE1 = os.path.abspath(args.RESTORE1)
    args.RESTORE2 = os.path.abspath(args.RESTORE2)
    args = apply_config_override(args, _KEEP)
    # as the JAX script uses every device: every rank torchrun started
    args.multihost = int(os.environ.get("WORLD_SIZE", "1")) > 1
    winograd_was = nn_mod.winograd_enabled()
    try:
        with multihost(args) as device, \
                setup_output_dir(args.output, args.debug):
            run(args, device)
    finally:
        nn_mod.set_winograd(winograd_was)


if __name__ == "__main__":
    main(sys.argv[1:])
