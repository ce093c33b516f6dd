"""Generate samples from a trained NCSN by annealed Langevin dynamics, on PyTorch.

Port of the repository's ``ncsn_generate_samples.py`` (reference
ncsn_generate_samples.py:24-117): restore the prior from ``RESTORE`` (a
JAX-layout checkpoint or a directory of them; ``--ema`` takes the EMA
weights), anneal ``--n_samples`` uniform draws over the sigma schedule,
map them back to the data scale, and write ``generated_samples.npy``
(``[n, H, W, C]``, or the ``[L+1, n, H, W, C]`` trajectory with
``--return_arr``) and ``out.log`` in ``--output``. ``--dataset melspec``
samples ``[--height, --width, 1]`` patches in the ``--scale`` range,
``mnist`` ``[32, 32, 1]`` and ``cifar10`` ``[32, 32, 3]`` images in the
[0, 1] scale they were trained in.

    python -m audiosourcesep_tpu_torch.ncsn_generate_samples CKPT_DIR \\
        --ema --T 100 --device cuda

``--device`` defaults to ``cuda`` and never falls back to the CPU. On
the card each level runs as a CUDA graph of one Langevin step, replayed
``--T`` times; ``Capture:`` and ``Duration:`` in ``out.log`` time the
captures and the whole sampler.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import cli
from .models.ncsn import (anneal_langevin_dynamics, get_score_model,
                          get_sigmas)
from .separation import graphs
from .training.checkpoint import restore_ncsn_params


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Generate NCSN samples")
    parser.add_argument("RESTORE", type=str, help="saved model directory")
    parser.add_argument("--output", type=str, default="ncsn_samples")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--config", type=str)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    parser.add_argument("--dataset", type=str, default="melspec",
                        help="melspec | mnist | cifar10")
    parser.add_argument("--version", type=str, default="v1")
    parser.add_argument("--ema", action="store_true",
                        help="restore EMA weights (reference "
                             "ncsn_generate_samples.py:88-89,142)")
    parser.add_argument("--n_samples", type=int, default=32)
    parser.add_argument("--return_arr", action="store_true",
                        help="save the full per-level trajectory")
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--scale", type=str, default="dB")
    parser.add_argument("--n_filters", type=int, default=192)
    parser.add_argument("--sigma1", type=float, default=1.0)
    parser.add_argument("--sigmaL", type=float, default=0.01)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--progression", type=str, default="logarithmic")
    parser.add_argument("--T", type=int, default=100)
    parser.add_argument("--step_lr", type=float, default=2e-5)
    parser.add_argument("--use_logit", action="store_true")
    parser.add_argument("--alpha", type=float, default=None)
    return parser


def run(args: argparse.Namespace) -> None:
    device = cli.resolve_device(args.device)
    data_shape = {"mnist": [32, 32, 1], "cifar10": [32, 32, 3]}.get(
        args.dataset, [args.height, args.width, 1])
    sigmas = get_sigmas(args.sigma1, args.sigmaL, args.num_classes,
                        args.progression)
    model = get_score_model(args.version, data_shape, args.n_filters,
                            args.num_classes, sigmas=sigmas,
                            logit_transform=args.use_logit, device="meta")
    sd = restore_ncsn_params(args.RESTORE, model.state_dict(), ema=args.ema)
    model = model.to_empty(device=device)
    model.load_state_dict(sd)
    if model.sigmas is not None:   # v2: a buffer, not a checkpoint entry
        model.sigmas.copy_(torch.as_tensor(sigmas))
    model.eval().requires_grad_(False)
    if args.ema:
        print(f"Restored EMA weights from {args.RESTORE}")
    cli.print_params(args)

    alpha = args.alpha or 1e-6
    generator = torch.Generator(device=device).manual_seed(args.seed)
    x_mod = torch.rand((args.n_samples, *data_shape), generator=generator,
                       device=device)
    if args.use_logit:
        x_mod = (1.0 - 2 * alpha) * x_mod + alpha
        x_mod = torch.log(x_mod) - torch.log1p(-x_mod)
    t0 = time.time()
    with graphs.recording() as record:
        samples = anneal_langevin_dynamics(
            model, x_mod, sigmas, generator, n_steps_each=args.T,
            step_lr=args.step_lr, return_arr=args.return_arr).cpu().numpy()
    graphs.print_capture(record)
    print(f"Duration: {round(time.time() - t0, 3)} seconds")

    # back to the data scale (run_basis_sep.py:82-96)
    if args.use_logit:
        samples = 1.0 / (1.0 + np.exp(-samples))
        samples = (samples - alpha) / (1.0 - 2.0 * alpha)
    if args.dataset == "melspec":
        minval, maxval = (-100.0, 20.0) if args.scale == "dB" \
            else (1e-10, 100.0)
        samples = samples * (maxval - minval) + minval
        samples = np.clip(samples, minval, maxval)
    np.save(os.path.join(args.output, "generated_samples"), samples)
    print(f"Saved {args.n_samples} samples to generated_samples.npy "
          f"(shape {samples.shape})")


def main(argv=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and sample. Outputs go to
    ``--output``; unless ``--debug``, stdout is written to ``out.log``
    there for the duration of the call."""
    args = build_parser().parse_args(argv)
    args.RESTORE = os.path.abspath(args.RESTORE)
    args = cli.apply_config_override(args)
    with cli.setup_output_dir(args.output, args.debug):
        run(args)


if __name__ == "__main__":
    main(sys.argv[1:])
