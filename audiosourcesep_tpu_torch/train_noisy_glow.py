"""Fine-tune a trained Glow at each noise level, on PyTorch.

Port of the repository's ``train_noisy_glow.py`` (reference
train_noisy_glow.py:187-360): restores the clean model from ``RESTORE``
(a ``train_glow`` output directory), then for each sigma of the schedule
fine-tunes on ``X + sigma * eps`` and saves under
``--output/sigma_{round(sigma, 2)}/ckpts``, the layout ``run_basis_sep
--model_type glow`` reads. The noise draws are the JAX package's numpy
draws, so the chain's batches equal its batches bit for bit.

    python -m audiosourcesep_tpu_torch.train_noisy_glow RESTORE \\
        --dataset DATA --config configs/melspec_noisy_glow.yml --device cuda

``--dataset`` is a melspec TFRecord directory or ``mnist`` /
``cifar10``. ``--device`` defaults to ``cuda`` and never falls back to
the CPU. ``--multihost`` fine-tunes data-parallel, one rank per process,
as ``train_ncsn --multihost`` does.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from . import cli
from .models.ncsn import get_sigmas
from .parallel import make_mesh_for_batch
from .train_glow import add_glow_flags, build_model
from .training import train_noisy_glow_chain


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train noisy Glow chain")
    parser.add_argument("RESTORE", type=str, nargs="?", default=None,
                        help="directory of the trained clean Glow model")
    parser.add_argument("--dataset", type=str, default="mnist",
                        help="mnist | cifar10 | a melspec dataset "
                             "directory (train/ and test/ TFRecords)")
    parser.add_argument("--output", type=str, default="trained_noisy_glow")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--config", type=str)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    add_glow_flags(parser)
    # sigma schedule
    parser.add_argument("--sigma1", type=float, default=1.0)
    parser.add_argument("--sigmaL", type=float, default=0.01)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--progression", type=str, default="logarithmic")
    # optimization (per sigma level)
    parser.add_argument("--n_epochs", type=int, default=20)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--optimizer", type=str, default="adamax")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--clipnorm", type=float, default=None,
                        help="optional global-norm gradient clip")
    parser.add_argument("--reinit_actnorm", action="store_true",
                        help="re-anchor ActNorm data-dependent stats on a "
                             "sigma-noised minibatch before each level's "
                             "fine-tune")
    cli.add_multihost_flags(parser)
    return parser


def run(args: argparse.Namespace, device: torch.device) -> None:
    cli.describe_multihost()
    data = cli.resolve_dataset(args)
    sigmas = get_sigmas(args.sigma1, args.sigmaL, args.num_classes,
                        args.progression)
    cli.print_params(args)
    model = build_model(args, data, device)
    dirs = train_noisy_glow_chain(
        model, sigmas, data["ds_train"], data["ds_test"],
        optimizer_name=args.optimizer, learning_rate=args.learning_rate,
        clipnorm=getattr(args, "clipnorm", None),
        n_epochs_per_sigma=args.n_epochs, batch_size=args.batch_size,
        output_dir=args.output,
        restore_path=(os.path.join(args.RESTORE, "ckpts")
                      if args.RESTORE else None),
        generator=torch.Generator(device=device).manual_seed(args.seed),
        reinit_actnorm=getattr(args, "reinit_actnorm", False),
        reinit_minibatch=data["minibatch"],
        layout=make_mesh_for_batch(args.batch_size))
    print(f"Noise-conditioned checkpoints: {dirs}")


def main(argv=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and run the chain.
    Outputs go to ``--output``; unless ``--debug``, stdout is written to
    ``out.log`` there for the duration of the call."""
    args = build_parser().parse_args(argv)
    if args.RESTORE:
        args.RESTORE = os.path.abspath(args.RESTORE)
    args = cli.apply_config_override(args)
    with cli.multihost(args) as device:
        with cli.setup_output_dir(args.output, args.debug):
            run(args, device)


if __name__ == "__main__":
    main(sys.argv[1:])
