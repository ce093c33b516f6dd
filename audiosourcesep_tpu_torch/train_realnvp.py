"""Train RealNVP on MNIST or CIFAR-10, on PyTorch.

Port of the repository's ``train_realnvp.py`` (reference
train_realnvp.py:22-65, with checkpoints): the same flags, data-dependent
init, the optimizer (adam by default), validation, and the same outputs
in ``--output``: ``ckpts/`` (JAX-layout train-state checkpoints that the
JAX package restores, and the reverse), ``ckpts_issues/``,
``tensorboard_logs/`` and ``out.log``, which ends with ``Validation
bits/dim`` of the first test batch. ``--dataset`` is ``mnist`` or
``cifar10`` (``data.load_toydata``: a local npz, nothing is downloaded).

    python -m audiosourcesep_tpu_torch.train_realnvp --dataset mnist \\
        --learntop --device cuda

``--device`` defaults to ``cuda`` and never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from . import cli
from .models import build_realnvp
from .training import (LoopConfig, init_train_state, make_flow_train_step,
                       run_training, setup_optimizer, setup_tensorboard)
from .utils import total_trainable_variables


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train RealNVP")
    parser.add_argument("--dataset", type=str, default="mnist",
                        help="mnist | cifar10")
    parser.add_argument("--output", type=str, default="trained_realnvp")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    parser.add_argument("--n_filters", type=int, default=32)
    parser.add_argument("--n_blocks", type=int, default=4)
    parser.add_argument("--learntop", action="store_true")
    parser.add_argument("--n_epochs", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--optimizer", type=str, default="adam")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    return parser


def run(args: argparse.Namespace) -> None:
    device = cli.resolve_device(args.device)
    data = cli.resolve_dataset(args)
    train_writer, test_writer = setup_tensorboard(
        os.path.join(args.output, "tensorboard_logs"))
    model = build_realnvp(
        data["data_shape"], n_filters=args.n_filters,
        n_blocks=args.n_blocks, learntop=args.learntop,
        minibatch=torch.as_tensor(data["minibatch"], device=device),
        generator=torch.Generator().manual_seed(args.seed), device=device)
    print(f"Total Trainable Variables: "
          f"{total_trainable_variables(model):,}")
    state = init_train_state(model, setup_optimizer(args.optimizer,
                                                    args.learning_rate))
    step, eval_loss = make_flow_train_step()

    cli.print_params(args, train_writer)
    cfg = LoopConfig(n_epochs=args.n_epochs, batch_size=args.batch_size,
                     output_dir=args.output)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    run_training(state, step, eval_loss, data["ds_train"], data["ds_test"],
                 cfg, generator, train_writer=train_writer,
                 test_writer=test_writer)
    # bits/dim of the first validation batch (thesis Table 3.1's metric)
    batch = next(iter(data["ds_test"]))
    x = torch.as_tensor(batch, dtype=torch.float32, device=device)
    dequant = model.draw_noise(x.shape, torch.Generator(
        device=device).manual_seed(1), device)
    with torch.no_grad():
        bpd = float(model.bits_per_dim(x, dequant).mean())
    print(f"Validation bits/dim: {bpd:.4f}")
    train_writer.close()
    test_writer.close()


def main(argv=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and train. Outputs go to
    ``--output``; unless ``--debug``, stdout is written to ``out.log``
    there for the duration of the call."""
    args = build_parser().parse_args(argv)
    with cli.setup_output_dir(args.output, args.debug):
        run(args)


if __name__ == "__main__":
    main(sys.argv[1:])
