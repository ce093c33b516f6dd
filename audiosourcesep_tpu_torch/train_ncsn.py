"""Train an NCSN score network with denoising score matching, on PyTorch.

Port of the repository's ``train_ncsn.py`` (reference
train_ncsn.py:182-371): the same flags, sigma schedule, ``--ema`` (decay
0.999), periodic Langevin snapshots and ``--restore``, and the same
outputs in ``--output``: ``ckpts/`` (JAX-layout train-state checkpoints
that the JAX package restores, and the reverse), ``ckpts_issues/``,
``generated_samples/generated_samples_{epoch}.npy``,
``tensorboard_logs/`` and ``out.log``. ``--dataset`` is a directory with
``train/`` and ``test/`` TFRecords (``wav_to_spec --tfrecords``), or
``mnist`` / ``cifar10`` (``data.load_toydata``: 32x32 images from a local
npz, rescaled to [0, 1] for training like the spectrograms).

    python -m audiosourcesep_tpu_torch.train_ncsn --dataset DATA \\
        --config configs/melspec_ncsnv1.yml --ema --device cuda

``--device`` defaults to ``cuda`` and never falls back to the CPU. A
``--config`` YAML overlays the flags: the keys it names replace them, the
others (``seed``, ``sample_every``, ...) keep their values.

``--multihost`` trains data-parallel, one rank per process
(``cli.multihost``): each rank takes its shard of the data and its slice
of the global ``--batch_size``, the gradients are averaged over the ranks
each step, and only rank 0 writes checkpoints, samples and ``out.log``::

    torchrun --nproc_per_node 4 -m audiosourcesep_tpu_torch.train_ncsn \
        --dataset DATA --multihost --ema
    python -m audiosourcesep_tpu_torch.train_ncsn --dataset DATA \
        --multihost --coordinator_address HOST:PORT --num_processes 2 \
        --process_id 0          # and 1 in a second process
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch

from . import cli
from .parallel import is_main_process, make_mesh_for_batch
from .models.ncsn import (anneal_langevin_dynamics, get_score_model,
                          get_sigmas)
from .training import (CheckpointManager, LoopConfig, NullWriter,
                       image_grid, init_train_state, make_ncsn_train_step,
                       plot_to_image, run_training, setup_optimizer,
                       setup_tensorboard)
from .utils import total_trainable_variables


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train NCSN")
    parser.add_argument("--dataset", type=str, default="mnist",
                        help="mnist | cifar10 | a melspec dataset "
                             "directory (train/ and test/ TFRecords)")
    parser.add_argument("--output", type=str, default="trained_ncsn")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--restore", type=str, default=None)
    parser.add_argument("--config", type=str)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    # model
    parser.add_argument("--version", type=str, default="v1")
    parser.add_argument("--ema", action="store_true")
    parser.add_argument("--n_filters", type=int, default=192)
    # spectrograms
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--scale", type=str, default="dB")
    # sigma schedule
    parser.add_argument("--sigma1", type=float, default=1.0)
    parser.add_argument("--sigmaL", type=float, default=0.01)
    parser.add_argument("--num_classes", type=int, default=10)
    parser.add_argument("--progression", type=str, default="logarithmic")
    # langevin
    parser.add_argument("--T", type=int, default=100)
    parser.add_argument("--sample_every", type=int, default=50,
                        help="epochs between Langevin sampling snapshots "
                             "(reference: every 50, train_ncsn.py:150)")
    parser.add_argument("--step_lr", type=float, default=2e-5)
    # optimization
    parser.add_argument("--n_epochs", type=int, default=400)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--optimizer", type=str, default="adam")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--clipnorm", type=float, default=None,
                        help="optional global-norm gradient clip")
    # preprocessing
    parser.add_argument("--use_logit", action="store_true")
    parser.add_argument("--alpha", type=float, default=None)
    cli.add_multihost_flags(parser)
    return parser


def preprocess(X, minval, maxval, use_logit, alpha):
    """Rescale to [0,1] (+ optional logit) — train_ncsn.py:287-292."""
    X = (X - minval) / (maxval - minval)
    if use_logit:
        X = X * (1.0 - 2 * alpha) + alpha
        X = np.log(X) - np.log1p(-X)
    return X.astype(np.float32)


def output_name(args) -> str:
    """``--output``, or for the default the JAX script's run name."""
    if args.output != "trained_ncsn":
        return args.output
    return (f"ncsn{args.version}_{args.dataset.replace('/', '_')}"
            f"_{args.n_filters}_{args.batch_size}"
            f"_{getattr(args, 'scale', 'img')}")


def run(args: argparse.Namespace, device: torch.device) -> None:
    cli.describe_multihost()
    out = args.output
    data = cli.resolve_dataset(args)
    sigmas = get_sigmas(args.sigma1, args.sigmaL, args.num_classes,
                        args.progression)
    samples_dir = os.path.join(out, "generated_samples")
    os.makedirs(samples_dir, exist_ok=True)
    is_main = is_main_process()
    train_writer, test_writer = (setup_tensorboard(
        os.path.join(out, "tensorboard_logs")) if is_main
        else (NullWriter(), NullWriter()))

    alpha = args.alpha or 1e-6
    for split in ("ds_train", "ds_test"):
        data[split].data = preprocess(data[split].data, data["minval"],
                                      data["maxval"], args.use_logit, alpha)

    model = get_score_model(args.version, data["data_shape"], args.n_filters,
                            args.num_classes, sigmas=sigmas,
                            logit_transform=args.use_logit, device=device)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    print(f"Total Trainable Variables: "
          f"{total_trainable_variables(model):,}")

    optimizer = setup_optimizer(args.optimizer, args.learning_rate,
                                clipnorm=getattr(args, "clipnorm", None))
    state = init_train_state(model, optimizer, ema=args.ema)
    step, eval_loss = make_ncsn_train_step(
        sigmas, ema_decay=0.999 if args.ema else None,
        layout=make_mesh_for_batch(args.batch_size))

    if args.restore is not None:
        mgr = CheckpointManager(os.path.join(args.restore, "ckpts"))
        tree, restored_step = mgr.restore_latest(state.tree())
        state.load_tree(tree)
        print(f"Model restored from {args.restore} at step {restored_step}")

    # the figures need TensorBoard, matplotlib and PIL, which a machine may
    # lack; the samples are saved either way
    draw = not isinstance(train_writer, NullWriter) and all(
        importlib.util.find_spec(m) for m in ("matplotlib", "PIL"))

    def sample_fn(state, epoch, generator):
        x_mod = torch.rand((32, *data["data_shape"]), generator=generator,
                           device=device)
        if args.use_logit:
            x_mod = (1.0 - 2 * alpha) * x_mod + alpha
            x_mod = torch.log(x_mod) - torch.log1p(-x_mod)
        score_fn = state.model
        if state.ema_params is not None:
            def score_fn(x, idx):
                return torch.func.functional_call(state.model,
                                                  state.ema_params, (x, idx))
        samples = anneal_langevin_dynamics(
            score_fn, x_mod, sigmas, generator, n_steps_each=args.T,
            step_lr=args.step_lr, return_arr=True).cpu().numpy()
        # every rank samples (its generator stays in step with its peers')
        # and rank 0 writes
        if not is_main:
            return
        np.save(os.path.join(samples_dir, f"generated_samples_{epoch}"),
                samples)
        if not draw:
            return
        if np.isfinite(samples[-1]).all():
            fig = image_grid(samples[-1], data["data_shape"],
                             data["data_type"])
            train_writer.add_image("32 generated samples",
                                   plot_to_image(fig), epoch,
                                   dataformats="HWC")
        else:
            train_writer.add_text(
                "display error",
                "Impossible to display spectrograms because of NaN values",
                epoch)

    cli.print_params(args, train_writer)
    cfg = LoopConfig(n_epochs=args.n_epochs, batch_size=args.batch_size,
                     losses_per_epoch=5, val_every_epochs=10,
                     sample_every_epochs=args.sample_every, output_dir=out)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    result = run_training(state, step, eval_loss, data["ds_train"],
                          data["ds_test"], cfg, generator,
                          sample_fn=sample_fn, train_writer=train_writer,
                          test_writer=test_writer)
    print(f"Training time: {result.training_time:.1f}s; "
          f"saved at {result.save_path}")
    train_writer.close()
    test_writer.close()


def main(argv=None) -> None:
    """Parse ``argv`` (default ``sys.argv[1:]``) and train. Outputs go to
    ``--output``; unless ``--debug``, stdout is written to ``out.log``
    there for the duration of the call."""
    args = cli.apply_config_override(build_parser().parse_args(argv))
    args.output = output_name(args)
    with cli.multihost(args) as device:
        with cli.setup_output_dir(args.output, args.debug):
            run(args, device)


if __name__ == "__main__":
    main(sys.argv[1:])
