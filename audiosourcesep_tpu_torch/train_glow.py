"""Train a Glow normalizing flow on mel-spectrogram patches, on PyTorch.

Port of the repository's ``train_glow.py`` (reference
train_glow.py:349-399): the same flags, data-dependent init, adamax,
samples every ``n_epochs // 10`` epochs, validation, ``--restore``, and
the same outputs in ``--output``: ``ckpts/`` (JAX-layout train-state
checkpoints that the JAX package restores, and the reverse),
``ckpts_issues/``, ``generated_samples/generated_samples_{epoch}.npy``,
``tensorboard_logs/`` and ``out.log``, which ends with the test set's
``Validation bits/dim`` (and, for mel spectrograms, the bits per pixel
of the ``[0, 1]``-rescaled variable). ``--dataset`` is a directory with
``train/`` and ``test/`` TFRecords (``wav_to_spec --tfrecords``), or
``mnist`` / ``cifar10`` (32x32 images in [0, 256), dequantised by the
flow's ``ImgPreprocessing``).

    python -m audiosourcesep_tpu_torch.train_glow --dataset DATA \\
        --config configs/melspec_glow.yml --device cuda

``--device`` defaults to ``cuda`` and never falls back to the CPU. A
``--config`` YAML overlays the flags. ``--multihost`` trains
data-parallel, one rank per process, as ``train_ncsn --multihost`` does
(the bits/dim is averaged over the ranks' test shards).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from . import cli
from .models import build_glow
from .parallel import is_main_process, make_mesh_for_batch
from .training import (CheckpointManager, LoopConfig, NullWriter,
                       image_grid, init_train_state, make_flow_train_step,
                       plot_to_image, run_training, setup_optimizer,
                       setup_tensorboard)
from .utils import total_trainable_variables


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train Glow")
    parser.add_argument("--dataset", type=str, default="mnist",
                        help="mnist | cifar10 | a melspec dataset "
                             "directory (train/ and test/ TFRecords)")
    parser.add_argument("--output", type=str, default="trained_flow")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--restore", type=str, default=None,
                        help="directory of a saved model to restore")
    parser.add_argument("--config", type=str,
                        help="YAML config overriding the hyperparameters")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; cuda raises when no GPU is "
                             "present")
    add_glow_flags(parser)
    parser.add_argument("--l2_reg", type=float, default=None)
    # optimization
    parser.add_argument("--n_epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--optimizer", type=str, default="adamax")
    parser.add_argument("--learning_rate", type=float, default=0.001)
    parser.add_argument("--clipnorm", type=float, default=None,
                        help="optional global-norm gradient clip")
    cli.add_multihost_flags(parser)
    return parser


def add_glow_flags(parser: argparse.ArgumentParser) -> None:
    """The spectrogram, model and preprocessing flags of both Glow
    training CLIs."""
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--scale", type=str, default="dB")
    parser.add_argument("--L", type=int, default=3)
    parser.add_argument("--K", type=int, default=32)
    parser.add_argument("--n_filters", type=int, default=512)
    parser.add_argument("--learntop", action="store_true")
    parser.add_argument("--use_logit", action="store_true")
    parser.add_argument("--alpha", type=float, default=None)


def build_model(args, data: dict, device: torch.device):
    """The Glow of ``args`` on ``device``, initialised from the dataset's
    minibatch and ``--seed``; prints its parameter count."""
    model = build_glow(
        data["data_shape"], L=args.L, K=args.K, n_filters=args.n_filters,
        learntop=args.learntop, data_type=data["data_type"],
        use_logit=args.use_logit, alpha=args.alpha or 1e-6,
        minval=data["minval"], maxval=data["maxval"],
        minibatch=torch.as_tensor(data["minibatch"], device=device),
        generator=torch.Generator().manual_seed(args.seed), device=device)
    print(f"Total Trainable Variables: "
          f"{total_trainable_variables(model):,}")
    return model


def output_name(args) -> str:
    """``--output``, or for the default the JAX script's run name."""
    if args.output != "trained_flow":
        return args.output
    return (f"glow_{args.dataset.replace('/', '_')}_L{args.L}_K{args.K}"
            f"_{args.n_filters}_{getattr(args, 'scale', 'img')}")


def run(args: argparse.Namespace, device: torch.device) -> None:
    cli.describe_multihost()
    out = args.output
    data = cli.resolve_dataset(args)
    samples_dir = os.path.join(out, "generated_samples")
    os.makedirs(samples_dir, exist_ok=True)
    is_main = is_main_process()
    train_writer, test_writer = (setup_tensorboard(
        os.path.join(out, "tensorboard_logs")) if is_main
        else (NullWriter(), NullWriter()))

    model = build_model(args, data, device)
    optimizer = setup_optimizer(args.optimizer, args.learning_rate,
                                clipnorm=getattr(args, "clipnorm", None))
    state = init_train_state(model, optimizer)
    layout = make_mesh_for_batch(args.batch_size)
    step, eval_loss = make_flow_train_step(layout=layout)

    if args.restore is not None:
        mgr = CheckpointManager(os.path.join(args.restore, "ckpts"))
        tree, restored_step = mgr.restore_latest(state.tree())
        if restored_step <= 0:
            raise ValueError(f"{args.restore} holds a checkpoint of step "
                             f"{restored_step}, not a trained model")
        state.load_tree(tree)
        print(f"Model restored from {args.restore} at step {restored_step}")

    draw = not isinstance(train_writer, NullWriter) and all(
        importlib.util.find_spec(m) for m in ("matplotlib", "PIL"))

    @torch.no_grad()
    def sample_fn(state, epoch, generator):
        z = model.prior.sample(32, generator, device=device)
        samples = model.sample(z).reshape(32, *data["data_shape"])
        samples = torch.clamp(samples, data["minval"], data["maxval"])
        samples = samples.cpu().numpy()
        # every rank samples (its generator stays in step with its peers')
        # and rank 0 writes
        if not is_main:
            return
        np.save(os.path.join(samples_dir, f"generated_samples_{epoch}"),
                samples)
        if draw:
            fig = image_grid(samples, data["data_shape"], data["data_type"])
            train_writer.add_image("32 generated samples",
                                   plot_to_image(fig), epoch,
                                   dataformats="HWC")

    cli.print_params(args, train_writer)
    cfg = LoopConfig(n_epochs=args.n_epochs, batch_size=args.batch_size,
                     val_every_epochs=max(args.n_epochs // 100, 1),
                     sample_every_epochs=max(args.n_epochs // 10, 1),
                     output_dir=out)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    result = run_training(state, step, eval_loss, data["ds_train"],
                          data["ds_test"], cfg, generator,
                          sample_fn=sample_fn, train_writer=train_writer,
                          test_writer=test_writer)
    print(f"Training time: {result.training_time:.1f}s; "
          f"saved at {result.save_path}")
    # bits/dim (bits per pixel for mel spectrograms) on the test set
    gen_eval = torch.Generator(device=device).manual_seed(123)
    bpds = []
    with torch.no_grad():
        for batch in data["ds_test"]:
            x = torch.as_tensor(batch, dtype=torch.float32, device=device)
            dequant = torch.rand(x.shape, generator=gen_eval, device=device)
            bpds.append(float(model.bits_per_dim(x, dequant).mean()))
    if bpds:
        bits_raw = float(np.mean(bpds))
        if layout is not None:
            # every rank holds as many test batches: the mean of the means
            bits = torch.tensor([bits_raw], dtype=torch.float64,
                                device=device)
            dist.all_reduce(bits)
            bits_raw = float(bits) / layout.data_size
        print(f"Validation bits/dim: {bits_raw:.4f}")
        if data["data_type"] == "melspec":
            # bits of the [0,1]-rescaled variable y = (x - minval) / span:
            # p_x(x) = p_y(y) / span, so per dim bits_y = bits_x - log2(span)
            span = float(data["maxval"]) - float(data["minval"])
            print(f"Validation bits/px ([0,1]-rescale convention, "
                  f"span={span:g} dB, = raw - log2(span)): "
                  f"{bits_raw - float(np.log2(span)):.4f}")
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
