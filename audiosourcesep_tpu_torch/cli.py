"""CLI plumbing shared by the port's entry points (port of ``audiosourcesep_tpu/cli.py``).

The JAX package's operational behaviour, without its ``chdir``: the
output directory is created, stdout goes to ``out.log`` there unless
``--debug`` (for the duration of the call), every output is written under
it by path, and a ``--config`` YAML overlays the parsed flags (a key it
names replaces the flag; flags it does not name keep their values, so a
YAML without ``seed`` still runs with the default seed). Devices: ``cuda``
raises when there is no card, and nothing falls back to the CPU.

``--multihost`` runs a training CLI as one rank of a ``torch.distributed``
group (:func:`multihost`): every rank loads its shard of the data at the
global batch over the ranks, only rank 0 writes checkpoints and
``out.log`` (rank ``r`` logs to ``out_rank{r}.log``), and the run ends at
a barrier.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Iterable

import torch
import torch.distributed as dist

from . import parallel
from .data import load_melspec_ds, load_toydata
from .training.train_utils import get_config

# run-level flags a --config YAML never overrides
KEEP = ("dataset", "output", "debug", "restore", "RESTORE", "song_dir",
        "inverse", "model_type", "n_mixed", "device")


def apply_config_override(args: argparse.Namespace,
                          keep: Iterable[str] = KEEP) -> argparse.Namespace:
    """``--config`` (YAML) overrides the hyperparameters it names; the
    run-level flags in ``keep`` always stay as given."""
    if getattr(args, "config", None) is None:
        return args
    new_args = argparse.Namespace(**vars(args))
    keep = set(keep)
    for k, v in vars(get_config(args.config)).items():
        if k not in keep:
            setattr(new_args, k, v)
    return new_args


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} requested but CUDA is not "
                           "available (no fallback to the CPU)")
    return device


def add_multihost_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--multihost", action="store_true",
                        help="run as one rank of a torch.distributed group "
                             "(data-parallel training); without "
                             "--coordinator_address the group comes from "
                             "torchrun's environment")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="host:port (or a tcp:// / file:// URL) of the "
                             "rendezvous")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)


def maybe_init_multihost(args) -> torch.device:
    """With ``--multihost``, join the process group
    (:func:`~.parallel.init_distributed`) and return this rank's device;
    without it, ``--device`` itself."""
    if not getattr(args, "multihost", False):
        return resolve_device(args.device)
    return parallel.init_distributed(
        getattr(args, "coordinator_address", None),
        getattr(args, "num_processes", None),
        getattr(args, "process_id", None), device=args.device)


@contextlib.contextmanager
def multihost(args):
    """:func:`maybe_init_multihost` for the duration: yields the device;
    a multi-process run ends at a barrier and leaves the group (at once,
    without the barrier, when this rank raised)."""
    device = maybe_init_multihost(args)
    if not dist.is_initialized():
        yield device
        return
    try:
        yield device
    except BaseException:
        dist.destroy_process_group()
        raise
    parallel.shutdown()


def describe_multihost() -> None:
    """Print the process group, if any (into the run's log)."""
    if dist.is_initialized():
        print(f"Multi-host initialised: process {dist.get_rank()} of "
              f"{dist.get_world_size()}, backend {dist.get_backend()}")


@contextlib.contextmanager
def setup_output_dir(output: str, debug: bool):
    """Create ``output``; for the duration, stdout goes to
    ``output/out.log`` (``out_rank{r}.log`` on rank ``r > 0``) unless
    ``debug``. Yields the log file."""
    os.makedirs(output, exist_ok=True)
    r = parallel.rank()
    name = "out.log" if r == 0 else f"out_rank{r}.log"
    with open(os.path.join(output, name), "w") as log_file:
        with (contextlib.nullcontext() if debug
              else contextlib.redirect_stdout(log_file)):
            yield log_file


def resolve_dataset(args) -> dict:
    """Load a training dataset. ``args.dataset`` is ``mnist`` or
    ``cifar10`` (:func:`~.data.load_toydata`: images in [0, 256),
    ``data_type`` ``image``) or a directory with ``train/`` and ``test/``
    TFRecord subdirectories (mel spectrograms, whose scale limits are
    those of ``--scale``: dB [-100, 20], power [1e-10, 100]). Under
    ``torch.distributed`` each rank loads its shard and iterates its
    slice of the global ``--batch_size``; the counts are global. Returns
    ``ds_train, ds_test, minibatch, n_train, n_test, data_shape,
    data_type, minval, maxval``."""
    n_proc, proc_id = parallel.world_size(), parallel.rank()
    local_bs = max(args.batch_size // n_proc, 1)
    if args.dataset in ("mnist", "cifar10"):
        ds_train, ds_test, minibatch = load_toydata(
            args.dataset, local_bs, num_hosts=n_proc, host_id=proc_id)
        return dict(ds_train=ds_train, ds_test=ds_test, minibatch=minibatch,
                    n_train=ds_train.n_global, n_test=ds_test.n_global,
                    data_shape=tuple(minibatch.shape[1:]),
                    data_type="image", minval=0.0, maxval=256.0)
    ds_train, ds_test, minibatch, n_train, n_test = load_melspec_ds(
        os.path.join(args.dataset, "train"),
        os.path.join(args.dataset, "test"), batch_size=local_bs,
        num_hosts=n_proc, host_id=proc_id)
    if getattr(args, "scale", "dB") == "power":
        minval, maxval = 1e-10, 100.0
    else:
        minval, maxval = -100.0, 20.0
    return dict(ds_train=ds_train, ds_test=ds_test, minibatch=minibatch,
                n_train=n_train, n_test=n_test,
                data_shape=tuple(minibatch.shape[1:]), data_type="melspec",
                minval=minval, maxval=maxval)


def print_params(args, writer=None) -> str:
    template = "Parameters \n\t "
    for k, v in vars(args).items():
        template += f"{k} = {v} \n\t "
    print(template)
    if writer is not None:
        writer.add_text("Parameters", template, 0)
    return template
