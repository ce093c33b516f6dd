"""Training loop (port of ``audiosourcesep_tpu/training/loop.py``).

The reference's custom loop (train_ncsn.py:21-180) with the JAX package's
behaviour: NaN/Inf abort (the state is still saved), loss-jump snapshots
to ``ckpts_issues``, validation every ``val_every_epochs`` and at the
last epoch, the best-validation state kept as a device-side copy and
written at most every ``ckpt_min_interval_s`` (and once at the end), the
sampling cadence, TensorBoard's step axis, and a final save. Checkpoints
are written in the JAX package's layout (:meth:`TrainState.tree`).

Under ``torch.distributed`` every rank runs this loop on its shard of
the data and only rank 0 writes checkpoints. The data-parallel steps
return losses averaged over the ranks, so every rank takes the same NaN,
loss-jump and best-validation branches: a rank that broke away alone
would leave its peers waiting in their next collective.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..parallel import is_main_process
from .checkpoint import CheckpointManager
from .train_utils import is_bad


@dataclass
class LoopConfig:
    n_epochs: int = 10
    batch_size: int = 32
    losses_per_epoch: int = 10        # TB points per epoch (reference: 10)
    val_every_epochs: int = 1
    sample_every_epochs: Optional[int] = None
    loss_jump_threshold: Optional[float] = 1e6
    ckpt_dir: str = "./ckpts"
    issues_ckpt_dir: str = "./ckpts_issues"
    max_to_keep: int = 5
    output_dir: str = "."
    # best-val snapshots are device-side copies taken at every improvement,
    # written to disk at most this often (and once at the end): a full
    # train-state write is a device->host transfer of ~1 GB for the 67M
    # NCSN. 0 writes every improvement, as the reference does.
    ckpt_min_interval_s: float = 600.0


@dataclass
class LoopResult:
    state: Any
    training_time: float
    save_path: Optional[str]
    aborted_nan: bool = False
    history: list = field(default_factory=list)


def run_training(state, train_step: Callable, eval_loss: Callable,
                 ds_train, ds_test, config: LoopConfig,
                 generator: torch.Generator,
                 sample_fn: Optional[Callable] = None,
                 train_writer=None, test_writer=None) -> LoopResult:
    """Train ``state`` (a :class:`~.trainers.TrainState`) for
    ``config.n_epochs``.

    ``train_step(state, batch, generator) -> (state, loss)`` and
    ``eval_loss(state, batch, generator) -> loss``, as made by
    :func:`~.trainers.make_ncsn_train_step`; each batch goes to
    ``generator``'s device, which draws every noise of the run.
    ``sample_fn(state, epoch, generator)`` runs every
    ``sample_every_epochs`` and at the last epoch.
    """
    device = generator.device
    manager = CheckpointManager(
        os.path.join(config.output_dir, config.ckpt_dir),
        config.max_to_keep)
    manager_issues = (CheckpointManager(
        os.path.join(config.output_dir, config.issues_ckpt_dir), 3)
        if config.loss_jump_threshold else None)

    def put(batch):
        return torch.as_tensor(batch, device=device)

    is_main = is_main_process()
    # TB step axis: the reference's global batch over its global example
    # count (a rank's shard would advance it once per rank too fast)
    n_train = max(getattr(ds_train, "n_global", ds_train.n_examples), 1)
    steps_per_epoch = max(len(ds_train), 1)
    log_every = max(steps_per_epoch // config.losses_per_epoch, 1)

    count_step = int(state.step)
    min_val_loss = np.inf
    best_state = None
    best_step = written_best_step = -1
    last_ckpt_write = -np.inf
    prev_history_avg = None
    is_nan_loss = False
    history = []
    save_path = None
    t0 = time.time()

    for epoch in range(1, config.n_epochs + 1):
        if is_nan_loss:
            break
        epoch_losses = []
        window_losses = []
        for batch in ds_train:
            state, loss = train_step(state, put(batch), generator)
            window_losses.append(loss)
            count_step += 1

            if count_step % log_every == 0:
                # the losses stay on the device until here: one host sync
                # per logged window
                window = [float(l) for l in window_losses]
                epoch_losses.extend(window)
                loss_val = window[-1]
                if is_bad(loss_val):
                    print(f"Nan or Inf Loss: {loss_val}")
                    is_nan_loss = True
                    break
                curr_avg = float(np.mean(window))
                window_losses = []
                if train_writer is not None:
                    step_int = int(10 * count_step * config.batch_size
                                   / n_train)
                    train_writer.add_scalar("loss", curr_avg, step_int)
                if (manager_issues is not None
                        and prev_history_avg is not None
                        and curr_avg - prev_history_avg
                        > config.loss_jump_threshold):
                    print("Huge gap in the loss")
                    if is_main:
                        path = manager_issues.save(state.tree(), count_step)
                        print(f"Model weights saved at {path}")
                prev_history_avg = curr_avg
        epoch_losses.extend(float(l) for l in window_losses)

        # every val_every_epochs (reference train_ncsn.py:130), and always
        # the final epoch so that short runs still select a best
        run_val = (epoch % max(config.val_every_epochs, 1) == 0
                   or epoch == config.n_epochs)
        if run_val and not is_nan_loss:
            val_losses = [float(eval_loss(state, put(batch), generator))
                          for batch in ds_test]
            val_loss = float(np.mean(val_losses)) if val_losses else np.nan
            if test_writer is not None:
                step_int = int(10 * count_step * config.batch_size / n_train)
                test_writer.add_scalar("loss", val_loss, step_int)
            train_loss = float(np.mean(epoch_losses)) if epoch_losses \
                else np.nan
            print(f"Epoch {epoch:03d}: Train Loss: {train_loss:.3f} "
                  f"Val Loss: {val_loss:3f}")
            history.append({"epoch": epoch, "train": train_loss,
                            "val": val_loss})
            if val_loss < min_val_loss:
                min_val_loss = val_loss
                state.step = count_step
                # a device-side copy: the next steps update the state's
                # tensors in place
                best_state = state.snapshot()
                best_step = count_step
                if is_main and (time.time() - last_ckpt_write
                                >= config.ckpt_min_interval_s):
                    save_path = manager.save(best_state, best_step)
                    written_best_step = best_step
                    last_ckpt_write = time.time()
                    print(f"Model Saved at {save_path}")

        if (sample_fn is not None and config.sample_every_epochs
                and (epoch % config.sample_every_epochs == 0
                     or epoch == config.n_epochs)):
            sample_fn(state, epoch, generator)

    state.step = count_step
    if is_main:
        if best_state is not None and written_best_step != best_step:
            path = manager.save(best_state, best_step)
            print(f"Model Saved at {path}")
        save_path = manager.save(state.tree(), count_step)
        print(f"Model Saved at {save_path}")
    return LoopResult(state=state, training_time=time.time() - t0,
                      save_path=save_path, aborted_nan=is_nan_loss,
                      history=history)
