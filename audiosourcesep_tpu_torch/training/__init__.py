"""NCSN and flow training, and checkpoint interop with the JAX package."""

from .checkpoint import (CheckpointManager, latest_checkpoint, restore_pytree,
                         save_pytree)
from .loop import LoopConfig, LoopResult, run_training
from .train_utils import (NullWriter, OptimizerSpec, clip_by_global_norm_,
                          dict2namespace, ema_update, get_config, image_grid,
                          is_bad, plot_to_image, setup_optimizer,
                          setup_tensorboard)
from .trainers import (TrainState, init_train_state, make_flow_train_step,
                       make_ncsn_train_step, train_noisy_glow_chain)

__all__ = ["CheckpointManager", "latest_checkpoint", "restore_pytree",
           "save_pytree", "LoopConfig", "LoopResult", "run_training",
           "NullWriter", "OptimizerSpec", "clip_by_global_norm_",
           "dict2namespace", "ema_update", "get_config", "image_grid",
           "is_bad", "plot_to_image", "setup_optimizer", "setup_tensorboard",
           "TrainState", "init_train_state", "make_flow_train_step",
           "make_ncsn_train_step", "train_noisy_glow_chain"]
