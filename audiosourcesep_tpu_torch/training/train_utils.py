"""Run infrastructure: optimizers, EMA, TensorBoard, config, figures (port of ``audiosourcesep_tpu/training/train_utils.py``).

The JAX package's optimizers are optax transformations; here
:func:`setup_optimizer` returns an :class:`OptimizerSpec` whose ``init``
builds the ``torch.optim`` optimizer that computes the same update
(``Adam`` for ``optax.adam``, ``Adamax`` for ``optax.adamax``, at optax's
default betas and eps), and :func:`clip_by_global_norm_` is optax's
global-norm clip, applied to the gradients before the step.
"""

from __future__ import annotations

import argparse
import datetime
import io
import os
import shutil
from typing import Any, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch

OPTIMIZERS = {"adam": torch.optim.Adam, "adamax": torch.optim.Adamax}


class OptimizerSpec(NamedTuple):
    """adam or adamax at ``learning_rate``, optionally preceded by optax's
    global-norm clip at ``clipnorm``."""
    name: str = "adam"
    learning_rate: float = 1e-3
    clipnorm: Optional[float] = None

    def init(self, params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        """The optimizer over ``params``, its state (step 0, zero moments)
        allocated now rather than at the first step, so that a fresh state
        can be saved or restored into."""
        params = list(params)
        opt = OPTIMIZERS[self.name](params, lr=self.learning_rate,
                                    betas=(0.9, 0.999), eps=1e-8)
        second = "exp_avg_sq" if self.name == "adam" else "exp_inf"
        for p in params:
            opt.state[p] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(
                    p, memory_format=torch.preserve_format),
                second: torch.zeros_like(
                    p, memory_format=torch.preserve_format)}
        return opt


def setup_optimizer(optimizer: str = "adam", learning_rate: float = 1e-3,
                    clipnorm: Optional[float] = None) -> OptimizerSpec:
    """adam/adamax (reference train_utils.py:23-41) with an optional
    global-norm gradient clip first, as the JAX package chains
    ``optax.clip_by_global_norm`` before the optimizer."""
    if optimizer not in OPTIMIZERS:
        raise ValueError("optimizer argument should be adam or adamax")
    return OptimizerSpec(optimizer, learning_rate, clipnorm)


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: with ``norm`` the global L2
    norm, every gradient becomes ``g / norm * max_norm`` unless ``norm <
    max_norm`` (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``).
    Stays on the device (no host sync); returns ``norm``."""
    grads = [g for g in grads if g is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    # dividing by 1 and multiplying by 1 are exact: kept gradients stay
    # bit-identical, clipped ones are rounded as optax rounds them
    denom = torch.where(keep, torch.ones_like(norm), norm)
    factor = torch.where(keep, torch.ones_like(norm),
                         torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(denom.to(g.dtype)).mul_(factor.to(g.dtype))
    return norm


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor],
               params: Iterable[torch.Tensor], decay: float = 0.99) -> None:
    """``ema <- decay * ema + (1 - decay) * p`` in place
    (tfa.optimizers.MovingAverage, train_ncsn.py:328-329)."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)


# ---------------------------------------------------------------------------
# tensorboard (train_utils.py:44-59)
# ---------------------------------------------------------------------------

class NullWriter:
    """Summary writer that writes nothing (no TensorBoard installed)."""

    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def add_text(self, *a, **k):
        pass

    def add_audio(self, *a, **k):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def setup_tensorboard(log_root: str = "tensorboard_logs",
                      clear: bool = True) -> Tuple[Any, Any]:
    """Train/test ``torch.utils.tensorboard`` writers under ``log_root``
    (cleared first, as the reference does), or two :class:`NullWriter`
    with a warning when TensorBoard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        print(f"WARNING: torch.utils.tensorboard unavailable ({e!r}); "
              "summaries disabled (NullWriter)", flush=True)
        return NullWriter(), NullWriter()
    if clear:
        shutil.rmtree(log_root, ignore_errors=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    root = os.path.join(log_root, "gradient_tape", stamp)
    return (SummaryWriter(os.path.join(root, "train")),
            SummaryWriter(os.path.join(root, "test")))


# ---------------------------------------------------------------------------
# figures (train_utils.py:78-111); matplotlib is imported only here
# ---------------------------------------------------------------------------

def plot_to_image(figure) -> np.ndarray:
    """matplotlib figure -> HWC uint8 array (for add_image)."""
    import matplotlib.pyplot as plt
    from PIL import Image
    buf = io.BytesIO()
    figure.savefig(buf, format="png")
    plt.close(figure)
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGBA"))


def image_grid(sample: np.ndarray, data_shape, data_type: str = "image",
               **kwargs):
    """4x8 grid of images or mel spectrograms (specshow-style origin)."""
    import matplotlib.pyplot as plt
    f, axes = plt.subplots(4, 8, figsize=(12, 6))
    axes = axes.flatten()
    sample = np.asarray(sample)
    if sample.shape[-1] == 1:
        sample = np.squeeze(sample, axis=-1)
    for i, ax in enumerate(axes):
        ax.set_axis_off()
        if i > len(sample) - 1:
            continue
        if data_type == "image":
            ax.imshow(sample[i])
        else:
            ax.imshow(sample[i], origin="lower", aspect="auto",
                      cmap="magma")
    return f


# ---------------------------------------------------------------------------
# config (train_utils.py:114-131); yaml is imported only here
# ---------------------------------------------------------------------------

def get_config(config_path: str) -> argparse.Namespace:
    """A YAML file as a namespace (nested mappings as nested ones)."""
    import yaml
    with open(config_path) as f:
        config = yaml.safe_load(f) or {}
    return dict2namespace(config)


def dict2namespace(config: dict) -> argparse.Namespace:
    ns = argparse.Namespace()
    for key, value in config.items():
        setattr(ns, key,
                dict2namespace(value) if isinstance(value, dict) else value)
    return ns


def is_bad(loss) -> bool:
    """NaN/Inf abort condition (train_glow.py:113-118)."""
    return not np.isfinite(float(loss))
