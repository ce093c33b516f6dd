"""NCSN noise schedule, DSM loss and annealed Langevin dynamics (port of ``audiosourcesep_tpu/models/ncsn/utils.py``).

Every draw comes from a ``torch.Generator`` on the data's device, or is
passed in (``sigma_idx``/``noise`` for the loss, ``noise_fn`` for the
sampler) so that tests can feed the JAX package's draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ...separation import graphs


def get_sigmas(sigma1: float, sigmaL: float, num_classes: int,
               progression: str = "geometric") -> np.ndarray:
    """Noise schedule; both progressions give the same geometric
    sequence (kept for CLI compatibility)."""
    if progression == "geometric":
        sigmas = np.exp(np.linspace(np.log(sigma1), np.log(sigmaL),
                                    num=num_classes))
    elif progression == "logarithmic":
        sigmas = np.logspace(np.log10(sigma1), np.log10(sigmaL),
                             num=num_classes)
    else:
        raise ValueError("progression should be geometric or logarithmic")
    return sigmas.astype(np.float32)


def dsm_loss(score_fn: Callable, X: torch.Tensor, sigmas: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             per_sample_sigma: bool = True,
             sigma_idx: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Denoising score-matching loss (train_ncsn.py:26-46):

        mean_i  sigma_i^2 * 0.5 * || s(x_i + sigma_i*eps, i) + eps/sigma_i ||^2

    the mean over examples. ``score_fn(x, sigma_idx)`` is the score
    network, ``sigmas`` the ``[L]`` schedule on ``X``'s device.
    ``per_sample_sigma=False`` reproduces the reference quirk of one noise
    level per batch. ``sigma_idx`` (``[n]``) and ``noise`` (standard
    normal, ``X``'s shape) are drawn from ``generator`` unless given.
    """
    n = X.shape[0]
    L = sigmas.shape[0]
    if sigma_idx is None:
        size = (n,) if per_sample_sigma else (1,)
        sigma_idx = torch.randint(L, size, generator=generator,
                                  device=X.device).expand(n)
    sigma_idx = sigma_idx.to(device=X.device, dtype=torch.long)
    if noise is None:
        noise = torch.randn(X.shape, generator=generator, device=X.device,
                            dtype=X.dtype)
    used_sigma = sigmas[sigma_idx].to(X.dtype)[:, None, None, None]
    noise = noise.to(device=X.device, dtype=X.dtype) * used_sigma
    target = -noise / torch.square(used_sigma)
    scores = score_fn(X + noise, sigma_idx)
    per_example = 0.5 * torch.sum(torch.square(scores - target),
                                  dim=(1, 2, 3))
    return torch.mean(per_example * torch.square(used_sigma[:, 0, 0, 0]))


@torch.no_grad()
def anneal_langevin_dynamics(score_fn: Callable, x_init: torch.Tensor,
                             sigmas, generator: Optional[torch.Generator]
                             = None, n_steps_each: int = 100,
                             step_lr: float = 2e-5,
                             return_arr: bool = False,
                             noise_fn: Optional[Callable] = None,
                             graphed: Optional[bool] = None):
    """Annealed Langevin sampler (ncsn/utils.py:17-38), the counterpart of
    the JAX package's jitted double scan. Per level i: ``alpha = step_lr *
    (sigma_i / sigma_L)^2``; per step: ``x <- x + alpha * s(x, i) +
    sqrt(2 alpha) * eps``, ``eps`` from ``generator`` or ``noise_fn(level,
    step)``.

    On a CUDA device each level is a CUDA graph of one step, captured once
    and replayed ``n_steps_each`` times (``separation.graphs``); on the
    CPU, or with ``graphed=False``, the same step runs eagerly. ``graphed``
    as in ``separation.basis_separate_per_level``.

    Returns the final ``x`` or, with ``return_arr``, the per-level states
    ``[L+1, n, ...]`` with the init first.
    """
    graphed = graphs.use_graphs(graphed, x_init.device)
    sig = np.asarray(sigmas, np.float32)
    n = x_init.shape[0]
    # updated in place, the graphs' static input
    x = x_init.clone()
    traj = [x_init] if return_arr else None

    def make_step(level):
        alpha = np.float32(step_lr) * np.square(sig[level] / sig[-1])
        noise_scale = float(np.sqrt(np.float32(2.0) * alpha))
        alpha = float(alpha)
        labels = torch.full((n,), level, dtype=torch.long, device=x.device)

        def step(x, noise):
            x.add_(alpha * score_fn(x, labels)).add_(noise * noise_scale)

        return step

    def after_level(level, x):
        if return_arr:
            traj.append(x.clone())

    graphs.anneal(make_step, x, sig.shape[0], n_steps_each, graphed,
                  generator, noise_fn, after_level)
    return torch.stack(traj) if return_arr else x
