"""BASIS: Bayesian Annealed SIgnal Separation (port of
``basis_separate``, ``basis_separate_per_level`` and the NCSN and Glow
score functions in ``audiosourcesep_tpu/separation/basis.py``).

Per noise level ``sigma`` the sources take ``T`` Langevin steps held to
the mixture:

    x <- x + eta * (score(x) + lambda * grad_g(x) * (mixed - g(x)))
           + sqrt(2 eta) * eps

with ``eta = delta * (sigma / sigma_L)^2`` and ``lambda = 1 / sigma^2``.
PyTorch runs eagerly, so the JAX package's jitted per-level scan becomes a
Python loop over steps, and its single L*T program (``basis_separate``)
the same loop over all levels in one call.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .mixing import mixing_process


class BasisConfig(NamedTuple):
    T: int = 100
    delta: float = 2e-5
    data_type: str = "melspec"
    scale: str = "dB"
    collect_trajectory: bool = True
    # optional per-pixel score clip at +-score_clip/sigma (None = off)
    score_clip: Optional[float] = None


def _clip_scores(scores: torch.Tensor, sigma: float,
                 clip: Optional[float]) -> torch.Tensor:
    if clip is None:
        return scores
    bound = float(np.float32(clip) / np.float32(sigma))
    return torch.clamp(scores, -bound, bound)


def ncsn_score_fn(models: Sequence[torch.nn.Module]) -> Callable:
    """Score over stacked sources: ``score(x [K, N, ...], sigma_idx,
    level) -> [K, N, ...]``, one model per source, applied in turn."""
    def score(x: torch.Tensor, sigma_idx: torch.Tensor,
              level: int) -> torch.Tensor:
        del level
        return torch.stack([m(x[k], sigma_idx) for k, m in enumerate(models)])

    return score


def glow_score_fn(models_per_level: Sequence[Sequence[torch.nn.Module]],
                  frame_chunk: Optional[int] = None) -> Callable:
    """Glow-prior score over stacked sources: ``score(x [K, N, ...],
    sigma_idx, level) -> [K, N, ...]``, with ``models_per_level[level][k]``
    the flow of source ``k`` at that noise level, applied in turn.

    The score is ``grad_x log p(x)`` through the flow (autograd with
    respect to ``x`` only: the priors' parameters should have
    ``requires_grad_(False)``, so no weight gradient is formed).
    ``frame_chunk`` bounds the backward's working set: the frames go
    through the flow ``frame_chunk`` at a time, which is exact because
    frames are independent. ``None`` or 0 takes all frames at once.
    """
    def score(x: torch.Tensor, sigma_idx: torch.Tensor,
              level: int) -> torch.Tensor:
        del sigma_idx
        return torch.stack([
            torch.cat([m.score(xc) for xc in (x[k].split(frame_chunk)
                                              if frame_chunk else (x[k],))])
            for k, m in enumerate(models_per_level[level])])

    return score


@torch.no_grad()
def basis_separate_per_level(score_fn: Callable, mixed: torch.Tensor,
                             x_init: torch.Tensor, sigmas,
                             generator: Optional[torch.Generator] = None,
                             config: BasisConfig = BasisConfig(),
                             callback: Optional[Callable] = None,
                             noise_fn: Optional[Callable] = None):
    """Annealed BASIS separation, one noise level at a time.

    Args:
        score_fn: ``(x [K, N, ...], sigma_idx [N], level) -> scores``.
        mixed: ``[N, ...]`` preprocessed mixture.
        x_init: ``[K, N, ...]`` initial sources (not modified).
        sigmas: ``[L]`` noise schedule.
        generator: draws the Langevin noise (``torch.randn``) on
            ``x_init``'s device.
        noise_fn: optional ``(level, step) -> standard-normal tensor`` of
            ``x_init``'s shape, used instead of ``generator`` (tests feed
            the JAX package's exact draws through it).
        callback: ``callback(level, x)`` after each level.
    Returns:
        ``(x_final [K, N, ...], trajectory [L+1, K, N, ...] or None)``.
    """
    g, grad_g = mixing_process(config.data_type, config.scale)
    sig = np.asarray(sigmas, np.float32)
    L = sig.shape[0]
    N = x_init.shape[1]
    # x is updated in place: the port's stand-in for the JAX package's
    # buffer donation into the per-level program. The caller's x_init is
    # copied first and each trajectory entry is a snapshot copy.
    x = x_init.clone()
    traj = [x_init.clone()] if config.collect_trajectory else None
    for level in range(L):
        sigma = sig[level]
        eta = np.float32(config.delta) * np.square(sigma / sig[-1])
        lam = float(np.float32(1.0) / np.square(sigma))
        noise_scale = float(np.sqrt(np.float32(2.0) * eta))
        eta = float(eta)
        labels = torch.full((N,), level, dtype=torch.long, device=x.device)
        for step in range(config.T):
            if noise_fn is not None:
                noise = noise_fn(level, step).to(device=x.device,
                                                 dtype=x.dtype)
            else:
                noise = torch.randn(x.shape, generator=generator,
                                    device=x.device, dtype=x.dtype)
            scores = _clip_scores(score_fn(x, labels, level), sigma,
                                  config.score_clip)
            recon = lam * grad_g(x) * (mixed - g(x))
            x.add_(eta * (scores + recon)).add_(noise * noise_scale)
        if callback is not None:
            callback(level, x)
        if config.collect_trajectory:
            traj.append(x.clone())
    return x, (torch.stack(traj) if config.collect_trajectory else None)


# The full annealed separation in one call (all L levels x T steps): in
# eager PyTorch the same loop as basis_separate_per_level, with the same
# arguments and results.
basis_separate = basis_separate_per_level


def preprocess_mixture(mixed: torch.Tensor, minval: float, maxval: float,
                       use_logit: bool = False,
                       alpha: float = 1e-6) -> torch.Tensor:
    """Rescale the mixture to [0, 1] (+ optional logit)."""
    x = (mixed - minval) / (maxval - minval)
    if use_logit:
        x = x * (1.0 - 2 * alpha) + alpha
        x = torch.log(x) - torch.log1p(-x)
    return x


def postprocess(x: torch.Tensor, minval: float, maxval: float,
                use_logit: bool = False, alpha: float = 1e-6,
                data_type: str = "melspec",
                rescale: bool = True) -> torch.Tensor:
    """Map separated sources back to data scale, then clip (melspec) or
    clip and round (image)."""
    if rescale:
        if use_logit:
            x = torch.sigmoid(x)
            x = (x - alpha) / (1.0 - 2.0 * alpha)
        x = x * (maxval - minval) + minval
    if data_type == "image":
        return torch.round(torch.clamp(x, 0.0, 255.0))
    return torch.clamp(x, minval, maxval)
