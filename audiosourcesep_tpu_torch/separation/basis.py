"""BASIS: Bayesian Annealed SIgnal Separation (port of
``basis_separate``, ``basis_separate_per_level`` and the NCSN and Glow
score functions in ``audiosourcesep_tpu/separation/basis.py``).

Per noise level ``sigma`` the sources take ``T`` Langevin steps held to
the mixture:

    x <- x + eta * (score(x) + lambda * grad_g(x) * (mixed - g(x)))
           + sqrt(2 eta) * eps

with ``eta = delta * (sigma / sigma_L)^2`` and ``lambda = 1 / sigma^2``.
The JAX package's jitted per-level scan becomes, on a CUDA device, a CUDA
graph of one step captured each level and replayed T times
(:mod:`.graphs`); on the CPU the same step runs in a Python loop. Its
single L*T program (``basis_separate``) is the same anneal over all levels
in one call.

Over several ranks (a :class:`~..parallel.Layout`) each rank anneals its
block of the sources: its frame shard of both sources (the frames are
independent, so this needs no collective), or on JAX's ``(source, data)``
layout one source's frames, whose model it alone holds
(:func:`source_sharded_ncsn_score`, :func:`source_sharded_glow_score`);
the mixing then gathers the other source's block each step. Every draw
is made over the global sources and sliced, so a layout changes no
draw; a model that sees fewer frames a forward (frames sharded) rounds
otherwise. A layout of more than one rank anneals eagerly: its NCCL
collectives are not captured in a graph yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..parallel import Layout
from ..utils.profiling import span
from . import graphs
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
        scores = []
        for k, m in enumerate(models):
            with span("score"):
                scores.append(m(x[k], sigma_idx))
        return torch.stack(scores)

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
        scores = []
        for k, m in enumerate(models_per_level[level]):
            with span("score"):
                scores.append(torch.cat([
                    m.score(xc) for xc in (x[k].split(frame_chunk)
                                           if frame_chunk else (x[k],))]))
        return torch.stack(scores)

    return score


def _one_model_per_rank(n_models: int, x: torch.Tensor, what: str) -> None:
    # the local eval takes x[0] with the one model: valid only when this
    # rank holds exactly one source's model and one source's frames; any
    # mismatch would evaluate the wrong model on the wrong source
    if n_models != 1 or x.shape[0] != 1:
        raise ValueError(
            f"source-sharded {what}: a rank holds {n_models} models and "
            f"{x.shape[0]} sources; each rank must hold exactly one "
            "source and its model")


def source_sharded_ncsn_score(models: Sequence[torch.nn.Module],
                              layout: Layout) -> Callable:
    """NCSN score on JAX's ``(source, data)`` layout: this rank holds ONE
    model (``models``, of length 1: its source's, ``layout.source``) and
    runs it as a plain forward on its frames, ``score(x [1, n_local,
    ...], sigma_idx, level) -> [1, n_local, ...]``. Raises unless the rank
    holds exactly one model and one source."""
    if layout.n_sources != 2:
        raise ValueError("source-sharded score needs a layout of 2 sources")

    def score(x: torch.Tensor, sigma_idx: torch.Tensor,
              level: int) -> torch.Tensor:
        del level
        _one_model_per_rank(len(models), x, "score")
        with span("score"):
            return models[0](x[0], sigma_idx)[None]

    return score


def source_sharded_glow_score(
        models_per_level: Sequence[Sequence[torch.nn.Module]],
        layout: Layout, frame_chunk: Optional[int] = None) -> Callable:
    """Glow score on JAX's ``(source, data)`` layout: this rank holds ONE
    source's chain of flows, ``models_per_level[level]`` of length 1, and
    differentiates its flow on its frames (``frame_chunk`` at a time, as
    :func:`glow_score_fn`). Raises unless the rank holds exactly one
    source's flows and one source."""
    if layout.n_sources != 2:
        raise ValueError("source-sharded score needs a layout of 2 sources")
    local = glow_score_fn(models_per_level, frame_chunk)

    def score(x: torch.Tensor, sigma_idx: torch.Tensor,
              level: int) -> torch.Tensor:
        _one_model_per_rank(len(models_per_level[level]), x, "glow score")
        return local(x, sigma_idx, level)

    return score


@torch.no_grad()
def basis_separate_per_level(score_fn: Callable, mixed: torch.Tensor,
                             x_init: torch.Tensor, sigmas,
                             generator: Optional[torch.Generator] = None,
                             config: BasisConfig = BasisConfig(),
                             callback: Optional[Callable] = None,
                             noise_fn: Optional[Callable] = None,
                             layout: Optional[Layout] = None,
                             graphed: Optional[bool] = None):
    """Annealed BASIS separation, one noise level at a time.

    Args:
        score_fn: ``(x [K, N, ...], sigma_idx [N], level) -> scores``, on
            this rank's block of ``x`` with a ``layout``.
        mixed: ``[N, ...]`` preprocessed mixture.
        x_init: ``[K, N, ...]`` initial sources (not modified).
        sigmas: ``[L]`` noise schedule.
        generator: draws the Langevin noise (``torch.randn``) on
            ``x_init``'s device.
        noise_fn: optional ``(level, step) -> standard-normal tensor`` of
            ``x_init``'s shape, used instead of ``generator`` (tests feed
            the JAX package's exact draws through it).
        callback: ``callback(level, x)`` after each level (``x`` this
            rank's block).
        layout: anneal over its ranks. ``mixed`` and ``x_init`` are the
            global tensors, the same on every rank; the frames are padded
            by wrapping to a multiple of the frame shards (padding frames
            are copies of real ones and drawn alike, so they change
            nothing). Every rank draws every noise over the global
            ``x_init`` shape and keeps its block.
        graphed: each level as a CUDA graph of one step, captured once and
            replayed T times (:func:`.graphs.anneal`; one eager warm-up
            step a level runs before its capture). ``None``: graphed on a
            single-rank CUDA run, else eager. ``True`` on the CPU or with
            a layout of more than one rank raises; ``False`` runs the same
            step eagerly. The callback and the trajectory's snapshots run
            between levels, outside the graphs.
    Returns:
        ``(x_final [K, N, ...], trajectory [L+1, K, N, ...] or None)``,
        with a ``layout`` gathered on rank 0 (``(None, None)`` on the
        other ranks).
    """
    layout = layout or Layout()
    graphed = graphs.use_graphs(graphed, x_init.device, layout.world_size)
    g, grad_g = mixing_process(config.data_type, config.scale)
    sig = np.asarray(sigmas, np.float32)
    n_frames = x_init.shape[1]
    rows = layout.sources
    mixed = layout.local(mixed, frame_axis=0, source_axis=None)
    # x is updated in place: the port's stand-in for the JAX package's
    # buffer donation into the per-level program, and the graphs' static
    # input. The caller's x_init is copied first and each trajectory entry
    # is a snapshot copy.
    x = layout.local(x_init).clone()
    N = x.shape[1]
    traj = [x.clone()] if config.collect_trajectory else None

    def make_step(level):
        sigma = sig[level]
        eta = np.float32(config.delta) * np.square(sigma / sig[-1])
        lam = float(np.float32(1.0) / np.square(sigma))
        noise_scale = float(np.sqrt(np.float32(2.0) * eta))
        eta = float(eta)
        labels = torch.full((N,), level, dtype=torch.long, device=x.device)

        def step(x, noise):
            scores = score_fn(x, labels, level)
            with span("basis.update"):
                scores = _clip_scores(scores, sigma, config.score_clip)
                # the mixing over every source of this rank's frames
                xs = layout.gather_sources(x)
                recon = lam * grad_g(xs)[rows] * (mixed - g(xs))
                x.add_(eta * (scores + recon)).add_(noise * noise_scale)

        return step

    if layout.world_size > 1:
        given = noise_fn

        def noise_fn(level, step):
            # every rank draws over the global sources and keeps its block
            noise = (torch.randn(x_init.shape, generator=generator,
                                 device=x.device, dtype=x.dtype)
                     if given is None else given(level, step))
            return layout.local(noise.to(device=x.device, dtype=x.dtype))

    def after_level(level, x):
        if callback is not None:
            callback(level, x)
        if traj is not None:
            traj.append(x.clone())

    graphs.anneal(make_step, x, sig.shape[0], config.T, graphed, generator,
                  noise_fn, after_level)
    x = layout.gather(x, n_frames)
    if traj is not None:
        traj = layout.gather(torch.stack(traj), n_frames, frame_axis=2)
    return x, traj


# The full annealed separation in one call (all L levels x T steps): the
# same anneal as basis_separate_per_level (one graph a level on a CUDA
# device), with the same arguments and results.
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
