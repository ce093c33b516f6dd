"""Priors and the transformed-distribution flow model (port of ``audiosourcesep_tpu/bijectors/distribution.py``).

``log_prob(x) = prior.log_prob(chain.forward(x)) + chain.forward_log_det(x)``;
a sample is ``chain.inverse(z)`` of a latent ``z`` drawn from the prior.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..utils.profiling import span
from .core import Bijector

_LOG_2PI = math.log(2.0 * math.pi)


class IsotropicNormalPrior(torch.nn.Module):
    """Standard normal over a fixed event shape (no parameters)."""

    def __init__(self, event_shape: Sequence[int]):
        super().__init__()
        self.event_shape = tuple(event_shape)

    def reset_parameters(self):
        pass

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        d = math.prod(self.event_shape)
        sq = torch.square(z).sum(dim=tuple(range(1, z.dim())))
        return -0.5 * (sq + d * _LOG_2PI)

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
        return torch.randn((n, *self.event_shape), generator=generator,
                           device=device)


class LearnableDiagNormalPrior(torch.nn.Module):
    """Diagonal normal with trainable ``loc`` and ``log_scale`` of the
    event shape (the reference's "learntop" prior); both start at 0."""

    def __init__(self, event_shape: Sequence[int], device=None):
        super().__init__()
        self.event_shape = tuple(event_shape)
        self.loc = torch.nn.Parameter(torch.empty(self.event_shape,
                                                  device=device))
        self.log_scale = torch.nn.Parameter(torch.empty(self.event_shape,
                                                        device=device))

    @torch.no_grad()
    def reset_parameters(self):
        self.loc.zero_()
        self.log_scale.zero_()

    def log_prob(self, z: torch.Tensor) -> torch.Tensor:
        u = (z - self.loc) * torch.exp(-self.log_scale)
        elem = -0.5 * (torch.square(u) + _LOG_2PI) - self.log_scale
        return elem.sum(dim=tuple(range(1, z.dim())))

    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               device=None) -> torch.Tensor:
        eps = torch.randn((n, *self.event_shape), generator=generator,
                          device=device)
        return self.loc + eps * torch.exp(self.log_scale)


class FlowModel(torch.nn.Module):
    """A normalizing flow: ``bijector`` (data -> latent) and ``prior``
    over the latent. Its parameters are named as the JAX package's params
    pytree, ``{"bijector": ..., "prior": ...}``.

    ``noise`` names the draw that :meth:`log_prob` hands the bijector
    (:meth:`draw_noise`): ``"uniform"`` on ``[0, 1)`` for uniform
    dequantisation (``ImgPreprocessing``), ``"normal"`` for Flow++'s
    variational dequantisation.
    """

    def __init__(self, bijector: Bijector, prior: torch.nn.Module,
                 noise: str = "uniform"):
        super().__init__()
        if noise not in ("uniform", "normal"):
            raise ValueError("noise should be 'uniform' or 'normal'")
        self.bijector = bijector
        self.prior = prior
        self.noise = noise

    def draw_noise(self, shape, generator: Optional[torch.Generator] = None,
                   device=None) -> torch.Tensor:
        """A draw of this model's ``noise`` of ``shape``."""
        draw = torch.randn if self.noise == "normal" else torch.rand
        return draw(tuple(shape), generator=generator, device=device)

    @torch.no_grad()
    def init(self, minibatch: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> "FlowModel":
        """Draw every parameter: data-dependent ones (ActNorm) from
        ``minibatch``, threaded through the chain; random ones from
        ``generator`` (a CPU generator)."""
        self.bijector.init(minibatch, generator)
        self.prior.reset_parameters()
        return self

    @torch.no_grad()
    def reinit_data_dependent(self, minibatch: torch.Tensor) -> None:
        """Re-anchor the data-dependent statistics (ActNorm) on
        ``minibatch``, keeping all trained weights (the noisy-Glow chain
        recalibrates each sigma level's flow to its noised input)."""
        self.bijector.reinit(minibatch)

    def log_prob(self, x: torch.Tensor,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        z, fldj = self.bijector(x, noise)
        return self.prior.log_prob(z) + fldj

    def score(self, x: torch.Tensor) -> torch.Tensor:
        """``grad_x log p(x)``, the Glow-prior score BASIS uses; no
        gradient reaches the parameters. The log-density and its input
        gradient are the module spans ``score.forward`` and
        ``score.backward``."""
        with torch.enable_grad():
            v = x.detach().requires_grad_(True)
            with span("score.forward"):
                log_p = self.log_prob(v).sum()
            with span("score.backward"):
                return torch.autograd.grad(log_p, v)[0]

    def sample(self, z: torch.Tensor) -> torch.Tensor:
        """The data point of latent ``z`` (``prior.sample`` draws one)."""
        return self.bijector.inverse(z)[0]

    def bits_per_dim(self, x: torch.Tensor,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        d = math.prod(x.shape[1:])
        return -self.log_prob(x, noise) / (d * math.log(2.0))
