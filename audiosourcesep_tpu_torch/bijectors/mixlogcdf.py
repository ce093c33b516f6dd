"""Mixture-of-logistics CDF coupling of Flow++ (port of ``audiosourcesep_tpu/bijectors/mixlogcdf.py``).

The forward log-det evaluates the mixture density at the transformed half,
and the inverse finds ``cdf(x) = y`` by a fixed 64-step bisection (the CDF
is monotone, so bisection always converges), as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .core import Bijector, sum_event

Tensor = torch.Tensor

_CLIP_LO = 1e-10
_CLIP_HI = 1.0 - 1e-7


def mixlog_logcdf(x: Tensor, logits: Tensor, means: Tensor,
                  log_scales: Tensor, min_log_scale: float = -7.0) -> Tensor:
    """log CDF of a mixture of logistics; ``x [...]``, params ``[..., K]``."""
    log_scales = torch.clamp(log_scales, min=min_log_scale)
    log_p = torch.log_softmax(logits, dim=-1)
    z = (x[..., None] - means) * torch.exp(-log_scales)
    return torch.logsumexp(log_p + F.logsigmoid(z), dim=-1)


def mixlog_logpdf(x: Tensor, logits: Tensor, means: Tensor,
                  log_scales: Tensor, min_log_scale: float = -7.0) -> Tensor:
    """log density of the same mixture."""
    log_scales = torch.clamp(log_scales, min=min_log_scale)
    log_p = torch.log_softmax(logits, dim=-1)
    z = (x[..., None] - means) * torch.exp(-log_scales)
    comp = log_p + z - log_scales - 2.0 * F.softplus(z)
    return torch.logsumexp(comp, dim=-1)


def mixlog_inv_cdf(y: Tensor, logits: Tensor, means: Tensor,
                   log_scales: Tensor, n_iter: int = 64) -> Tensor:
    """Invert ``cdf(x) = y`` by ``n_iter`` bisection steps on the bracket
    ``[min(means - 30 s), max(means + 30 s)]``; ``y`` is clipped to
    ``[_CLIP_LO, _CLIP_HI]`` first."""
    span = torch.exp(torch.clamp(log_scales, min=-7.0))
    lo = torch.amin(means - 30.0 * span, dim=-1)
    hi = torch.amax(means + 30.0 * span, dim=-1)
    log_y = torch.log(torch.clamp(y, _CLIP_LO, _CLIP_HI))
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_low = mixlog_logcdf(mid, logits, means, log_scales) < log_y
        lo, hi = torch.where(too_low, mid, lo), torch.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def _inv_sigmoid(x: Tensor) -> Tensor:
    return torch.log(x) - torch.log1p(-x)


class MixLogisticCDFCoupling(Bijector):
    """Flow++ coupling: ``y2 = logit(MixLogCDF(x2)) * exp(log_s) + t``
    with ``(log_s, t, mixture params) = net(x1, context)``; ``net`` is
    registered as ``net``.

    ``split='channel'`` halves the channels, ``'checkerboard'``
    interleaves along the width (even and odd columns);
    ``split_state`` swaps the roles of the halves. NHWC tensors.
    """

    name = "mixlogcdf_coupling"

    def __init__(self, net: torch.nn.Module, split: str = "channel",
                 split_state: int = 0):
        super().__init__()
        if split not in ("channel", "checkerboard"):
            raise ValueError("split should be 'channel' or 'checkerboard'")
        self.net = net
        self.split = split
        self.split_state = split_state

    def _split(self, x):
        if self.split == "channel":
            x1, x2 = x.chunk(2, dim=-1)
        else:
            N, H, W, C = x.shape
            r = x.reshape(N, H, W // 2, 2, C)
            x1, x2 = r[:, :, :, 0], r[:, :, :, 1]
        return (x2, x1) if self.split_state else (x1, x2)

    def _merge(self, y1, y2, shape):
        if self.split_state:
            y1, y2 = y2, y1
        if self.split == "channel":
            return torch.cat([y1, y2], dim=-1)
        return torch.stack([y1, y2], dim=3).reshape(shape)

    def init_params(self, x, generator=None):
        self.net.reset_parameters(generator)

    def forward(self, x, noise=None, context: Optional[Tensor] = None):
        x1, x2 = self._split(x)
        log_s, t, logits, means, log_scales = self.net(x1, context)
        with span("mixlog"):
            log_cdf = mixlog_logcdf(x2, logits, means, log_scales)
            u = torch.clamp(torch.exp(log_cdf), _CLIP_LO, _CLIP_HI)
            y2 = _inv_sigmoid(u) * torch.exp(log_s) + t
            # d y2 / d x2 = pdf(x2) / (u (1 - u)) * exp(log_s)
            ld = (mixlog_logpdf(x2, logits, means, log_scales)
                  - torch.log(u) - torch.log1p(-u) + log_s)
        return self._merge(x1, y2, x.shape), sum_event(ld)

    def inverse(self, y, context: Optional[Tensor] = None):
        y1, y2 = self._split(y)
        log_s, t, logits, means, log_scales = self.net(y1, context)
        u = torch.sigmoid((y2 - t) * torch.exp(-log_s))
        x2 = mixlog_inv_cdf(u, logits, means, log_scales)
        u_c = torch.clamp(u, _CLIP_LO, _CLIP_HI)
        ld = (mixlog_logpdf(x2, logits, means, log_scales)
              - torch.log(u_c) - torch.log1p(-u_c) + log_s)
        return self._merge(y1, x2, y.shape), sum_event(ld)
