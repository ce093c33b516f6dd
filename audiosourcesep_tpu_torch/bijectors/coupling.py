"""Affine coupling bijectors, Glow's split form and RealNVP's masked form (port of ``audiosourcesep_tpu/bijectors/coupling.py``)."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .basic import ActNorm
from .core import Bijector, Chain, sum_event


class AffineCouplingSplit(Bijector):
    """Glow-style coupling: split the channels in halves ``xa | xb``,
    ``ya = exp(log_s(xb)) * xa + t(xb)``; log-det ``sum(log_s)``. ``net``
    maps ``xb`` to ``(log_s, t)`` and is registered as ``net``."""

    name = "coupling_split"

    def __init__(self, net: torch.nn.Module):
        super().__init__()
        self.net = net

    def init_params(self, x, generator=None):
        if hasattr(self.net, "reset_parameters"):
            self.net.reset_parameters(generator)

    def forward(self, x, noise=None):
        xa, xb = x.chunk(2, dim=-1)
        log_s, t = self.net(xb)
        return (torch.cat([torch.exp(log_s) * xa + t, xb], dim=-1),
                sum_event(log_s))

    def inverse(self, y):
        ya, yb = y.chunk(2, dim=-1)
        log_s, t = self.net(yb)
        return (torch.cat([(ya - t) * torch.exp(-log_s), yb], dim=-1),
                sum_event(log_s))


def binary_mask(shape: Sequence[int], masking: str, mask_state: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """Binary coupling mask of event shape ``(H, W, C)``.

    ``masking='channel'``: the first half of the channels is 1;
    ``'checkerboard'``: ``(i + j) % 2`` over H, W, the same for every
    channel. ``mask_state`` 0 takes the complement.
    """
    H, W, C = shape
    if masking == "channel":
        if C % 2:
            raise ValueError(f"channel masking needs an even C, got {C}")
        m = torch.zeros(H, W, C, dtype=dtype, device=device)
        m[..., :C // 2] = 1.0
    elif masking == "checkerboard":
        ij = (torch.arange(H, device=device)[:, None]
              + torch.arange(W, device=device)[None, :]) % 2
        m = ij[:, :, None].to(dtype).expand(H, W, C).contiguous()
    else:
        raise ValueError("masking should be 'channel' or 'checkerboard'")
    return m if mask_state else 1.0 - m


class AffineCouplingMasked(Bijector):
    """RealNVP-style masked coupling: ``y = b*x + (1-b) * (x*exp(log_s) +
    t)`` with ``(log_s, t) = net(x*b)``; log-det ``sum(log_s * (1-b))``.
    ``net`` is registered as ``net``."""

    name = "coupling_masked"

    def __init__(self, net: torch.nn.Module, masking: str = "channel",
                 mask_state: int = 0):
        super().__init__()
        self.net = net
        self.masking = masking
        self.mask_state = mask_state

    def _mask(self, x):
        return binary_mask(x.shape[1:], self.masking, self.mask_state,
                           x.dtype, x.device)

    def init_params(self, x, generator=None):
        if hasattr(self.net, "reset_parameters"):
            self.net.reset_parameters(generator)

    def forward(self, x, noise=None):
        b = self._mask(x)
        log_s, t = self.net(x * b)
        return (b * x + (1.0 - b) * (x * torch.exp(log_s) + t),
                sum_event(log_s * (1.0 - b)))

    def inverse(self, y):
        b = self._mask(y)
        log_s, t = self.net(y * b)
        return (b * y + (1.0 - b) * ((y - t) * torch.exp(-log_s)),
                sum_event(log_s * (1.0 - b)))


def stacked_masked_couplings(n_layers: int,
                             make_net: Callable[[], torch.nn.Module],
                             masking: str, channels: int,
                             name: str = "stacked_couplings",
                             device=None) -> Chain:
    """``n_layers`` masked couplings with alternating masks (state ``i %
    2``), each followed by an ActNorm over ``channels`` channels."""
    layers = []
    for i in range(n_layers):
        layers.append(AffineCouplingMasked(make_net(), masking, i % 2))
        layers.append(ActNorm(channels, device=device))
    return Chain(layers, name=name)
