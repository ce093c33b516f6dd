"""Glow's affine coupling (port of ``AffineCouplingSplit`` in ``audiosourcesep_tpu/bijectors/coupling.py``).

The masked RealNVP couplings wait for the RealNVP port.
"""

from __future__ import annotations

import torch

from .core import Bijector, sum_event


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
