"""Coupling networks (port of ``ShiftAndLogScaleConvNet`` and ``ConstantShiftAndLogScale`` in ``audiosourcesep_tpu/bijectors/nets.py``).

A net is a ``torch.nn.Module`` mapping NHWC ``x`` to ``(log_s, t)``, each
of ``x``'s shape, with ``tanh`` on ``log_s``. The ResNet and dense nets
wait for the RealNVP port.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn


class ShiftAndLogScaleConvNet(torch.nn.Module):
    """conv3(relu) - norm - conv1(relu) - norm - conv3(zero-init) -> split.

    The zero-initialised last conv makes each coupling start as the
    identity (Glow); the norms are :func:`nn.frozen_batchnorm`. Inside,
    activations are NCHW views in ``channels_last`` memory: the 3x3 convs
    go through :func:`nn.conv2d` (the Winograd kernel when routing is
    on), the 1x1 conv is one matmul over the channels
    (:func:`nn.conv1x1`).
    """

    def __init__(self, in_ch: int, n_filters: int, out_ch_factor: int = 2,
                 device=None):
        super().__init__()
        f = n_filters
        self.conv1 = nn.Conv2d(in_ch, f, 3, device=device)
        self.bn1 = nn.FrozenBatchNorm(f, device=device)
        self.conv2 = nn.Conv2d(f, f, 1, device=device)
        self.bn2 = nn.FrozenBatchNorm(f, device=device)
        self.conv3 = nn.Conv2d(f, out_ch_factor * in_ch, 3, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.conv1.reset_parameters(generator)
        self.conv2.reset_parameters(generator)
        self.conv3.kernel.zero_()
        self.conv3.bias.zero_()
        self.bn1.reset_parameters()
        self.bn2.reset_parameters()

    def forward(self, x: torch.Tensor):
        h = torch.relu(self.conv1(x.permute(0, 3, 1, 2)))
        h = self.bn1(h)
        h = torch.relu(nn.conv1x1(h, self.conv2.kernel, self.conv2.bias))
        h = self.bn2(h)
        log_s, t = self.conv3(h).permute(0, 2, 3, 1).chunk(2, dim=-1)
        return torch.tanh(log_s), t


class ConstantShiftAndLogScale(torch.nn.Module):
    """Deterministic test stub: ``log_s = log(2)``, ``t = 1`` everywhere,
    so analytic log-dets are exactly predictable."""

    def __init__(self, log_scale: float = 0.6931471805599453,
                 shift: float = 1.0):
        super().__init__()
        self.log_scale = log_scale
        self.shift = shift

    def forward(self, x: torch.Tensor):
        return (torch.full_like(x, self.log_scale),
                torch.full_like(x, self.shift))
