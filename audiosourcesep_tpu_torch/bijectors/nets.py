"""Coupling networks (port of ``audiosourcesep_tpu/bijectors/nets.py``).

A net is a ``torch.nn.Module`` mapping NHWC ``x`` (or ``[N, D]`` for the
dense net) to ``(log_s, t)``, each of ``x``'s shape, with ``tanh`` on
``log_s``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import nn


class ShiftAndLogScaleConvNet(torch.nn.Module):
    """conv3(relu) - norm - conv1(relu) - norm - conv3(zero-init) -> split.

    The zero-initialised last conv makes each coupling start as the
    identity (Glow); the norms are frozen batch norms. Inside,
    activations are NCHW views in ``channels_last`` memory: the 3x3 convs
    go through :func:`nn.conv2d` (the Winograd kernel when routing is
    on), the 1x1 conv is one matmul over the channels
    (:func:`nn.conv1x1`). The first two convs run without their bias,
    which goes into one op with the relu and the norm after each
    (:func:`nn.bias_relu_frozen_batchnorm`).
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
        c1 = self.conv1
        h = nn.conv2d(x.permute(0, 3, 1, 2), c1.kernel, None, c1.dilation,
                      c1._winograd_cache)
        h = self.bn1.after_bias_relu(h, c1.bias)
        h = self.bn2.after_bias_relu(nn.conv1x1(h, self.conv2.kernel),
                                     self.conv2.bias)
        log_s, t = self.conv3(h).permute(0, 2, 3, 1).chunk(2, dim=-1)
        return torch.tanh(log_s), t


class _ResBlock(torch.nn.Module):
    """norm -> relu -> wnconv (no bias) -> norm -> relu -> wnconv, plus
    the input."""

    def __init__(self, f: int, device=None):
        super().__init__()
        self.bn1 = nn.FrozenBatchNorm(f, device=device)
        self.conv1 = nn.WNConv2d(f, f, 3, use_bias=False, device=device)
        self.bn2 = nn.FrozenBatchNorm(f, device=device)
        self.conv2 = nn.WNConv2d(f, f, 3, device=device)

    def forward(self, x):
        h = self.conv1(nn.relu(self.bn1(x)))
        return x + self.conv2(nn.relu(self.bn2(h)))


class ShiftAndLogScaleResNet(torch.nn.Module):
    """RealNVP coupling net: weight-normalised convs, ``n_blocks``
    residual blocks whose outputs accumulate into a skip path, and a
    zero-initialised output conv (each coupling starts as the identity).

    norm -> concat(h, -h) -> relu -> conv_in; skip = skip_in(h); per
    block ``h = block_i(h)``, ``skip += skip_i(h)``; norm -> relu ->
    conv_out -> split. The convs are :func:`nn.wnconv2d` (``F.conv2d``,
    as the JAX ``wnconv2d`` is never routed), on an NCHW view of the NHWC
    input.
    """

    def __init__(self, in_ch: int, n_filters: int, n_blocks: int = 4,
                 device=None):
        super().__init__()
        f = n_filters
        self.n_blocks = n_blocks
        self.bn_in = nn.FrozenBatchNorm(in_ch, device=device)
        self.conv_in = nn.WNConv2d(2 * in_ch, f, 3, device=device)
        self.skip_in = nn.WNConv2d(f, f, 3, device=device)
        self.bn_out = nn.FrozenBatchNorm(f, device=device)
        self.conv_out = nn.WNConv2d(f, 2 * in_ch, 3, device=device)
        for i in range(n_blocks):
            self.add_module(f"block_{i}", _ResBlock(f, device))
            self.add_module(f"skip_{i}", nn.WNConv2d(f, f, 3,
                                                     device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, nn.FrozenBatchNorm):
                m.reset_parameters()
            elif isinstance(m, nn.WNConv2d):
                m.reset_parameters(generator, zero_init=m is self.conv_out)

    def forward(self, x: torch.Tensor):
        h = self.bn_in(x.permute(0, 3, 1, 2))
        h = self.conv_in(nn.relu(torch.cat([h, -h], dim=1)))
        skip = self.skip_in(h)
        for i in range(self.n_blocks):
            h = self._modules[f"block_{i}"](h)
            skip = skip + self._modules[f"skip_{i}"](h)
        out = self.conv_out(nn.relu(self.bn_out(skip)))
        log_s, t = out.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return torch.tanh(log_s), t


class ShiftAndLogScaleDenseNet(torch.nn.Module):
    """4 relu dense layers and a linear head -> ``(log_s, t)`` for 1-D
    events ``[N, D]``."""

    def __init__(self, in_dim: int, units: int, device=None):
        super().__init__()
        dims = [in_dim] + [units] * 4
        for i in range(4):
            self.add_module(f"dense{i + 1}", nn.Dense(dims[i], dims[i + 1],
                                                      device=device))
        self.dense5 = nn.Dense(units, 2 * in_dim, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.children():
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        h = x
        for i in range(4):
            h = nn.relu(self._modules[f"dense{i + 1}"](h))
        log_s, t = self.dense5(h).chunk(2, dim=-1)
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
