"""RealNVP two-scale bijector (port of ``audiosourcesep_tpu/models/realnvp.py``).

Preprocessing -> 3 checkerboard couplings -> squeeze -> 3 channel
couplings -> factor out half the channels -> 4 checkerboard couplings on
the rest. The coupling nets are weight-normalised ResNets; each coupling
is followed by an ActNorm.
"""

from __future__ import annotations

import torch

from ..bijectors import (Bijector, Chain, ImgPreprocessing,
                         ShiftAndLogScaleResNet, Squeeze,
                         stacked_masked_couplings)


class RealNVP(Bijector):
    """RealNVP on NHWC images of ``channels`` channels. Registered as
    ``scale1`` (preprocessing, ``stack1``, squeeze, ``stack2``) and
    ``scale2``, the JAX params' keys; the latent is ``concat(z1, z2)``
    over channels at half the resolution, ``4 * channels`` deep."""

    name = "realnvp"

    def __init__(self, channels: int, n_filters: int = 32,
                 n_blocks: int = 4, alpha: float = 0.05,
                 preprocess: bool = True, device=None):
        super().__init__()

        def net(in_ch, f):
            return lambda: ShiftAndLogScaleResNet(in_ch, f, n_blocks,
                                                  device=device)

        c, f = channels, n_filters
        layers = [ImgPreprocessing(alpha=alpha)] if preprocess else []
        layers += [
            stacked_masked_couplings(3, net(c, f), "checkerboard", c,
                                     name="stack1", device=device),
            Squeeze(),
            stacked_masked_couplings(3, net(4 * c, 2 * f), "channel",
                                     4 * c, name="stack2", device=device),
        ]
        self.scale1 = Chain(layers, name="scale1")
        self.scale2 = stacked_masked_couplings(
            4, net(2 * c, 2 * f), "checkerboard", 2 * c, name="scale2",
            device=device)

    @torch.no_grad()
    def init(self, x, generator=None):
        z1, h1 = self.scale1.init(x, generator).chunk(2, dim=-1)
        return torch.cat([z1, self.scale2.init(h1, generator)], dim=-1)

    def init_params(self, x, generator=None):
        self.init(x, generator)

    def forward(self, x, noise=None):
        out, ld1 = self.scale1(x, noise)
        z1, h1 = out.chunk(2, dim=-1)
        z2, ld2 = self.scale2(h1)
        return torch.cat([z1, z2], dim=-1), ld1 + ld2

    def inverse(self, y):
        z1, z2 = y.chunk(2, dim=-1)
        h1, ld2 = self.scale2.inverse(z2)
        x, ld1 = self.scale1.inverse(torch.cat([z1, h1], dim=-1))
        return x, ld1 + ld2
