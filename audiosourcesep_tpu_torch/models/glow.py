"""Glow: step, block and multi-scale bijectors (port of ``audiosourcesep_tpu/models/glow.py``).

The JAX package's per-step ``remat`` flag is not ported: activation
checkpointing would be a separate choice here, made by measurement.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..bijectors import (ActNorm, AffineCouplingSplit, Bijector, Chain,
                         Invertible1x1Conv, ShiftAndLogScaleConvNet, Squeeze)

# net_factory(in_ch, device) -> a coupling net for in_ch channels
NetFactory = Callable[..., torch.nn.Module]


def glow_step(channels: int, net_factory: NetFactory,
              name: str = "glow_step", device=None) -> Chain:
    """actnorm -> invertible 1x1 conv -> affine coupling, on ``channels``
    channels."""
    return Chain([ActNorm(channels, device=device),
                  Invertible1x1Conv(channels, device=device),
                  AffineCouplingSplit(net_factory(channels // 2, device))],
                 name=name)


def glow_block(K: int, channels: int, net_factory: NetFactory,
               name: str = "glow_block", device=None) -> Chain:
    """squeeze -> K glow steps, for an input of ``channels`` channels."""
    return Chain([Squeeze()] + [glow_step(4 * channels, net_factory,
                                          device=device)
                                for _ in range(K)], name=name)


class GlowMultiScale(Bijector):
    """L-level multi-scale Glow with channel factor-out.

    After each of the first L-1 blocks, half the channels are factored
    out, reshaped (NHWC, a plain reshape, log-det 0) to the base spatial
    resolution and concatenated to the final latent: ``z = concat(z_1,
    ..., z_L)`` over channels at ``(H / 2^L, W / 2^L)``; base event shape
    ``(H/2^L, W/2^L, C * 4^L)``. Blocks are registered as ``block1`` ..
    ``blockL``; the init threads the minibatch through each block.
    """

    name = "glow_multiscale"

    def __init__(self, L: int, K: int, channels: int,
                 net_factory: NetFactory, device=None):
        super().__init__()
        if L < 2:
            raise ValueError(f"GlowMultiScale needs L >= 2, got {L}")
        self.L, self.K = L, K
        for l in range(L):
            # block l sees 2^l C channels: 4x by each squeeze, half kept
            self.add_module(f"block{l + 1}", glow_block(
                K, channels * 2 ** l, net_factory, name=f"block{l + 1}",
                device=device))

    @property
    def blocks(self):
        return list(self.children())

    def base_event_shape(self, data_shape):
        H, W, C = data_shape
        f = 2 ** self.L
        return (H // f, W // f, C * f * f)

    def _thread(self, x, run_block):
        """``run_block(block, h) -> out`` through the blocks, factoring
        out half of each block's output but the last's."""
        N, H, W, _ = x.shape
        bh, bw = H // 2 ** self.L, W // 2 ** self.L
        zs, h = [], x
        for l, block in enumerate(self.blocks):
            out = run_block(block, h)
            if l < self.L - 1:
                z, h = out.chunk(2, dim=-1)
                zs.append(z.reshape(N, bh, bw, -1))
            else:
                zs.append(out)
        return torch.cat(zs, dim=-1)

    @torch.no_grad()
    def init(self, x, generator=None):
        return self._thread(x, lambda b, h: b.init(h, generator))

    def init_params(self, x, generator=None):
        self.init(x, generator)

    @torch.no_grad()
    def reinit(self, x):
        return self._thread(x, lambda b, h: b.reinit(h))

    def forward(self, x, noise=None):
        fldjs = []

        def run(block, h):
            out, fldj = block(h, noise)
            fldjs.append(fldj)
            return out

        z = self._thread(x, run)
        total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for fldj in fldjs:
            total = total + fldj
        return z, total

    def inverse(self, y):
        N = y.shape[0]
        # the factored-out latents: [z1 | [z2 | [... | zL]]]
        zs, rem = [], y
        for _ in range(self.L - 1):
            z, rem = rem.chunk(2, dim=-1)
            zs.append(z)
        blocks = self.blocks
        h, total = blocks[-1].inverse(rem)
        for l in range(self.L - 2, -1, -1):
            # z_l lives at the spatial resolution of block l's output
            z = zs[l].reshape(N, *h.shape[1:])
            h, fldj = blocks[l].inverse(torch.cat([z, h], dim=-1))
            total = total + fldj
        return h, total


def make_conv_net_factory(n_filters: int) -> NetFactory:
    def factory(in_ch: int, device=None):
        return ShiftAndLogScaleConvNet(in_ch, n_filters, device=device)
    return factory
