"""Flow++ conv-attention coupling networks (port of ``audiosourcesep_tpu/bijectors/flowpp_nets.py``).

GLU gates, gated convs (PixelCNN++ style), gated multi-head
self-attention with a shared position embedding, and the ConvAttnNet
head that emits ``(log_s, t, mixture-of-logistics params)``. Tensors are
NHWC, as in the JAX package: dense layers and layer norms act on the
channels (the last axis); the 3x3 convs get an NCHW view of the NHWC
tensor through :func:`nn.conv2d` (``channels_last`` memory, so the
Winograd kernel takes them without a copy when routing is on). The
attention core is :func:`ops.attention.attention` (the JAX package's two
einsums and a softmax, memory-linear on the card), each call a module
span ``attn``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .. import nn
from ..ops.attention import attention
from ..utils.profiling import span

Tensor = torch.Tensor


def _conv(conv: nn.Conv2d, x: Tensor) -> Tensor:
    """``conv`` of NHWC ``x``, NHWC out."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def concat_elu(x: Tensor) -> Tensor:
    """``elu(concat(-x, x))`` over the channels."""
    return F.elu(torch.cat([-x, x], dim=-1))


def _reset(module: torch.nn.Module, generator) -> None:
    """Reset every parameterised submodule: Glorot convs and dense
    layers, unit layer norms."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Dense)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()


class GLU(torch.nn.Module):
    """Gated linear unit: dense (or a 3x3 conv) to ``filters`` channels,
    split, ``a * sigmoid(b)``; the layer is registered as ``layer``."""

    def __init__(self, in_ch: int, filters: int, use_nin: bool = True,
                 device=None):
        super().__init__()
        if filters % 2:
            raise ValueError(f"GLU needs an even filter count, got {filters}")
        self.use_nin = use_nin
        self.layer = (nn.Dense(in_ch, filters, device=device) if use_nin
                      else nn.Conv2d(in_ch, filters, 3, device=device))

    def forward(self, x: Tensor) -> Tensor:
        h = self.layer(x) if self.use_nin else _conv(self.layer, x)
        a, b = h.chunk(2, dim=-1)
        return a * torch.sigmoid(b)


class GatedConv(torch.nn.Module):
    """``x + GLU(concat_elu(conv1(concat_elu(x)) [+ ctx(context)]))`` on
    ``in_ch`` channels; ``in_ch == filters`` wherever the flows use it."""

    def __init__(self, in_ch: int, filters: int, context_ch: int = 0,
                 use_nin: bool = True, device=None):
        super().__init__()
        self.conv1 = nn.Conv2d(2 * in_ch, filters, 3, device=device)
        self.glu = GLU(2 * filters, 2 * filters, use_nin, device=device)
        self.ctx = (nn.Dense(context_ch, filters, device=device)
                    if context_ch else None)

    def forward(self, x: Tensor, a: Optional[Tensor] = None) -> Tensor:
        c = _conv(self.conv1, concat_elu(x))
        if a is not None and self.ctx is not None:
            c = c + self.ctx(a)
        return x + self.glu(concat_elu(c))


class GatedAttn(torch.nn.Module):
    """``x + GLU(MHSA(x + pos_emb))``: ``heads`` heads of
    ``channels / heads`` over the H*W positions."""

    def __init__(self, channels: int, heads: int = 4, device=None):
        super().__init__()
        if channels % heads:
            raise ValueError(f"{channels} channels over {heads} heads")
        self.heads = heads
        self.dim = channels // heads
        self.qkv = nn.Dense(channels, 3 * channels, device=device)
        self.glu = GLU(channels, 2 * channels, device=device)

    def forward(self, x: Tensor, pos_emb: Tensor) -> Tensor:
        N, H, W, C = x.shape
        c = self.qkv(x + pos_emb[None]).reshape(N, H * W, 3, self.heads,
                                                self.dim)
        # [N, h, T, d] views of the projection
        q, k, v = c.permute(2, 0, 3, 1, 4).unbind(dim=0)
        with span("attn"):
            a = attention(q, k, v)
        return x + self.glu(a.transpose(1, 2).reshape(N, H, W, C))


class ConvAttnBlock(torch.nn.Module):
    """GatedConv -> layer norm -> GatedAttn -> layer norm."""

    def __init__(self, filters: int, context_ch: int = 0, heads: int = 4,
                 device=None):
        super().__init__()
        self.conv = GatedConv(filters, filters, context_ch, device=device)
        self.ln1 = nn.LayerNorm(filters, device=device)
        self.attn = GatedAttn(filters, heads, device=device)
        self.ln2 = nn.LayerNorm(filters, device=device)

    def forward(self, x, pos_emb, a=None):
        x = self.ln1(self.conv(x, a))
        return self.ln2(self.attn(x, pos_emb))


class ConvAttnNet(torch.nn.Module):
    """Flow++ coupling head on NHWC ``x`` of ``input_shape`` ``(H, W,
    C)``: ``conv_in`` (C -> filters), ``n_blocks`` conv-attention blocks
    (``block_{i}``, each reading ``context`` of ``context_ch`` channels
    when given), ``conv_out`` (filters -> C * (2 + 3K)). Returns ``log_s``
    (tanh), ``t`` and the K-component mixture's logits, means and log
    scales, each ``[N, H, W, C(, K)]``."""

    def __init__(self, input_shape: Sequence[int], n_components: int = 32,
                 n_blocks: int = 10, filters: int = 96,
                 context_ch: int = 0, heads: int = 4, device=None):
        super().__init__()
        H, W, C = input_shape
        self.n_components = n_components
        self.n_blocks = n_blocks
        self.pos_emb = torch.nn.Parameter(torch.empty(H, W, filters,
                                                      device=device))
        self.conv_in = nn.Conv2d(C, filters, 3, device=device)
        self.conv_out = nn.Conv2d(filters, C * (2 + 3 * n_components), 3,
                                  device=device)
        for i in range(n_blocks):
            self.add_module(f"block_{i}", ConvAttnBlock(
                filters, context_ch, heads, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.pos_emb.copy_(torch.randn(self.pos_emb.shape,
                                       generator=generator))
        _reset(self, generator)

    def forward(self, x: Tensor, context: Optional[Tensor] = None):
        h = _conv(self.conv_in, x)
        for i in range(self.n_blocks):
            h = self._modules[f"block_{i}"](h, self.pos_emb, context)
        h = _conv(self.conv_out, h)
        N, H, W, _ = h.shape
        h = h.reshape(N, H, W, -1, 2 + 3 * self.n_components)
        logits, means, log_scales = h[..., 2:].chunk(3, dim=-1)
        return torch.tanh(h[..., 0]), h[..., 1], logits, means, log_scales


class ShallowProcessor(torch.nn.Module):
    """Context processor of the variational dequantisation: ``x / 256 -
    0.5`` -> 3x3 conv (``in_ch`` -> ``filters``) -> three gated convs
    (``gated_{i}``, their GLUs 3x3 convs)."""

    def __init__(self, in_ch: int, filters: int = 32, device=None):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, filters, 3, device=device)
        for i in range(3):
            self.add_module(f"gated_{i}", GatedConv(
                filters, filters, use_nin=False, device=device))

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        _reset(self, generator)

    def forward(self, x: Tensor) -> Tensor:
        h = _conv(self.conv, x / 256.0 - 0.5)
        for i in range(3):
            h = self._modules[f"gated_{i}"](h)
        return h
