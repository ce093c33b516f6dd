"""NCSN RefineNet building blocks (port of ``audiosourcesep_tpu/models/ncsn/layers.py``).

``nn.Module``s over NCHW activations (kept in ``channels_last`` memory).
Parameter names follow the JAX param dicts exactly (``conv1.kernel``,
``norm1.embed_gamma``, ``norm1.in.gamma``, ``adapt_0.conv_1.kernel``, ...)
so ``training.checkpoint`` converts a JAX checkpoint with a rename-free
walk.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ... import nn
from ...ops import instnorm
from ...utils.profiling import spanned


# the composite of InstanceNorm2d+ with folded [N, C] rows, under the JAX
# package's name (the tests hold the two together)
_norm2dplus = instnorm.norm2dplus


def _norm(x, labels, tables, act):
    """InstanceNorm2d+ of ``x`` with ``tables`` (gamma, alpha, beta,
    in.gamma, in.beta), then ``act``: on a CUDA tensor the card's kernel
    (``ops.instnorm``) with an ``nn.elu`` ``act`` fused into it, any other
    ``act`` after it; on the CPU the composite with ``act`` after it."""
    if not x.is_cuda:
        return instnorm.composite(x, labels, *tables, act=act)
    fused = act is nn.elu
    out = instnorm.instnorm_plus(x, labels, *tables, elu=fused)
    return out if act is None or fused else act(out)


# ---------------------------------------------------------------------------
# normalisers
# ---------------------------------------------------------------------------

class _InstanceNormAffine(torch.nn.Module):
    """The inner instance norm's ``gamma``/``beta`` (JAX ``params["in"]``)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.gamma = torch.nn.Parameter(torch.empty(num_features,
                                                    device=device))
        self.beta = torch.nn.Parameter(torch.empty(num_features,
                                                   device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.gamma.fill_(1.0)
        self.beta.zero_()


class InstanceNorm2dPlus(torch.nn.Module):
    """InstanceNorm2d+ (v2, unconditional):
    ``out = gamma * IN(x) + norm(mean_c(x)) * alpha + beta``."""

    def __init__(self, num_features: int, bias: bool = True, device=None):
        super().__init__()
        self.num_features = num_features
        self.add_module("in", _InstanceNormAffine(num_features, device))
        self.alpha = torch.nn.Parameter(torch.empty(num_features,
                                                    device=device))
        self.gamma = torch.nn.Parameter(torch.empty(num_features,
                                                    device=device))
        self.beta = (torch.nn.Parameter(torch.empty(num_features,
                                                    device=device))
                     if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.alpha.copy_(nn.normal_init(self.alpha.shape, 0.02, generator))
        self.gamma.copy_(nn.normal_init(self.gamma.shape, 0.02, generator))
        if self.beta is not None:
            self.beta.zero_()

    @spanned("norm")
    def forward(self, x, y=None, act=None):
        inn = self._modules["in"]
        return _norm(x, None, (self.gamma, self.alpha, self.beta, inn.gamma,
                               inn.beta), act)


class ConditionalInstanceNorm2dPlus(torch.nn.Module):
    """InstanceNorm2d+ with per-noise-level (gamma, alpha, beta)
    embeddings (v1)."""

    def __init__(self, num_features: int, num_classes: int,
                 bias: bool = True, device=None):
        super().__init__()
        self.add_module("in", _InstanceNormAffine(num_features, device))
        shape = (num_classes, num_features)
        self.embed_gamma = torch.nn.Parameter(torch.empty(shape,
                                                          device=device))
        self.embed_alpha = torch.nn.Parameter(torch.empty(shape,
                                                          device=device))
        self.embed_beta = (torch.nn.Parameter(torch.empty(shape,
                                                          device=device))
                           if bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.embed_gamma.copy_(nn.normal_init(self.embed_gamma.shape, 0.02,
                                              generator))
        self.embed_alpha.copy_(nn.normal_init(self.embed_alpha.shape, 0.02,
                                              generator))
        if self.embed_beta is not None:
            self.embed_beta.zero_()

    @spanned("norm")
    def forward(self, x, y, act=None):
        inn = self._modules["in"]
        return _norm(x, y, (self.embed_gamma, self.embed_alpha,
                            self.embed_beta, inn.gamma, inn.beta), act)


def make_normalizer(num_features: int, num_classes: Optional[int],
                    bias: bool = True, device=None) -> torch.nn.Module:
    if num_classes is None:
        return InstanceNorm2dPlus(num_features, bias, device)
    return ConditionalInstanceNorm2dPlus(num_features, num_classes, bias,
                                         device)


# ---------------------------------------------------------------------------
# residual blocks
# ---------------------------------------------------------------------------

class ResidualBlock(torch.nn.Module):
    """Conditional/unconditional residual block. ``resample='down'``
    without dilation halves the resolution by average pooling; dilated
    variants keep it."""

    def __init__(self, input_dim: int, output_dim: int,
                 num_classes: Optional[int], resample: Optional[str] = None,
                 dilation: Optional[int] = None, act=nn.elu, device=None):
        super().__init__()
        self.resample = resample
        self.dilation = dilation
        self.act = act
        d = dilation or 1
        self.norm1 = make_normalizer(input_dim, num_classes, device=device)
        self.norm2 = make_normalizer(
            input_dim if resample == "down" else output_dim, num_classes,
            device=device)
        identity_shortcut = output_dim == input_dim and resample is None
        conv = lambda i, o, k, b: nn.Conv2d(i, o, k, b, d, device)
        mid = input_dim if resample == "down" else output_dim
        if dilation is not None:
            self.conv1 = conv(input_dim, mid, 3, True)
            self.conv2 = conv(mid, output_dim, 3, True)
            shortcut = (3, True)
        elif resample == "down":
            self.conv1 = conv(input_dim, mid, 3, False)
            self.conv2 = conv(mid, output_dim, 3, True)
            shortcut = (1, True)
        else:
            self.conv1 = conv(input_dim, mid, 3, False)
            self.conv2 = conv(mid, output_dim, 3, False)
            shortcut = (3, False)
        # identity-shortcut blocks have no shortcut conv (dilated ones too:
        # the reference's Keras layer stays unbuilt -> no variables)
        self.shortcut = (None if identity_shortcut
                         else conv(input_dim, output_dim, *shortcut))

    def forward(self, x, y=None):
        pool = self.resample == "down" and self.dilation is None
        h = self.conv1(self.norm1(x, y, act=self.act))
        h = self.conv2(self.norm2(h, y, act=self.act))
        if pool:
            h = nn.avg_pool2(h)
        if self.shortcut is None:
            shortcut = x
        else:
            shortcut = self.shortcut(x)
            if pool:
                shortcut = nn.avg_pool2(shortcut)
        return shortcut + h


# ---------------------------------------------------------------------------
# RefineNet blocks (CRP / RCU / MSF)
# ---------------------------------------------------------------------------

class CRPBlock(torch.nn.Module):
    """Chained residual pooling. v1 (conditional): norm -> 5x5 average
    pooling -> conv per stage; v2: 5x5 max pooling -> conv."""

    def __init__(self, features: int, n_stages: int,
                 num_classes: Optional[int], act=nn.elu, device=None):
        super().__init__()
        self.n_stages = n_stages
        self.conditional = num_classes is not None
        self.act = act
        for i in range(n_stages):
            self.add_module(f"conv_{i}", nn.Conv2d(features, features, 3,
                                                   False, device=device))
            if self.conditional:
                self.add_module(f"norm_{i}", make_normalizer(
                    features, num_classes, device=device))

    def forward(self, x, y=None):
        x = self.act(x)
        path = x
        for i in range(self.n_stages):
            if self.conditional:
                path = self._modules[f"norm_{i}"](path, y)
                path = nn.avg_pool_same(path, 5)
            else:
                path = nn.max_pool_same(path, 5)
            path = self._modules[f"conv_{i}"](path)
            x = x + path
        return x


class RCUBlock(torch.nn.Module):
    """Residual conv unit: v1 (norm -> conv) x n_stages per block, v2
    conv x n_stages (no activations, as in the reference)."""

    def __init__(self, features: int, n_blocks: int, n_stages: int,
                 num_classes: Optional[int], act=nn.elu, device=None):
        super().__init__()
        self.n_blocks = n_blocks
        self.n_stages = n_stages
        self.conditional = num_classes is not None
        for i in range(n_blocks * n_stages):
            self.add_module(f"conv_{i}", nn.Conv2d(features, features, 3,
                                                   False, device=device))
            if self.conditional:
                self.add_module(f"norm_{i}", make_normalizer(
                    features, num_classes, device=device))

    def forward(self, x, y=None):
        for i in range(self.n_blocks):
            residual = x
            for j in range(self.n_stages):
                k = i * self.n_stages + j
                if self.conditional:
                    x = self._modules[f"norm_{k}"](x, y)
                x = self._modules[f"conv_{k}"](x)
            x = x + residual
        return x


class MSFBlock(torch.nn.Module):
    """Multi-resolution fusion: per input (norm ->) conv -> bilinear resize
    -> sum."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 num_classes: Optional[int], device=None):
        super().__init__()
        self.n_inputs = len(in_planes)
        self.conditional = num_classes is not None
        for i, c in enumerate(in_planes):
            self.add_module(f"conv_{i}", nn.Conv2d(c, features, 3, True,
                                                   device=device))
            if self.conditional:
                self.add_module(f"norm_{i}", make_normalizer(
                    c, num_classes, device=device))

    def forward(self, xs: List[torch.Tensor], shape, y=None):
        total = None
        for i, h in enumerate(xs):
            if self.conditional:
                h = self._modules[f"norm_{i}"](h, y)
            h = nn.resize_bilinear(self._modules[f"conv_{i}"](h), shape)
            total = h if total is None else total + h
        return total


class RefineBlock(torch.nn.Module):
    """RefineNet decoder block: per-input RCUs -> MSF -> CRP -> output
    RCU."""

    def __init__(self, in_planes: Sequence[int], features: int,
                 num_classes: Optional[int], act=nn.elu, start: bool = False,
                 end: bool = False, device=None):
        super().__init__()
        self.n_inputs = len(in_planes)
        for i, c in enumerate(in_planes):
            self.add_module(f"adapt_{i}", RCUBlock(c, 2, 2, num_classes, act,
                                                   device))
        self.output = RCUBlock(features, 3 if end else 1, 2, num_classes,
                               act, device)
        self.msf = (None if start
                    else MSFBlock(in_planes, features, num_classes, device))
        self.crp = CRPBlock(features, 2, num_classes, act, device)

    def forward(self, xs: List[torch.Tensor], shape, y=None):
        hs = [self._modules[f"adapt_{i}"](x, y) for i, x in enumerate(xs)]
        h = self.msf(hs, shape, y) if len(hs) > 1 else hs[0]
        return self.output(self.crp(h, y), y)
