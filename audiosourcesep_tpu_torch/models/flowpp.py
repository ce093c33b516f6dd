"""Flow++: coupling layers, blocks, the CIFAR-10 topology and variational dequantisation (port of ``audiosourcesep_tpu/models/flowpp.py``).

As in the JAX package, each coupling layer composes ActNorm, the
invertible 1x1 conv and the mixture-of-logistics coupling, and the split
parity alternates from layer to layer. Module names follow the JAX
params' keys.

``build_flowpp(data_type="melspec")`` is the port's own: the same
bijector over continuous mel frames in dB, as a BASIS prior. It rescales
as the melspec Glow does and has no dequantisation, which exists for
discrete data.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..bijectors import (ActNorm, Bijector, Chain, FlowModel,
                         ImgPreprocessing, Invertible1x1Conv,
                         IsotropicNormalPrior, SpecPreprocessing, Squeeze)
from ..bijectors.flowpp_nets import ConvAttnNet, ShallowProcessor
from ..bijectors.mixlogcdf import MixLogisticCDFCoupling

_LOG_2PI = math.log(2.0 * math.pi)
# the context of the dequantisation flow: ShallowProcessor's width
_CONTEXT_CH = 32


class FlowppCouplingLayer(Bijector):
    """ActNorm (per element) -> invertible 1x1 conv -> mixture-of-logistics
    coupling on NHWC inputs of ``input_shape``; ``context`` reaches the
    coupling net (the dequantisation flow's)."""

    name = "flowpp_coupling"

    def __init__(self, input_shape: Sequence[int], split: str = "channel",
                 split_state: int = 0, n_components: int = 32,
                 n_blocks: int = 10, filters: int = 96, heads: int = 4,
                 context_ch: int = 0, device=None):
        super().__init__()
        H, W, C = input_shape
        nn_shape = (H, W, C // 2) if split == "channel" else (H, W // 2, C)
        self.actnorm = ActNorm(tuple(input_shape), normalize="all",
                               device=device)
        self.inv1x1 = Invertible1x1Conv(C, device=device)
        self.coupling = MixLogisticCDFCoupling(
            ConvAttnNet(nn_shape, n_components, n_blocks, filters,
                        context_ch, heads, device=device), split, split_state)

    @torch.no_grad()
    def init(self, x, generator=None):
        # the data-dependent init runs without context, as in the JAX
        # package
        x = self.actnorm.init(x, generator)
        x = self.inv1x1.init(x, generator)
        return self.coupling.init(x, generator)

    def init_params(self, x, generator=None):
        self.init(x, generator)

    def forward(self, x, noise=None, context=None):
        x, ld1 = self.actnorm(x)
        x, ld2 = self.inv1x1(x)
        x, ld3 = self.coupling(x, context=context)
        return x, ld1 + ld2 + ld3

    def inverse(self, y, context=None):
        y, ld3 = self.coupling.inverse(y, context=context)
        y, ld2 = self.inv1x1.inverse(y)
        y, ld1 = self.actnorm.inverse(y)
        return y, ld1 + ld2 + ld3


class FlowppBlock(Bijector):
    """``n_layers`` Flow++ coupling layers (``layer_{i}``) with split
    parity ``i % 2``."""

    name = "flowpp_block"

    def __init__(self, input_shape: Sequence[int], n_layers: int,
                 split: str = "channel", n_components: int = 32,
                 n_blocks: int = 10, filters: int = 96, heads: int = 4,
                 context_ch: int = 0, device=None):
        super().__init__()
        for i in range(n_layers):
            self.add_module(f"layer_{i}", FlowppCouplingLayer(
                input_shape, split, i % 2, n_components, n_blocks, filters,
                heads, context_ch, device=device))

    @torch.no_grad()
    def init(self, x, generator=None):
        for layer in self.children():
            x = layer.init(x, generator)
        return x

    def init_params(self, x, generator=None):
        self.init(x, generator)

    def forward(self, x, noise=None, context=None):
        total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for layer in self.children():
            x, ld = layer(x, context=context)
            total = total + ld
        return x, total

    def inverse(self, y, context=None):
        total = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
        for layer in reversed(list(self.children())):
            y, ld = layer.inverse(y, context=context)
            total = total + ld
        return y, total


class FlowppCifar10(Bijector):
    """The Flow++ CIFAR-10 topology: preprocessing (``prep``: the image
    logit, or the one given) -> 4 checkerboard couplings (``block1``) ->
    squeeze -> 2 channel couplings (``block2``) -> 3 checkerboard couplings
    (``block3``). Every stage is deterministic: the input is continuous
    (dequantised upstream, or so by nature), so ``noise`` is not read."""

    name = "flowpp_cifar10"

    def __init__(self, input_shape: Sequence[int], n_components: int = 32,
                 n_blocks: int = 10, filters: int = 96, heads: int = 4,
                 alpha: float = 0.05, prep: Optional[Bijector] = None,
                 device=None):
        super().__init__()
        H, W, C = input_shape
        squeezed = (H // 2, W // 2, 4 * C)
        cfg = dict(n_components=n_components, n_blocks=n_blocks,
                   filters=filters, heads=heads, device=device)
        self.prep = prep if prep is not None else ImgPreprocessing(
            alpha=alpha, use_logit=True)
        self.block1 = FlowppBlock(input_shape, 4, "checkerboard", **cfg)
        self.squeeze = Squeeze()
        self.block2 = FlowppBlock(squeezed, 2, "channel", **cfg)
        self.block3 = FlowppBlock(squeezed, 3, "checkerboard", **cfg)

    @torch.no_grad()
    def init(self, x, generator=None):
        for stage in self.children():
            x = stage.init(x, generator)
        return x

    def init_params(self, x, generator=None):
        self.init(x, generator)

    def forward(self, x, noise=None):
        total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for stage in self.children():
            x, ld = stage(x)
            total = total + ld
        return x, total

    def inverse(self, y):
        total = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
        for stage in reversed(list(self.children())):
            y, ld = stage.inverse(y)
            total = total + ld
        return y, total


class VariationalDequant(Bijector):
    """Flow-based variational dequantisation.

    ``forward(x, noise)``: ``noise`` is ``eps ~ N(0, 1)`` of ``x``'s
    shape; ``eps`` goes through a context-conditioned Flow++ block
    (``block``; the context is ``processor`` of the data, its even and
    odd columns side by side), is squashed into ``u`` in (0, 1) by a
    sigmoid and added to ``x``. The log-det is ``logdet(flow) +
    logdet(sigmoid) - log N(eps)``, so the model's ``log_prob`` is the
    variational dequantisation bound. Without ``noise``, ``eps`` is a
    fixed draw (a generator seeded 0 on ``x``'s device), as the JAX
    package uses a fixed key. The inverse drops the noise.
    """

    name = "variational_dequant"

    def __init__(self, input_shape: Sequence[int], n_components: int = 32,
                 n_blocks: int = 2, filters: int = 96, heads: int = 4,
                 device=None):
        super().__init__()
        C = input_shape[-1]
        self.processor = ShallowProcessor(2 * C, _CONTEXT_CH, device=device)
        self.block = FlowppBlock(input_shape, 4, "checkerboard",
                                 n_components, n_blocks, filters, heads,
                                 context_ch=_CONTEXT_CH, device=device)

    @torch.no_grad()
    def init(self, x, generator=None):
        self.processor.reset_parameters(generator)
        self.block.init(torch.randn(x.shape, generator=generator).to(x),
                        generator)
        eps = torch.randn(x.shape, generator=generator).to(x)
        return self.forward(x, eps)[0]

    def init_params(self, x, generator=None):
        self.init(x, generator)

    def _context(self, x):
        N, H, W, C = x.shape
        r = x.reshape(N, H, W // 2, 2, C)
        return self.processor(torch.cat([r[:, :, :, 0], r[:, :, :, 1]],
                                        dim=-1))

    def forward(self, x, noise: Optional[torch.Tensor] = None):
        if noise is None:
            noise = torch.randn(x.shape, dtype=x.dtype, device=x.device,
                                generator=torch.Generator(
                                    device=x.device).manual_seed(0))
        log_det_eps = torch.sum(-0.5 * (torch.square(noise) + _LOG_2PI),
                                dim=(1, 2, 3))
        v, ld = self.block(noise, context=self._context(x))
        # d sigmoid(v) / dv = sigmoid(v) * sigmoid(-v)
        ld_sig = torch.sum(F.logsigmoid(v) + F.logsigmoid(-v),
                           dim=(1, 2, 3))
        return x + torch.sigmoid(v), ld + ld_sig - log_det_eps

    def inverse(self, y):
        return y, torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)


def build_flowpp(data_shape: Sequence[int], n_components: int = 32,
                 n_blocks_flow: int = 10, n_blocks_dequant: int = 2,
                 filters: int = 96, heads: int = 4,
                 data_type: str = "image", minval: float = -100.0,
                 maxval: float = 20.0,
                 minibatch: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> FlowModel:
    """The Flow++ CIFAR-10 bijector over an isotropic prior on ``(H/2,
    W/2, 4C)``; the defaults are Ho et al.'s CIFAR-10 configuration. With
    ``minibatch`` it is initialised from it and ``generator``.

    ``data_type='image'``: variational dequantisation, then the image
    logit; the model's ``noise`` is the dequantisation's standard-normal
    ``eps``. Anything else: continuous data in ``[minval, maxval]`` (mel
    dB), rescaled to ``(x - minval) / (maxval - minval) - 0.5`` with no
    logit (``SpecPreprocessing``, as ``build_glow`` rescales a mel frame)
    and no dequantisation (``n_blocks_dequant`` is not read): the model
    draws no noise (``noise="none"``). Its score's traced capture times
    each attention core and mixture (``attn``, ``mixlog``)."""
    H, W, C = data_shape
    prior = IsotropicNormalPrior((H // 2, W // 2, 4 * C))
    if data_type == "image":
        dequant = VariationalDequant(data_shape, n_components,
                                     n_blocks_dequant, filters, heads,
                                     device=device)
        flow = FlowppCifar10(data_shape, n_components, n_blocks_flow,
                             filters, heads, device=device)
        model = FlowModel(Chain([dequant, flow], name="flowpp"), prior,
                          noise="normal")
    else:
        prep = SpecPreprocessing(minval=minval, maxval=maxval,
                                 use_logit=False)
        flow = FlowppCifar10(data_shape, n_components, n_blocks_flow,
                             filters, heads, prep=prep, device=device)
        model = FlowModel(Chain([flow], name="flowpp"), prior,
                          noise="none", traced_leaves=("attn", "mixlog"))
    if minibatch is not None:
        model.init(minibatch, generator)
    return model
