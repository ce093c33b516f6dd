"""NN primitives of the NCSN score network and the flows' coupling nets (port of ``audiosourcesep_tpu/nn.py``).

Inside the models activations are NCHW tensors kept in
``torch.channels_last`` memory, which is physically NHWC: a
``.permute(0, 2, 3, 1)`` of one is a contiguous NHWC view, so the Winograd
kernel (NHWC in and out) needs no copy. Conv kernels (and the
weight-normalised convs' ``v``) are stored OIHW (PyTorch's layout);
``training.checkpoint`` converts from the JAX package's HWIO. Dense
kernels keep the JAX layout ``[in, out]``; :func:`dense` and
:func:`layer_norm` act on the last axis, the channels of the flows' NHWC
tensors.

Initialisation follows the JAX package (Keras defaults: Glorot-uniform
kernels, zero biases), drawn from an explicit ``torch.Generator``.

Each call of a conv, a norm, an activation, a pool or a resize is a module
span of that kind (``utils.profiling``: ``conv``, ``norm``, ``act``,
``pool``, ``resize``; a conv's Winograd weight transform on a cache miss
is ``conv.weights``), recorded while an anneal level is traced.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .ops import bias_relu_bn, pool
from .utils.profiling import span, spanned

# When enabled, every conv the Winograd kernel computes (3x3, stride 1,
# undilated, even H and W) routes through ops.winograd: on a CUDA tensor
# the Hopper kernel, on a CPU tensor its plain version. Dilated and all
# other convs stay on F.conv2d. Off by default, as in the JAX package.
_WINOGRAD = False


def set_winograd(enable: bool) -> None:
    global _WINOGRAD
    _WINOGRAD = bool(enable)


def winograd_enabled() -> bool:
    return _WINOGRAD


# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------

def glorot_uniform(shape: Sequence[int],
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """Keras-default Glorot/Xavier uniform for an OIHW conv kernel (or an
    ``[out, in]`` matrix)."""
    rf = math.prod(shape[2:])
    fan_in, fan_out = shape[1] * rf, shape[0] * rf
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype)
    return (2.0 * u - 1.0) * limit


def normal_init(shape: Sequence[int], stddev: float = 0.02,
                generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> torch.Tensor:
    return stddev * torch.randn(tuple(shape), generator=generator,
                                dtype=dtype)


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

@spanned("conv")
def conv2d(x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           dilation: int = 1, winograd_cache: Optional[dict] = None
           ) -> torch.Tensor:
    """SAME stride-1 conv of NCHW ``x`` with an OIHW ``kernel`` (odd size).

    Weights are cast to ``x``'s dtype at use, as in the JAX package. With
    :func:`set_winograd` on, eligible convs run through the Winograd
    kernel; ``winograd_cache`` (a dict owned by the caller) then keeps the
    transformed weights on the card until ``kernel`` changes.
    """
    kh, kw = kernel.shape[2:]
    if kh != kw or kh % 2 == 0:
        raise ValueError(f"SAME conv needs an odd square kernel, got "
                         f"{tuple(kernel.shape)}")
    n, _, h, w = x.shape
    if _WINOGRAD:
        from .ops.winograd import winograd_conv2d, winograd_eligible
        kshape = (kh, kw, kernel.shape[1], kernel.shape[0])
        if winograd_eligible((n, h, w, x.shape[1]), kshape,
                             dilation=dilation):
            x_nhwc = x.contiguous(
                memory_format=torch.channels_last).permute(0, 2, 3, 1)
            hwio = kernel.permute(2, 3, 1, 0)
            if winograd_cache is not None and x.is_cuda:
                y = winograd_conv2d(x_nhwc, hwio, _winograd_weights(
                    winograd_cache, kernel, hwio, x.dtype))
            else:
                y = winograd_conv2d(x_nhwc, hwio)
            y = y.permute(0, 3, 1, 2)          # NCHW view, channels_last
            if bias is not None:
                y = y + bias.to(x.dtype)[:, None, None]
            return y
    pad = dilation * (kh // 2)
    return F.conv2d(x, kernel.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    padding=pad, dilation=dilation)


def _winograd_weights(cache: dict, kernel: torch.Tensor, hwio: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """``transform_weights(hwio)`` in ``dtype``, recomputed only when
    ``kernel`` is another tensor, was written in place (``_version``), moved
    (``data_ptr``), or ``dtype`` changes. The cache holds ``kernel`` itself,
    so its identity cannot pass to a new tensor.

    A miss while a CUDA graph captures raises: U computed then would live
    in the graph's memory pool, hold nothing until a replay, and stay in
    the cache for eager calls afterwards. An eager warm-up fills the cache
    first (``separation.graphs``)."""
    from .ops.winograd import transform_weights
    key = (kernel._version, kernel.data_ptr(), dtype)
    if cache.get("kernel") is not kernel or cache.get("key") != key:
        if torch.cuda.is_initialized() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "nn.conv2d: the Winograd weights of a conv are not cached "
                "while a CUDA graph captures; run the captured function "
                "once eagerly first")
        with torch.no_grad(), span("conv.weights"):
            cache["u"] = transform_weights(hwio).to(dtype)
        cache["kernel"], cache["key"] = kernel, key
    return cache["u"]


class Conv2d(torch.nn.Module):
    """SAME conv with parameters named as the JAX param dict
    (``kernel`` stored OIHW, optional ``bias``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 use_bias: bool = True, dilation: int = 1, device=None):
        super().__init__()
        self.dilation = dilation
        self.kernel = torch.nn.Parameter(torch.empty(
            out_ch, in_ch, kernel_size, kernel_size, device=device))
        self.bias = (torch.nn.Parameter(torch.empty(out_ch, device=device))
                     if use_bias else None)
        self._winograd_cache = {}      # U of the kernel, on the card

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel.copy_(glorot_uniform(self.kernel.shape, generator))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel, self.bias, self.dilation,
                      self._winograd_cache)


@spanned("conv")
def wnconv2d(x: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-normalised SAME stride-1 conv of NCHW ``x``: the kernel is
    ``g / ||v|| * v`` with the norm over each output channel's
    ``(C_in, kh, kw)`` (OIHW ``v``, ``+1e-12`` under the root). Always
    ``F.conv2d``: the JAX ``wnconv2d`` calls the XLA conv directly and
    never routes to the Winograd kernel."""
    norm = torch.sqrt(torch.sum(v * v, dim=(1, 2, 3)) + 1e-12)
    kernel = (g / norm)[:, None, None, None] * v
    return F.conv2d(x, kernel.to(x.dtype),
                    None if bias is None else bias.to(x.dtype),
                    padding=kernel.shape[-1] // 2)


class WNConv2d(torch.nn.Module):
    """:func:`wnconv2d` with parameters named as the JAX param dict:
    ``v`` (stored OIHW), ``g`` and an optional ``bias``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.v = torch.nn.Parameter(torch.empty(
            out_ch, in_ch, kernel_size, kernel_size, device=device))
        self.g = torch.nn.Parameter(torch.empty(out_ch, device=device))
        self.bias = (torch.nn.Parameter(torch.empty(out_ch, device=device))
                     if use_bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None,
                         zero_init: bool = False):
        """Glorot-uniform ``v`` (zeros with ``zero_init``), ``g = ||v||``,
        so the initial kernel is ``v``."""
        if zero_init:
            self.v.zero_()
        else:
            self.v.copy_(glorot_uniform(self.v.shape, generator))
        self.g.copy_(torch.sqrt(torch.sum(self.v * self.v, dim=(1, 2, 3))
                                + 1e-12))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return wnconv2d(x, self.v, self.g, self.bias)


def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ kernel + bias`` over the last axis; ``kernel`` is ``[in,
    out]``, the JAX package's layout."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class Dense(torch.nn.Module):
    """:func:`dense` with parameters ``kernel`` (``[in, out]``) and an
    optional ``bias``."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 device=None):
        super().__init__()
        self.kernel = torch.nn.Parameter(torch.empty(in_dim, out_dim,
                                                     device=device))
        self.bias = (torch.nn.Parameter(torch.empty(out_dim, device=device))
                     if use_bias else None)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        # Glorot over [in, out]: the limit is symmetric in the two fans
        self.kernel.copy_(glorot_uniform(self.kernel.shape, generator))
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias)


@spanned("conv")
def conv1x1(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1x1 conv of NCHW ``x`` with an OIHW ``[C_out, C_in, 1, 1]``
    ``kernel``, as one matmul over the channels of the NHWC view (a
    ``channels_last`` ``x`` needs no copy); returns an NCHW view in
    ``channels_last`` memory."""
    w = kernel.to(x.dtype)[:, :, 0, 0]
    y = torch.matmul(x.permute(0, 2, 3, 1), w.t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

@spanned("norm")
def frozen_batchnorm(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Per-channel affine ``gamma * x / sqrt(1 + eps) + beta`` of NCHW
    ``x``: the reference's Keras BatchNormalization inside the flows'
    coupling nets, whose moving statistics stay at (0, 1) because it only
    ever runs in inference mode (JAX ``frozen_batchnorm``)."""
    # the constant filled on the device (no copy from the host, which a
    # CUDA graph cannot capture), then rounded there as the JAX package does
    g = gamma.to(x.dtype) * torch.rsqrt(
        torch.full((), 1.0 + eps, dtype=x.dtype, device=x.device))
    return x * g[:, None, None] + beta.to(x.dtype)[:, None, None]


@spanned("norm")
def bias_relu_frozen_batchnorm(x: torch.Tensor, bias: torch.Tensor,
                               gamma: torch.Tensor, beta: torch.Tensor,
                               eps: float = 1e-3,
                               cache: Optional[dict] = None) -> torch.Tensor:
    """``frozen_batchnorm(relu(x + bias))`` of NCHW ``x`` (a conv's output
    without its bias) as one op (``ops.bias_relu_bn``): on a CUDA tensor a
    kernel forward and one for the input gradient, on a CPU tensor the
    PyTorch ops; the same results bit for bit. ``cache`` (a dict owned by
    the caller) keeps the per-channel rows on the card until a parameter
    changes."""
    return bias_relu_bn.bias_relu_bn(x, bias, gamma, beta, eps, cache)


class FrozenBatchNorm(torch.nn.Module):
    """:func:`frozen_batchnorm` with parameters ``gamma`` and ``beta``
    (initialised to 1 and 0 by :meth:`reset_parameters`)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.gamma = torch.nn.Parameter(torch.empty(num_features,
                                                    device=device))
        self.beta = torch.nn.Parameter(torch.empty(num_features,
                                                   device=device))
        self._rows_cache = {}     # bias_relu_bn's rows, on x's device

    @torch.no_grad()
    def reset_parameters(self):
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return frozen_batchnorm(x, self.gamma, self.beta)

    def after_bias_relu(self, x: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
        """This norm of ``relu(x + bias)``
        (:func:`bias_relu_frozen_batchnorm`)."""
        return bias_relu_frozen_batchnorm(x, bias, self.gamma, self.beta,
                                          cache=self._rows_cache)


@spanned("norm")
def instance_norm(x: torch.Tensor, gamma: Optional[torch.Tensor] = None,
                  beta: Optional[torch.Tensor] = None,
                  eps: float = 1e-3) -> torch.Tensor:
    """Per-sample, per-channel normalisation of NCHW ``x`` over H, W
    (tfa's default eps 1e-3), statistics in float32 whatever ``x``'s
    dtype; then the optional affine ``gamma``, ``beta``."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = xf.var(dim=(2, 3), keepdim=True, correction=0)
    h = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if gamma is not None:
        h = h * gamma.to(x.dtype)[:, None, None] \
            + beta.to(x.dtype)[:, None, None]
    return h


@spanned("norm")
def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-3) -> torch.Tensor:
    """Normalisation over the last axis (the channels of an NHWC tensor),
    eps 1e-3 inside the root, then ``gamma``, ``beta``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    h = (x - mean) * torch.rsqrt(var + eps)
    return h * gamma.to(x.dtype) + beta.to(x.dtype)


class LayerNorm(torch.nn.Module):
    """:func:`layer_norm` with parameters ``gamma`` and ``beta``
    (initialised to 1 and 0 by :meth:`reset_parameters`)."""

    def __init__(self, num_features: int, device=None):
        super().__init__()
        self.gamma = torch.nn.Parameter(torch.empty(num_features,
                                                    device=device))
        self.beta = torch.nn.Parameter(torch.empty(num_features,
                                                   device=device))

    @torch.no_grad()
    def reset_parameters(self):
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.beta)


def embedding(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of ``table`` (``[num_embeddings, dim]``)."""
    return table[idx]


def embedding_init(num_embeddings: int, dim: int,
                   generator: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """A table drawn uniformly from [-0.05, 0.05), as the JAX package
    draws it."""
    u = torch.rand((num_embeddings, dim), generator=generator, dtype=dtype)
    return 0.1 * u - 0.05


# ---------------------------------------------------------------------------
# pooling / resize
# ---------------------------------------------------------------------------

@spanned("pool")
def avg_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Stride-1 average pooling with SAME padding that counts only valid
    elements (JAX ``avg_pool_same``, odd ``window``): on a CUDA tensor the
    card's kernel (``ops.pool``)."""
    return pool.avg_pool_same(x, window)


@spanned("pool")
def max_pool_same(x: torch.Tensor, window: int,
                  stride: int = 1) -> torch.Tensor:
    """Max pooling of NCHW ``x`` with SAME padding (padding never wins:
    it is -inf), odd ``window``. At stride s the output is ``ceil(H /
    s)`` x ``ceil(W / s)`` with XLA's SAME split of the padding (the
    smaller half before). At stride 1 a CUDA tensor takes the card's
    kernel (``ops.pool``)."""
    if stride == 1:
        return pool.max_pool_same(x, window)
    h, w = x.shape[2:]
    pad = []
    for n in (w, h):
        total = max((-(-n // stride) - 1) * stride + window - n, 0)
        pad += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pad, value=float("-inf")), window, stride)


@spanned("pool")
def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling, stride 2, VALID: on a CUDA tensor the card's
    kernel (``ops.pool``)."""
    return pool.avg_pool2(x)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (``tf.image.resize`` /
    ``jax.image.resize`` for upsampling); identity at the same size."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    with span("resize"):
        return F.interpolate(x, size=tuple(size), mode="bilinear",
                             align_corners=False)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

@spanned("act")
def elu(x: torch.Tensor) -> torch.Tensor:
    """``F.elu``, the NCSN nets' activation."""
    return F.elu(x)


@spanned("act")
def relu(x: torch.Tensor) -> torch.Tensor:
    """``torch.relu``, the RealNVP and dense coupling nets' activation
    (the Glow nets' is fused into their norms:
    :func:`bias_relu_frozen_batchnorm`)."""
    return torch.relu(x)
