"""bias -> ReLU -> frozen BatchNorm on the card: a hand-written CUDA kernel
pair (``csrc/bias_relu_bn.cu``) for the Glow coupling nets' activation
chain, and the PyTorch composite of the same ops.

After each of its first two convs a coupling net
(``bijectors.nets.ShiftAndLogScaleConvNet``) computes

    y = frozen_batchnorm(relu(h + bias)) = relu(h + b) * g + beta

with ``h`` the conv's output (no bias), ``b`` its bias, ``g = gamma *
rsqrt(1 + eps)`` and ``beta`` the norm's, per channel.

* :func:`bias_relu_bn` is a ``torch.autograd.Function``. On a CUDA tensor
  its forward is one launch (y in one pass over h) and its input gradient
  one launch (``gh = h + b <= 0 ? 0 : gy * g``); each raises rather than
  fall back. On a CPU tensor both are the PyTorch composite
  (:func:`composite`, :func:`composite_input_grad`), the ops the net ran
  before, which the tests hold to the JAX package. Either way the results
  are those ops' bit for bit: each op rounds to h's dtype in turn.
* The rows ``(b, g, beta)`` in h's dtype (:func:`params`; ``g`` formed by
  the same PyTorch ops as ``nn.frozen_batchnorm``) are cached in a dict
  the caller owns, until a parameter is another tensor, is written in
  place (``_version``), moves (``data_ptr``, device) or the dtype changes.
  A miss while a CUDA graph captures raises, as ``nn.conv2d``'s Winograd
  weights do: an eager warm-up fills the cache first
  (``separation.graphs``).
* Parameter gradients (training) are PyTorch reductions over N, H and W of
  ``gy`` and the saved h; the separation's frozen priors never take them.
* h is NCHW in ``channels_last`` memory (physically NHWC), bf16 or f32,
  any N (up to 65535), C, H and W; y and gh are ``channels_last``. h of
  another layout is copied first, and so is a gradient in neither NHWC nor
  NCHW memory (both counted in ``layout_copies``). A gradient in NCHW
  memory (a conv's input gradient may come so) is read by the kernel's
  tile transpose, with no copy.
* A launch goes through ``kernels.build.launch`` and is counted in
  ``ops.counting`` under ``bias_relu_bn``: ``launch_count``, and
  ``launch_counts`` by kernel (``fwd``; ``bwd_nhwc``, ``bwd_nchw`` by the
  gradient's layout). A CUDA graph's owner (``separation.graphs``) takes a
  capture's counts back off and adds them at every replay.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..kernels import build
from . import counting

__all__ = ["bias_relu_bn", "params", "composite", "composite_input_grad"]

# the C entry points and their limits (csrc/bias_relu_bn.cu)
ENTRIES = {"fwd": "bias_relu_bn_fwd", "bwd": "bias_relu_bn_bwd"}
KINDS = {"fwd": 0, "bwd": 1}
MAX_N = 65535
# bytes of a thread's channel group (4 channels in f32, 8 in bf16); threads
# a block, at most
BYTES, THREADS = 16, 256


def _scale(gamma: torch.Tensor, dtype: torch.dtype,
           eps: float) -> torch.Tensor:
    """The norm's scale ``gamma * rsqrt(1 + eps)`` in ``dtype``, formed as
    ``nn.frozen_batchnorm`` forms it."""
    return gamma.to(dtype) * torch.rsqrt(
        torch.full((), 1.0 + eps, dtype=dtype, device=gamma.device))


def params(bias: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           dtype: torch.dtype, eps: float = 1e-3,
           cache: Optional[dict] = None) -> torch.Tensor:
    """``[3, C]``: the rows ``bias``, ``gamma * rsqrt(1 + eps)`` and
    ``beta`` in ``dtype``. With ``cache`` (a dict owned by the caller)
    recomputed only when a parameter is another tensor, was written in
    place, moved, or ``dtype`` or ``eps`` changes; a miss while a CUDA
    graph captures raises."""
    of = (bias, gamma, beta)
    key = (*((t._version, t.data_ptr(), t.device) for t in of), dtype, eps)
    if cache is not None and len(cache.get("of", ())) == 3 \
            and all(a is b for a, b in zip(cache["of"], of)) \
            and cache.get("key") == key:
        return cache["p"]
    if cache is not None and torch.cuda.is_initialized() \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "bias_relu_bn: the rows of a coupling net's norm are not cached "
            "while a CUDA graph captures; run the captured function once "
            "eagerly first")
    with torch.no_grad():
        p = torch.stack([bias.to(dtype), _scale(gamma, dtype, eps),
                         beta.to(dtype)])
    if cache is not None:
        cache.update(of=of, key=key, p=p)
    return p


def _rows(p: torch.Tensor):
    """The rows of ``params`` shaped to broadcast over NCHW."""
    return p[0][:, None, None], p[1][:, None, None], p[2][:, None, None]


def composite(h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The PyTorch ops of the forward: ``relu(h + b) * g + beta``, each
    rounded to h's dtype (the ops of ``nn.conv2d``'s bias add,
    ``nn.relu`` and ``nn.frozen_batchnorm``)."""
    b, g, beta = _rows(p)
    return torch.relu(h + b) * g + beta


def composite_input_grad(gy: torch.Tensor, h: torch.Tensor,
                         p: torch.Tensor) -> torch.Tensor:
    """The PyTorch ops of the input gradient (autograd's for
    :func:`composite`): ``gy * g``, then zero where ``h + b <= 0``."""
    b, g, _ = _rows(p)
    return torch.ops.aten.threshold_backward(gy * g, h + b, 0)


class _BiasReluBN(torch.autograd.Function):
    """Forward: the kernel (CUDA) or :func:`composite` (CPU). Backward:
    the input gradient by the kernel or :func:`composite_input_grad`, and
    the parameters' gradients (when asked for) as PyTorch reductions."""

    @staticmethod
    def forward(ctx, h, bias, gamma, beta, p, eps):
        ctx.save_for_backward(h, p)
        ctx.eps = eps
        ctx.dtypes = (bias.dtype, gamma.dtype, beta.dtype)
        return _forward_cuda(h, p) if h.is_cuda else composite(h, p)

    @staticmethod
    def backward(ctx, gy):
        h, p = ctx.saved_tensors
        need_h, need_b, need_gamma, need_beta = ctx.needs_input_grad[:4]
        gh = gb = ggamma = gbeta = None
        if need_h or need_b:
            gh = (_input_grad_cuda(gy, h, p) if h.is_cuda
                  else composite_input_grad(gy, h, p))
        dims = (0, 2, 3)
        if need_b:
            gb = gh.sum(dims).to(ctx.dtypes[0])
        if need_gamma:
            # g = gamma * rsqrt(1 + eps): d/dgamma of sum(gy * relu * g)
            relu = torch.relu(h + _rows(p)[0])
            ggamma = ((gy * relu).sum(dims) * torch.rsqrt(torch.full(
                (), 1.0 + ctx.eps, dtype=h.dtype, device=h.device))
                      ).to(ctx.dtypes[1])
        if need_beta:
            gbeta = gy.sum(dims).to(ctx.dtypes[2])
        return gh if need_h else None, gb, ggamma, gbeta, None, None


def bias_relu_bn(h: torch.Tensor, bias: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-3,
                 cache: Optional[dict] = None) -> torch.Tensor:
    """``relu(h + bias) * gamma * rsqrt(1 + eps) + beta`` of NCHW ``h``
    over its channels, in h's dtype: on a CUDA tensor the kernel pair, on
    a CPU tensor the PyTorch ops. ``cache`` (a dict the caller owns) keeps
    the rows (:func:`params`). Differentiable in h and the parameters."""
    if h.is_cuda and not h.is_contiguous(memory_format=torch.channels_last):
        h = h.contiguous(memory_format=torch.channels_last)
        counting.add({"bias_relu_bn": {"layout_copies": 1}})
    p = params(bias, gamma, beta, h.dtype, eps, cache)
    return _BiasReluBN.apply(h, bias, gamma, beta, p, eps)


def block_shape(c: int, bf16: bool) -> tuple:
    """A row kernel's block for ``c`` channels: G channel groups of BYTES
    (in bf16 or f32) by R rows, within THREADS threads
    (csrc/bias_relu_bn.cu)."""
    g = min(-(-c // (BYTES // (2 if bf16 else 4))), THREADS)
    return g, THREADS // g


@functools.lru_cache(maxsize=None)
def _row_blocks(device: int, kind: str, bf16: bool, rows: int,
                c: int) -> int:
    """The row kernel's grid of row blocks for ``rows`` rows of ``c``
    channels: the blocks the card holds at once (its SMs x the blocks an
    SM holds, over the grid's channel slabs), or fewer where the rows run
    out first."""
    g, r = block_shape(c, bf16)
    per_sm = build.function("bias_relu_bn_blocks_per_sm")(KINDS[kind],
                                                          int(bf16), g * r)
    if per_sm < 1:
        raise RuntimeError(f"bias_relu_bn kernel: no occupancy for C = {c}")
    slabs = -(-(-(-c // (BYTES // (2 if bf16 else 4)))) // g)
    resident = max(1, per_sm * build.sm_count(device) // slabs)
    return max(1, min(resident, -(-rows // r)))


def _check(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"bias_relu_bn kernel needs CUDA tensors, got "
                         f"{name} on {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bias_relu_bn kernel takes float32 or bfloat16, "
                        f"got {name} {t.dtype}")


def _geometry(h: torch.Tensor, p: torch.Tensor) -> tuple:
    """(N, HW, C) of ``h`` after the wrapper's checks of h and ``p``."""
    _check(h, "h")
    if h.dim() != 4 or not h.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"bias_relu_bn kernel needs 4-D h in channels_last "
                         f"memory, got shape {tuple(h.shape)}, strides "
                         f"{h.stride()}")
    n, c, hh, w = h.shape
    if n > MAX_N:
        raise ValueError(f"bias_relu_bn kernel takes N <= {MAX_N}, got "
                         f"{tuple(h.shape)}")
    if p.dtype != h.dtype or p.device != h.device \
            or tuple(p.shape) != (3, c) or not p.is_contiguous():
        raise ValueError(f"bias_relu_bn kernel: the rows must be a "
                         f"contiguous {h.dtype} [3, {c}] on {h.device}, got "
                         f"{p.dtype} {list(p.shape)} on {p.device}")
    return n, hh * w, c


def _forward_cuda(h: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Launch the forward on the current stream (h ``channels_last``)."""
    n, hw, c = _geometry(h, p)
    y = torch.empty_like(h, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    dev, bf16 = h.device, h.dtype == torch.bfloat16
    blocks = _row_blocks(dev.index, "fwd", bf16, n * hw, c)
    build.launch(ENTRIES["fwd"], dev, h.data_ptr(), p.data_ptr(),
                 y.data_ptr(), n, hw, c, int(bf16), blocks,
                 detail=lambda: f"h {tuple(h.shape)} {h.dtype}, blocks "
                                f"{blocks}")
    counting.add({"bias_relu_bn": {"launch_count": 1,
                                   "launch_counts": {"fwd": 1}}})
    return y


def _input_grad_cuda(gy: torch.Tensor, h: torch.Tensor,
                     p: torch.Tensor) -> torch.Tensor:
    """Launch the input gradient on the current stream: gy in NHWC memory
    (``channels_last``) or NCHW memory (contiguous) as it comes, else
    copied into ``channels_last`` first; gh ``channels_last``."""
    n, hw, c = _geometry(h, p)
    _check(gy, "gy")
    if gy.dtype != h.dtype or gy.shape != h.shape:
        raise ValueError(f"bias_relu_bn kernel: gy must be {h.dtype} "
                         f"{tuple(h.shape)}, got {gy.dtype} "
                         f"{tuple(gy.shape)}")
    nchw = not gy.is_contiguous(memory_format=torch.channels_last)
    if nchw and not gy.is_contiguous():
        gy = gy.contiguous(memory_format=torch.channels_last)
        counting.add({"bias_relu_bn": {"layout_copies": 1}})
        nchw = False
    gh = torch.empty_like(h, memory_format=torch.channels_last)
    if gh.numel() == 0:
        return gh
    dev, bf16 = h.device, h.dtype == torch.bfloat16
    blocks = 1 if nchw else _row_blocks(dev.index, "bwd", bf16, n * hw, c)
    build.launch(ENTRIES["bwd"], dev, gy.data_ptr(), h.data_ptr(),
                 p.data_ptr(), gh.data_ptr(), n, hw, c, int(nchw), int(bf16),
                 blocks, detail=lambda: f"h {tuple(h.shape)} {h.dtype}, gy "
                                        f"strides {gy.stride()}")
    kind = "bwd_nchw" if nchw else "bwd_nhwc"
    counting.add({"bias_relu_bn": {"launch_count": 1,
                                   "launch_counts": {kind: 1}}})
    return gh
