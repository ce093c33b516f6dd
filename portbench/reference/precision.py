"""The arithmetic of a reference: the convolutions and matmuls in float32
with TF32 off, or, for a control, in a lower precision: ``tf32``, the
matmuls on TF32 tensor cores (cuBLAS with TF32 allowed; on the CPU, which
has no TF32, the operands rounded to its 10 mantissa bits) and the
activations in float32; ``bf16``, or ``fp8`` (float8 e4m3 with a
per-tensor scale, as fp8 inference scales it), the operands rounded to it
and the activations kept in bfloat16.

The K sources' models run side by side, each op over all K at once
(weights carry a leading source axis), which halves the launches of a
reference whose time is mostly launches. The convolutions are written as
matmuls over the unfolded input, so a reference on a card runs on cuBLAS
and never on the convolution library the program uses (whose float32
algorithms, TF32 off, take over a second a forward there).

A :class:`Precision` with ``count=True`` adds up each op's multiply-adds
x 2, counted from shapes as direct convolutions; on the ``meta`` device
this counts a model's FLOPs without running it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_E4M3_MAX = 448.0


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32's 10 mantissa bits, to nearest even (the
    gradient passes through, as a cast's does)."""
    i = t.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return t + (i.view(torch.float32) - t).detach()


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Precision:
    """``mode``: ``f32`` (the reference), ``tf32``, ``bf16`` or ``fp8``
    (controls)."""

    def __init__(self, mode: str = "f32", count: bool = False):
        if mode not in ("f32", "tf32", "bf16", "fp8"):
            raise ValueError(f"precision mode {mode!r}")
        self.mode = mode
        self.count = count
        self.flops = 0
        self.convs = []          # (N, H, W, C_in, C_out, k, dilation)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.mode == "tf32" and t.device.type == "cpu":
            return _tf32(t)
        if self.mode == "bf16":
            return t.to(torch.bfloat16).to(torch.float32)
        if self.mode == "fp8" and t.device.type != "meta":
            return _fp8(t)
        return t

    def act(self, t: torch.Tensor) -> torch.Tensor:
        """An activation as stored between layers."""
        if self.mode in ("f32", "tf32"):
            return t
        return t.to(torch.bfloat16).to(torch.float32)

    def flags(self):
        """The card's TF32 switches for this mode's whole computation,
        forward and backward: allowed in ``tf32`` mode, off otherwise."""
        return tf32_flags(self.mode == "tf32")

    def conv2d(self, x, kernel, bias=None, dilation: int = 1):
        """SAME stride-1 conv of ``x [K, N, C_in, H, W]``, the K sources'
        batches, each with its own OIHW kernel ``[K, C_out, C_in, k, k]``
        and bias ``[K, C_out]``."""
        src, n, cin, h, w = x.shape
        cout, k = kernel.shape[1], kernel.shape[-1]
        if self.count:
            self.flops += 2 * k * k * src * n * h * w * cin * cout
            self.convs += [(n, h, w, cin, cout, k, dilation)] * src
        y = conv2d(self.operand(x), self.operand(kernel), dilation)
        if bias is not None:
            y = y + bias[:, None, :, None, None]
        return self.act(y)

    def matmul(self, a, b):
        """``a [K, ..., C_in] @ b [K, C_in, C_out]``: a weight matrix a
        source."""
        if self.count:
            self.flops += 2 * a.numel() // a.shape[-1] * b.shape[-2] \
                * b.shape[-1]
        src = a.shape[0]
        y = torch.matmul(self.operand(a).reshape(src, -1, a.shape[-1]),
                         self.operand(b))
        return self.act(y.reshape(*a.shape[:-1], b.shape[-1]))


def conv2d(x, kernel, dilation: int = 1):
    """SAME stride-1 conv of ``x [K, N, C_in, H, W]`` with kernels
    ``[K, C_out, C_in, k, k]`` as one batched matmul over the unfolded
    input: each output pixel's k x k x C_in window against its source's
    kernel rows (cuBLAS, not cuDNN, on a card)."""
    src, n, cin, h, w = x.shape
    cout, k = kernel.shape[1], kernel.shape[-1]
    if k == 1:
        cols = x.reshape(src, n, cin, h * w)
    else:
        cols = F.unfold(x.reshape(src * n, cin, h, w), k, dilation=dilation,
                        padding=dilation * (k // 2))
        cols = cols.reshape(src, n, cin * k * k, h * w)
    y = torch.matmul(kernel.reshape(src, 1, cout, -1), cols)
    return y.reshape(src, n, cout, h, w)


def stack(params: list) -> dict:
    """The K sources' parameter dicts as one, each tensor with a leading
    source axis."""
    return {name: torch.stack([p[name] for p in params])
            for name in params[0]}


@contextlib.contextmanager
def tf32_flags(allow: bool):
    """TF32 allowed (or not) for cuDNN convs and cuBLAS matmuls, restored
    after."""
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
