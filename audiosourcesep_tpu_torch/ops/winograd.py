"""Winograd F(2x2, 3x3) convolution: hand-written CUDA kernel for Hopper.

Port of ``audiosourcesep_tpu/ops/winograd.py``. The SAME 3x3 stride-1
conv is computed per 2x2 output tile as

    Y = A^T [ (G g G^T) . (B^T d B) ] A      (per tile, summed over C_in)

with the exact +-1 / +-0.5 transform matrices below: 16 channel
contractions in the transform domain, 2.25x fewer multiply-adds than the
direct conv. The Hopper kernel (``csrc/winograd.cu``) reads NHWC ``x``
directly (SAME halo masked in the kernel), takes the pre-transformed
weights ``U [16, C_in, C_out]`` in f32, and writes the interleaved NHWC
output itself.

Public layout is the JAX package's: NHWC activations, HWIO kernels.

* ``winograd_conv2d`` on a CPU tensor runs the plain PyTorch version
  (:func:`winograd_conv2d_reference`); on a CUDA tensor it launches the
  kernel or raises. There is no fallback between the two.
* Gradients: a ``torch.autograd.Function`` whose backward is the plain
  conv VJP (``torch.nn.grad.conv2d_input`` / ``conv2d_weight``), as the
  JAX custom VJP uses the XLA conv VJP; there is no backward kernel.
* ``launch_count`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["transform_weights", "winograd_conv2d",
           "winograd_conv2d_reference", "winograd_eligible", "launch_count"]

_BT = np.array([[1, 0, -1, 0],
                [0, 1, 1, 0],
                [0, -1, 1, 0],
                [0, 1, 0, -1]], np.float32)
_G = np.array([[1, 0, 0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0, 0, 1]], np.float32)
_AT = np.array([[1, 1, 1, 0],
                [0, 1, -1, -1]], np.float32)

# kernel launches since import (or since a caller reset it to 0)
launch_count = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, C_in, C_out]`` -> ``U [16, C_in, C_out]`` =
    flat(G g G^T), in float32."""
    g = _const(_G, kernel.device)
    u = torch.einsum("ui,ijcd,vj->uvcd", g, kernel.float(), g)
    return u.reshape(16, *kernel.shape[2:]).contiguous()


def winograd_conv2d_reference(x: torch.Tensor,
                              kernel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Winograd (the kernel's reference; the CPU path).

    NHWC ``x``, HWIO ``kernel``, SAME padding, stride 1, H and W even.
    Computed in float32, returned in ``x``'s dtype.
    """
    b, h, w, cin = x.shape
    if h % 2 or w % 2 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"winograd needs even H, W and a 3x3 kernel, got "
                         f"x {tuple(x.shape)}, kernel {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    u = transform_weights(kernel).reshape(4, 4, cin, cout)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    # d[i, j, b, a, c, cin] = xp[b, 2a + i, 2c + j, cin]
    d = torch.stack([torch.stack(
        [xp[:, i:i + h - 1:2, j:j + w - 1:2, :] for j in range(4)])
        for i in range(4)]).float()
    bt = _const(_BT, x.device)
    at = _const(_AT, x.device)
    v = torch.einsum("ui,vj,ijbrsc->uvbrsc", bt, bt, d)
    m = torch.einsum("uvbrsc,uvcd->uvbrsd", v, u)
    y = torch.einsum("pu,qv,uvbrsd->brpsqd", at, at, m)
    return y.reshape(b, h, w, cout).to(x.dtype)


def winograd_eligible(x_shape, kernel_shape, dilation: int = 1) -> bool:
    """True when the kernel computes this stride-1 SAME conv: 3x3,
    undilated, with even H and W (NHWC ``x_shape``, HWIO
    ``kernel_shape``). Any C_in, C_out >= 1."""
    if len(kernel_shape) != 4 or tuple(kernel_shape[:2]) != (3, 3):
        return False
    if dilation != 1:
        return False
    _, h, w, cin = x_shape
    return h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2 and cin >= 1 \
        and kernel_shape[3] >= 1


def _winograd_cuda(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/winograd.cu`` on the current stream. NHWC ``x``
    (f32 or bf16, contiguous, even H/W) and ``U [16, C_in, C_out]`` f32."""
    global launch_count
    if not x.is_cuda or u.device != x.device:
        raise ValueError(f"winograd kernel needs x and U on one CUDA device, "
                         f"got {x.device} and {u.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"winograd kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"U must be float32, got {u.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or not u.is_contiguous():
        raise ValueError("winograd kernel needs contiguous NHWC x and U")
    b, h, w, cin = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"winograd kernel needs even H and W, got {h}x{w}")
    if u.dim() != 3 or u.shape[0] != 16 or u.shape[1] != cin:
        raise ValueError(f"U must be [16, {cin}, C_out], got "
                         f"{tuple(u.shape)}")
    cout = u.shape[2]
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    from ..kernels.build import load_library
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.winograd_f23_fwd(x.data_ptr(), u.data_ptr(), y.data_ptr(),
                                   b, h, w, cin, cout, _DTYPE_CODE[x.dtype],
                                   stream)
    if err != 0:
        raise RuntimeError(f"winograd_f23_fwd launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)} {x.dtype}, "
                           f"C_out {cout})")
    launch_count += 1
    return y


def _forward(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return _winograd_cuda(x, transform_weights(kernel))
    if x.device.type == "cpu":
        return winograd_conv2d_reference(x, kernel)
    raise ValueError(f"winograd_conv2d: no implementation for device "
                     f"{x.device}")


class _WinogradConv2d(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU). Backward:
    the plain conv VJP, as in the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return _forward(x, kernel)

    @staticmethod
    def backward(ctx, gy):
        x, kernel = ctx.saved_tensors
        w = kernel.permute(3, 2, 0, 1).to(x.dtype)          # HWIO -> OIHW
        xn = x.permute(0, 3, 1, 2)
        g = gy.permute(0, 3, 1, 2).to(x.dtype)
        gx = gk = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xn.shape, w, g, padding=1)
            gx = gx.permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            gk = torch.nn.grad.conv2d_weight(xn, w.shape, g, padding=1)
            gk = gk.permute(2, 3, 1, 0).to(kernel.dtype)
        return gx, gk


def winograd_conv2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 stride-1 conv via Winograd F(2x2,3x3).

    NHWC ``x``, HWIO ``kernel``; output NHWC in ``x``'s dtype. A CUDA
    tensor goes through the Hopper kernel (or raises), a CPU tensor through
    :func:`winograd_conv2d_reference`. Bias is the caller's job.
    """
    return _WinogradConv2d.apply(x, kernel)
