"""InstanceNorm2d+ on the card: a hand-written CUDA kernel pair
(``csrc/instnorm_plus.cu``) for the NCSN score nets' norm, and the
PyTorch composite of the same math.

The norm (``models.ncsn.layers``) is

    out = gamma_r * in.gamma * (x - mean_hw) * rsqrt(var_hw + 1e-3)
          + alpha_r * norm_c(mean_hw) + gamma_r * in.beta + beta_r

with the rows ``gamma_r``, ``alpha_r``, ``beta_r`` of the embedding tables
at each sample's label (v1), or the one row of v2's unconditional norm.

* :func:`instnorm_plus` on a CUDA tensor runs as two launches: the
  statistics (f32, over slices of H x W, the last block of each sample
  folding the embeddings into ``a, b [N, C]``) and the affine ``x * a +
  b`` with an optional ELU, rounded once to x's dtype. It launches the
  kernel or raises; nothing falls back. :func:`composite` is the PyTorch
  version, which the norm modules run on CPU tensors (the tests against
  the JAX package).
* Gradients: a ``torch.autograd.Function`` whose forward is the kernel and
  whose backward is the composite's VJP, recomputed from x and the tables
  (as ``ops.winograd`` takes the plain conv's VJP); there is no backward
  kernel.
* x is NCHW in ``channels_last`` memory (physically NHWC), bf16 or f32,
  any N (up to 65535), C (up to 4096), H and W; the tables are float32.
  :func:`instnorm_plus` copies x of another layout into ``channels_last``
  first (counted in ``layout_copies``); :func:`_instnorm_cuda` refuses it.
* A launch goes through ``kernels.build.launch`` and is counted in
  ``ops.counting`` under ``instnorm``: ``launch_count``, norms the kernel
  ran, and ``layout_copies``. A CUDA graph's owner (``separation.graphs``)
  takes a capture's counts back off and adds them at every replay.
* Each launch brings its own scratch, tickets included (zeroed on the
  stream by the C entry), so launches on several streams, or several
  graphs' replays, never share state.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import build
from . import counting

__all__ = ["norm2dplus", "composite", "instnorm_plus"]

# the C entry point of the kernel pair, and its limits (csrc/instnorm_plus.cu)
ENTRY = "instnorm_plus_fwd"
MAX_C = 4096
MAX_N = 65535
# channels a thread owns and threads a block: R = BLOCK // ceil(C / VEC)
# threads share a channel group, one pixel row each
VEC, BLOCK = 8, 256


def norm2dplus(x, scale, alpha, bias, eps_in=1e-3, eps_means=1e-5,
               act=None):
    """InstanceNorm2d+ with folded ``[N, C]`` affine rows (NCHW ``x``):

        out = scale * (x - mean_hw) * rsqrt(var_hw + eps)
              + alpha * (mean_hw - m) * rsqrt(v + eps') + bias

    One-pass f32 statistics (E[x], E[x^2]), both variances clamped at 0
    (the one-pass form can go slightly negative under cancellation), and
    the whole normalisation as one multiply-add ``x * a + b``; the output
    keeps ``x``'s dtype, and ``act`` (if given) runs on it.
    """
    xf = x.float()
    s1 = xf.mean(dim=(2, 3), keepdim=True)                     # [N,C,1,1]
    s2 = (xf * xf).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(s2 - s1 * s1, min=0.0)
    m = s1.mean(dim=1, keepdim=True)                           # [N,1,1,1]
    v = torch.clamp((s1 * s1).mean(dim=1, keepdim=True) - m * m, min=0.0)
    means_n = (s1 - m) * torch.rsqrt(v + eps_means)
    a = scale[:, :, None, None] * torch.rsqrt(var + eps_in)
    b = alpha[:, :, None, None] * means_n + bias[:, :, None, None] - a * s1
    out = (xf * a + b).to(x.dtype)
    return out if act is None else act(out)


def composite(x: torch.Tensor, labels: Optional[torch.Tensor],
              gamma: torch.Tensor, alpha: torch.Tensor,
              beta: Optional[torch.Tensor], in_gamma: torch.Tensor,
              in_beta: torch.Tensor, act=None) -> torch.Tensor:
    """The PyTorch version of :func:`instnorm_plus`: the tables' rows at
    ``labels`` (v1), or the one row for every sample (v2, ``labels``
    None), folded with the inner norm's into ``[N, C]`` rows, then
    :func:`norm2dplus` with ``act``."""
    if labels is None:
        n = x.shape[0]
        rows = lambda t: t[None, :].expand(n, -1)        # noqa: E731
    else:
        rows = lambda t: t[labels]                       # noqa: E731
    g = rows(gamma)
    scale = g * in_gamma
    bias = g * in_beta
    if beta is not None:
        bias = bias + rows(beta)
    return norm2dplus(x, scale, rows(alpha), bias, act=act)


class _InstNormPlus(torch.autograd.Function):
    """Forward: the kernel pair. Backward: the VJP of :func:`composite`
    (with ``F.elu`` where the ELU is fused), recomputed under autograd."""

    @staticmethod
    def forward(ctx, x, labels, gamma, alpha, beta, in_gamma, in_beta, elu):
        ctx.save_for_backward(x, labels, gamma, alpha, beta, in_gamma,
                              in_beta)
        ctx.elu = elu
        return _instnorm_cuda(x, labels, gamma, alpha, beta, in_gamma,
                              in_beta, elu)

    @staticmethod
    def backward(ctx, gy):
        need = ctx.needs_input_grad[:7]
        args = [t if t is None else t.detach().requires_grad_(n)
                for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = composite(*args, act=F.elu if ctx.elu else None)
        wrt = [t for t, n in zip(args, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, gy))
        return (*(next(grads) if n else None for n in need), None)


def instnorm_plus(x: torch.Tensor, labels: Optional[torch.Tensor],
                  gamma: torch.Tensor, alpha: torch.Tensor,
                  beta: Optional[torch.Tensor], in_gamma: torch.Tensor,
                  in_beta: torch.Tensor, elu: bool = False) -> torch.Tensor:
    """InstanceNorm2d+ of NCHW ``x`` on the card, ELU after it if ``elu``.

    ``gamma``, ``alpha``, ``beta`` (or None) are ``[K, C]`` tables indexed
    by ``labels`` (``[N]``; v1), or ``[C]`` rows with ``labels`` None (v2);
    ``in_gamma``, ``in_beta`` the inner norm's ``[C]``. Returns x's dtype
    in ``channels_last`` memory. x in another layout is copied first.
    Differentiable in x and the tables (the composite's VJP)."""
    if x.is_cuda and not x.is_contiguous(memory_format=torch.channels_last):
        x = x.contiguous(memory_format=torch.channels_last)
        counting.add({"instnorm": {"layout_copies": 1}})
    return _InstNormPlus.apply(x, labels, gamma, alpha, beta, in_gamma,
                               in_beta, elu)


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: int, c: int, bf16: bool) -> int:
    """The statistics blocks of C channels the card holds at once: its SMs
    x the blocks an SM holds (the kernel's registers and shared memory)."""
    per_sm = build.function("instnorm_plus_blocks_per_sm")(c, int(bf16))
    if per_sm < 1:
        raise RuntimeError(f"instnorm kernel: no occupancy for C = {c}")
    return per_sm * build.sm_count(device)


def slices(n: int, c: int, hw: int, blocks: int) -> int:
    """Slices of H x W a sample's statistics (and affine) are cut into:
    the most that keep the grid's n x slices within one wave of the
    ``blocks`` the card holds at once (a wave not filled leaves SMs idle
    at its end; two to four waves measured slower on the H100), as long as
    each thread keeps two pixels or more."""
    groups = -(-c // VEC)
    rows = 1 if groups >= BLOCK else BLOCK // groups
    return max(1, min(blocks // max(n, 1), -(-hw // (2 * rows))))


def _rows(t: Optional[torch.Tensor], c: int, name: str, device,
          k: Optional[int] = None) -> Optional[torch.Tensor]:
    """Check one parameter table: float32, contiguous, on ``device``,
    ``[C]`` or (``k`` given) ``[k, C]``."""
    if t is None:
        return None
    shape = (c,) if k is None else (k, c)
    if t.dtype != torch.float32 or t.device != device \
            or not t.is_contiguous() or tuple(t.shape) != shape:
        raise ValueError(f"instnorm kernel: {name} must be a contiguous "
                         f"float32 {list(shape)} on {device}, got "
                         f"{t.dtype} {list(t.shape)} on {t.device}")
    return t


def _instnorm_cuda(x: torch.Tensor, labels: Optional[torch.Tensor],
                   gamma: torch.Tensor, alpha: torch.Tensor,
                   beta: Optional[torch.Tensor], in_gamma: torch.Tensor,
                   in_beta: torch.Tensor, elu: bool = False) -> torch.Tensor:
    """Launch the kernel pair on the current stream (see
    :func:`instnorm_plus`; x must already be ``channels_last``)."""
    if not x.is_cuda:
        raise ValueError(f"instnorm kernel needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instnorm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"instnorm kernel needs 4-D x in channels_last "
                         f"memory, got shape {tuple(x.shape)}, strides "
                         f"{x.stride()}")
    n, c, h, w = x.shape
    if c > MAX_C or n > MAX_N:
        raise ValueError(f"instnorm kernel takes N <= {MAX_N} and C <= "
                         f"{MAX_C}, got {tuple(x.shape)}")
    k = None                  # v2: [C] rows; v1: [K, C] tables
    if labels is not None:
        if labels.dim() != 1 or labels.shape[0] != n \
                or labels.is_floating_point():
            raise ValueError(f"instnorm kernel: labels must be [{n}] "
                             f"integers, got {labels.dtype} "
                             f"{list(labels.shape)}")
        # as the composite's table[labels] takes them, from any device
        labels = labels.to(x.device, torch.long)
        k = gamma.shape[0]
    dev = x.device
    gamma, alpha, beta = (_rows(t, c, name, dev, k) for t, name in (
        (gamma, "gamma"), (alpha, "alpha"), (beta, "beta")))
    in_gamma, in_beta = (_rows(t, c, name, dev) for t, name in (
        (in_gamma, "in_gamma"), (in_beta, "in_beta")))
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    bf16 = x.dtype == torch.bfloat16
    s = slices(n, c, h * w, _resident_blocks(dev.index, c, bf16))
    # the partial sums [N, S, C, 2], a and b [N, C, 2], the tickets [N]
    scratch = torch.empty(n * c * 2 * (s + 1) + n, dtype=torch.float32,
                          device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    build.launch(ENTRY, dev, x.data_ptr(), y.data_ptr(), ptr(labels),
                 gamma.data_ptr(), alpha.data_ptr(), ptr(beta),
                 in_gamma.data_ptr(), in_beta.data_ptr(), scratch.data_ptr(),
                 n, c, h * w, 1 if k is None else k, int(bf16), s, int(elu),
                 detail=lambda: f"x {tuple(x.shape)} {x.dtype}, slices {s}")
    counting.add({"instnorm": {"launch_count": 1}})
    return y
