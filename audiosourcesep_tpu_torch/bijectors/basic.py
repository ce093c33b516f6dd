"""ActNorm, invertible 1x1 convolution, squeeze, and preprocessing bijectors (port of ``audiosourcesep_tpu/bijectors/basic.py``).

Inputs are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..utils.profiling import spanned
from .core import Bijector, sum_event


def _f32_log(v: float) -> float:
    """``log(v)`` rounded as the JAX package's f32 ``jnp.log`` of a Python
    constant rounds it."""
    return float(np.log(np.float32(v)))


class ActNorm(Bijector):
    """Per-channel affine ``y = x * exp(log_scale) + shift``.

    ``shape`` is the channel count (``normalize='channel'``: parameters of
    shape ``(C,)``, log-det ``H*W*sum(log_scale)``) or the event shape
    ``(H, W, C)`` (``normalize='all'``: per-element parameters, log-det
    ``sum(log_scale)``). The data-dependent init gives the minibatch zero
    mean and unit variance per channel (per element), with the JAX
    package's ``jnp.std``: ddof 0.
    """

    name = "actnorm"

    def __init__(self, shape: Union[int, Sequence[int]],
                 normalize: str = "channel", eps: float = 1e-8,
                 device=None):
        super().__init__()
        if normalize not in ("channel", "all"):
            raise ValueError("normalize should be 'channel' or 'all'")
        self.normalize = normalize
        self.eps = eps
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        self.log_scale = torch.nn.Parameter(torch.empty(shape,
                                                        device=device))
        self.shift = torch.nn.Parameter(torch.empty(shape, device=device))

    @torch.no_grad()
    def init_params(self, x, generator=None):
        dims = (0, 1, 2) if self.normalize == "channel" else (0,)
        mean = x.mean(dim=dims)
        std = x.std(dim=dims, correction=0) + self.eps
        self.log_scale.copy_(-torch.log(std))
        self.shift.copy_(-mean / std)

    @torch.no_grad()
    def reinit(self, x):
        return self.init(x)

    def _log_det(self, x):
        ld = self.log_scale.sum()
        if self.normalize == "channel":
            ld = x.shape[1] * x.shape[2] * ld
        return ld.expand(x.shape[0]).to(x.dtype)

    @spanned("norm")
    def forward(self, x, noise=None):
        return x * torch.exp(self.log_scale) + self.shift, self._log_det(x)

    def inverse(self, y):
        return ((y - self.shift) * torch.exp(-self.log_scale),
                self._log_det(y))


class Invertible1x1Conv(Bijector):
    """PLU-parameterised invertible 1x1 convolution (Glow).

    ``W = P @ L @ (U + diag(sign_s * exp(log_s)))`` with L unit
    lower-triangular and U strictly upper-triangular; ``y = x @ W`` over
    the channels in full f32, the inverse through triangular solves.
    log-det ``H*W*sum(log_s)``.

    The JAX package calls P and ``sign_s`` fixed, but they are ordinary
    leaves of its params pytree and its optimizer trains every leaf. They
    are trainable parameters here too, so train steps and checkpoints
    stay equal to the JAX package's (once P leaves the permutations or
    ``sign_s`` leaves +-1, the log-det formula is no longer exact).
    """

    name = "inv1x1"

    def __init__(self, channels: int, device=None):
        super().__init__()
        for n in ("P", "L", "U"):
            setattr(self, n, torch.nn.Parameter(torch.empty(
                channels, channels, device=device)))
        self.sign_s = torch.nn.Parameter(torch.empty(channels,
                                                     device=device))
        self.log_s = torch.nn.Parameter(torch.empty(channels,
                                                    device=device))

    @torch.no_grad()
    def init_params(self, x, generator=None):
        # drawn and factored on the CPU, as every init draw of the port
        C = self.P.shape[0]
        w = torch.linalg.qr(torch.randn(C, C, generator=generator)).Q
        P, L, U = torch.linalg.lu(w)
        s = torch.diagonal(U)
        self.P.copy_(P)
        self.sign_s.copy_(torch.sign(s))
        self.L.copy_(torch.tril(L, -1))
        self.U.copy_(torch.triu(U, 1))
        self.log_s.copy_(torch.log(torch.abs(s)))

    def _assemble(self):
        eye = torch.eye(self.P.shape[0], dtype=self.P.dtype,
                        device=self.P.device)
        L = torch.tril(self.L, -1) + eye
        U = torch.triu(self.U, 1) + torch.diag(self.sign_s
                                               * torch.exp(self.log_s))
        return L, U, eye

    def _log_det(self, x):
        return (x.shape[1] * x.shape[2] * self.log_s.sum()).expand(
            x.shape[0]).to(x.dtype)

    @spanned("conv")
    def forward(self, x, noise=None):
        L, U, _ = self._assemble()
        W = self.P @ (L @ U)
        return torch.matmul(x, W), self._log_det(x)

    def inverse(self, y):
        L, U, eye = self._assemble()
        # W^-1 = U^-1 L^-1 P^T via triangular solves against the identity
        Linv = torch.linalg.solve_triangular(L, eye, upper=False,
                                             unitriangular=True)
        Uinv = torch.linalg.solve_triangular(U, eye, upper=True)
        Winv = Uinv @ (Linv @ self.P.t())
        return torch.matmul(y, Winv), self._log_det(y)


class Squeeze(Bijector):
    """Space-to-depth (H, W, C) -> (H/2, W/2, 4C); log-det 0. The JAX
    package's element order: reshape (N, H/2, 2, W/2, 2, C), transpose to
    (N, H/2, W/2, C, 2, 2), reshape."""

    name = "squeeze"

    def forward(self, x, noise=None):
        N, H, W, C = x.shape
        y = x.reshape(N, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        return (y.reshape(N, H // 2, W // 2, 4 * C),
                torch.zeros(N, dtype=x.dtype, device=x.device))

    def inverse(self, y):
        N, H2, W2, C4 = y.shape
        x = y.reshape(N, H2, W2, C4 // 4, 2, 2).permute(0, 1, 4, 2, 5, 3)
        return (x.reshape(N, H2 * 2, W2 * 2, C4 // 4),
                torch.zeros(N, dtype=y.dtype, device=y.device))


class ImgPreprocessing(Bijector):
    """Uniform dequantisation + optional logit: ``logit(a + (1-2a) x/256)``.

    ``noise`` (uniform on ``[0, 1)``, ``x``'s shape) is added before the
    transform, and the output and its log-det come from the same draw;
    without it no noise is added (deterministic eval).
    """

    name = "img_preprocessing"

    def __init__(self, alpha: float = 0.05, use_logit: bool = True):
        super().__init__()
        self.alpha = alpha
        self.use_logit = use_logit

    def _logit_ld(self, u):
        a = self.alpha
        return (-torch.log(u) - torch.log1p(-u)
                + _f32_log((1.0 - 2 * a) / 256.0))

    def forward(self, x, noise=None):
        if noise is not None:
            x = x + noise
        if self.use_logit:
            a = self.alpha
            u = a + (1.0 - 2 * a) * x / 256.0
            return torch.log(u) - torch.log1p(-u), sum_event(
                self._logit_ld(u))
        return x / 256.0 - 0.5, sum_event(
            torch.full_like(x, -_f32_log(256.0)))

    def inverse(self, y):
        if self.use_logit:
            a = self.alpha
            u = torch.sigmoid(y)
            return ((u - a) * 256.0 / (1.0 - 2 * a),
                    sum_event(self._logit_ld(u)))
        return (y + 0.5) * 256.0, sum_event(
            torch.full_like(y, -_f32_log(256.0)))


class SpecPreprocessing(Bijector):
    """Min-max rescale to [0, 1] then logit (or shift by -0.5), with the
    exact analytic log-det in both branches."""

    name = "spec_preprocessing"

    def __init__(self, minval: float, maxval: float, alpha: float = 1e-10,
                 use_logit: bool = True):
        super().__init__()
        self.minval = minval
        self.maxval = maxval
        self.alpha = alpha
        self.use_logit = use_logit

    def _logit_ld(self, v):
        a, span = self.alpha, self.maxval - self.minval
        return (-torch.log(v) - torch.log1p(-v)
                + _f32_log(1.0 - 2 * a) - _f32_log(span))

    def forward(self, x, noise=None):
        span = self.maxval - self.minval
        u = (x - self.minval) / span
        if self.use_logit:
            a = self.alpha
            v = (1.0 - 2 * a) * u + a
            return torch.log(v) - torch.log1p(-v), sum_event(
                self._logit_ld(v))
        return u - 0.5, sum_event(torch.full_like(x, -_f32_log(span)))

    def inverse(self, y):
        span = self.maxval - self.minval
        if self.use_logit:
            a = self.alpha
            v = torch.sigmoid(y)
            u = (v - a) / (1.0 - 2 * a)
            return u * span + self.minval, sum_event(self._logit_ld(v))
        return (y + 0.5) * span + self.minval, sum_event(
            torch.full_like(y, -_f32_log(span)))

