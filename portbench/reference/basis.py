"""BASIS (Jayaram & Thickstun 2020) with dB mixing, in plain PyTorch: the
annealed Langevin steps of K sources held to their mixture.

Per noise level ``sigma_i`` of ``L``, ``T`` steps of

    x <- x + eta (score(x) + lambda grad_g(x) (mixed - g(x))) + sqrt(2 eta) z

with ``eta = delta (sigma_i / sigma_L)^2``, ``lambda = 1 / sigma_i^2`` and
``z`` standard normal. Sources add in the power domain:
``g(x) = 10 / ln 10 (logsumexp_k(x_k ln 10 / 10) - ln K)``, whose gradient
is the softmax over the sources of ``x ln 10 / 10``. The step's constants
are rounded to float32, as a float32 program computes them.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

_C = math.log(10.0) / 10.0


def mix(xs: torch.Tensor):
    """``(g, grad_g)`` of sources stacked on axis 0."""
    g = (torch.logsumexp(xs * _C, dim=0) - math.log(xs.shape[0])) / _C
    return g, torch.softmax(xs * _C, dim=0)


def constants(sigmas: Sequence[float], level: int, delta: float):
    """``(eta, lambda, sqrt(2 eta))`` of one level, in float32."""
    sig = np.asarray(sigmas, np.float32)
    eta = np.float32(delta) * np.square(sig[level] / sig[-1])
    lam = np.float32(1.0) / np.square(sig[level])
    return float(eta), float(lam), float(np.sqrt(np.float32(2.0) * eta))


def run_level(score: Callable, x: torch.Tensor, mixed: torch.Tensor,
              sigmas, level: int, T: int, delta: float,
              noise: Callable) -> torch.Tensor:
    """``T`` steps of one level from ``x`` [K, N, ...]; ``score(x)`` gives
    the sources' scores at this level, ``noise(t)`` step t's draw."""
    eta, lam, scale = constants(sigmas, level, delta)
    x = x.clone()
    for t in range(T):
        s = score(x)
        g, grad = mix(x)
        x = x + eta * (s + lam * grad * (mixed - g))
        x = x + noise(t) * scale
    return x
