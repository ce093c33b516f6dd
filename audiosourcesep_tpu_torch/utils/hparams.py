"""NCSNv2 hyperparameter techniques (Song & Ermon 2020; port of
``audiosourcesep_tpu/utils/hparams.py``).

Technique 1 (the largest pairwise distance of the training set gives
sigma_1) is a blocked Gram product on the device. Techniques 2 and 4 are
scalar root finds in scipy, copied from the JAX package (scipy is imported
by them, not with this module: it takes seconds).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def max_pairwise_distance(X: np.ndarray, block: int = 512,
                          device="cuda") -> float:
    """Technique 1: the largest Euclidean distance over all pairs of
    samples, from ``||x - y||^2 = ||x||^2 + ||y||^2 - 2 x.y`` computed a
    block of rows at a time as matmuls in float32 on ``device``. TF32 is
    kept off for the products: the three terms cancel, and TF32's 10-bit
    mantissa would lose the difference. ``cuda`` raises without a card
    (no fallback to the CPU)."""
    from ..cli import resolve_device
    flat = torch.as_tensor(np.reshape(X, (len(X), -1)), dtype=torch.float32,
                           device=resolve_device(device))
    sq = torch.sum(flat * flat, dim=1)
    best = 0.0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(0, len(flat), block):
            gram = flat[i:i + block] @ flat.T
            d2 = sq[i:i + block, None] + sq[None, :] - 2.0 * gram
            best = max(best, float(torch.max(d2)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return math.sqrt(max(best, 0.0))


def technique1_sigma1(X: np.ndarray, minval: float = -100.0,
                      maxval: float = 20.0, max_samples: int = 2000,
                      device="cuda") -> float:
    """sigma_1 for NCSNv2: the largest pairwise distance of the first
    ``max_samples`` spectrograms rescaled to [0, 1]
    (technique1_ncsnv2.py:18-37)."""
    X = np.asarray(X[:max_samples])
    X = (X - minval) / (maxval - minval)
    return max_pairwise_distance(X, device=device)


def technique2_gamma(D: int, sigma1: float, sigmaL: float,
                     verbose: bool = True) -> Tuple[float, float]:
    """Noise-schedule ratio gamma such that Phi(sqrt(2D)(g-1)+3g) -
    Phi(sqrt(2D)(g-1)-3g) = 0.5 (technique2and4_ncsnv2.py:6-27).

    Returns (gamma, implied num_classes)."""
    from scipy import optimize, stats     # seconds to import: used here only

    def t2(gamma):
        cdf1 = stats.norm.cdf(np.sqrt(2.0 * D) * (gamma - 1.0) + 3 * gamma)
        cdf2 = stats.norm.cdf(np.sqrt(2.0 * D) * (gamma - 1.0) - 3 * gamma)
        return cdf1 - cdf2 - 0.5

    opt = optimize.root_scalar(t2, x0=0.5, x1=1.0, bracket=[0.5, 1.0])
    if not opt.converged and verbose:
        print("DID NOT FIND ROOT FOR GAMMA")
    gamma = opt.root
    n = np.log(sigmaL / sigma1) / np.log(gamma)
    if verbose:
        print(f"gamma={round(gamma, 4)}")
        print(f"num_classes = {round(n, 0)}")
    return gamma, n


def technique4_epsilon(T: float, sigmaL: float, gamma: float,
                       verbose: bool = True) -> float:
    """Langevin step size epsilon from the NCSNv2 paper's fixed-point
    condition (technique2and4_ncsnv2.py:30-44)."""
    from scipy import optimize
    s2 = sigmaL ** 2

    def t4(eps):
        decay = (1.0 - eps / s2) ** (2 * T)
        denom = s2 - s2 * (1.0 - eps / s2) ** 2
        ratio = 2.0 * eps / denom
        return decay * (gamma ** 2 - ratio) + ratio - 1.0

    opt = optimize.root_scalar(t4, x0=1e-6, x1=1e-4)
    if not opt.converged and verbose:
        print("DID NOT FIND ROOT FOR EPSILON")
    if verbose:
        print(f"epsilon={opt.root}")
    return opt.root
