"""Mixing models g(x1..xK) and their gradients for BASIS (port of ``audiosourcesep_tpu/separation/mixing.py``).

Sources are stacked on a leading axis ``[K, ...]``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

_LN10 = math.log(10.0)


def mixing_process(data_type: str, scale: str = "dB"
                   ) -> Tuple[Callable, Callable]:
    """Return ``(g, grad_g)`` over stacked sources ``[K, ...]``.

    * ``data_type='image'``: the mean of the sources; gradient 1/K.
    * power scale: ``g = (mean sqrt(s))^2`` with the reference's gradient
      expression (a direction, off the analytic one by a constant).
    * dB scale: sources add in the power domain,
      ``g = 10/ln10 * (logsumexp(x * ln10/10) - ln K)``; the gradient is
      the softmax over sources.
    """
    if data_type == "image":
        def g(sources):
            return sources.mean(dim=0)

        def grad_g(sources):
            return torch.ones_like(sources) / float(sources.shape[0])

    elif scale == "power":
        def g(sources):
            return torch.square(torch.sqrt(sources).mean(dim=0))

        def grad_g(sources):
            mean_sqrt = torch.sqrt(sources).mean(dim=0, keepdim=True)
            return torch.square(mean_sqrt) / (torch.sqrt(sources) + 1e-8)

    else:  # dB
        def g(sources):
            K = sources.shape[0]
            return (10.0 / _LN10) * (
                torch.logsumexp(sources * (_LN10 / 10.0), dim=0)
                - math.log(float(K)))

        def grad_g(sources):
            return torch.softmax(sources * (_LN10 / 10.0), dim=0)

    return g, grad_g
