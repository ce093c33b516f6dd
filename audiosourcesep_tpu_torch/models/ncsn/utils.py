"""NCSN noise schedule (port of ``get_sigmas`` in ``audiosourcesep_tpu/models/ncsn/utils.py``)."""

from __future__ import annotations

import numpy as np


def get_sigmas(sigma1: float, sigmaL: float, num_classes: int,
               progression: str = "geometric") -> np.ndarray:
    """Noise schedule; both progressions give the same geometric
    sequence (kept for CLI compatibility)."""
    if progression == "geometric":
        sigmas = np.exp(np.linspace(np.log(sigma1), np.log(sigmaL),
                                    num=num_classes))
    elif progression == "logarithmic":
        sigmas = np.logspace(np.log10(sigma1), np.log10(sigmaL),
                             num=num_classes)
    else:
        raise ValueError("progression should be geometric or logarithmic")
    return sigmas.astype(np.float32)
