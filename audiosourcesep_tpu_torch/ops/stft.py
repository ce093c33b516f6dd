"""Batched STFT with librosa conventions (port of ``stft`` in ``audiosourcesep_tpu/ops/stft.py``).

* window: periodic Hann of length ``win_length`` (default ``n_fft``),
  zero-padded centred to ``n_fft``;
* ``center=True``: input reflect-padded by ``n_fft // 2`` on both sides;
* frames: ``1 + len(x) // hop`` when centred.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def hann_window_np(win_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window as float64 numpy
    (``scipy.signal.get_window('hann', n, fftbins=True)``)."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1)))
    return w[:-1] if periodic else w


def _pad_center_np(window: np.ndarray, n_fft: int) -> np.ndarray:
    pad = n_fft - window.shape[0]
    lpad = pad // 2
    return np.pad(window, (lpad, pad - lpad))


def stft(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         win_length: Optional[int] = None, center: bool = True
         ) -> torch.Tensor:
    """Batched STFT of a real ``[..., T]`` signal -> complex
    ``[..., n_fft//2 + 1, n_frames]`` (frequency-major, librosa's layout).
    """
    win_length = win_length or n_fft
    window = torch.as_tensor(
        _pad_center_np(hann_window_np(win_length), n_fft),
        dtype=x.dtype, device=x.device)
    batch = x.shape[:-1]
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft, hop_length,
                      n_fft, window, center=center, pad_mode="reflect",
                      normalized=False, onesided=True, return_complex=True)
    return spec.reshape(*batch, *spec.shape[-2:])
