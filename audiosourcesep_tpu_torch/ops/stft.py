"""Batched STFT and iSTFT with librosa conventions (port of
``audiosourcesep_tpu/ops/stft.py``).

* window: periodic Hann of length ``win_length`` (default ``n_fft``),
  zero-padded centred to ``n_fft``;
* ``center=True``: input reflect-padded by ``n_fft // 2`` on both sides;
* frames: ``1 + len(x) // hop`` when centred.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window_np(win_length: int, periodic: bool = True) -> np.ndarray:
    """Periodic Hann window as float64 numpy
    (``scipy.signal.get_window('hann', n, fftbins=True)``)."""
    n = win_length + 1 if periodic else win_length
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / max(n - 1, 1)))
    return w[:-1] if periodic else w


def hann_window(win_length: int, periodic: bool = True,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """:func:`hann_window_np` as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(hann_window_np(win_length, periodic), dtype=dtype,
                           device=device)


def _pad_center_np(window: np.ndarray, n_fft: int) -> np.ndarray:
    pad = n_fft - window.shape[0]
    lpad = pad // 2
    return np.pad(window, (lpad, pad - lpad))


def frame_signal(x: torch.Tensor, frame_length: int,
                 hop_length: int) -> torch.Tensor:
    """Slice ``x[..., T]`` into overlapping frames ``[..., n_frames,
    frame_length]``, ``n_frames = 1 + (T - frame_length) // hop_length``
    (none when ``T < frame_length``); a view of ``x``."""
    if x.shape[-1] < frame_length:
        return x.new_empty((*x.shape[:-1], 0, frame_length))
    return x.unfold(-1, frame_length, hop_length)


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


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
          win_length: Optional[int] = None, center: bool = True,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with NOLA-normalised overlap-add (librosa.istft).

    Complex ``[..., n_fft//2 + 1, n_frames]`` -> real ``[..., T]``. The
    windowed frames are overlap-added with ``F.fold`` and divided by the
    summed squared window, floored at 1e-11 as the JAX package does (where
    ``torch.istft`` would raise instead). ``center`` trims ``n_fft // 2``
    at both ends; ``length`` then trims or zero-pads the end.
    """
    win_length = win_length or n_fft
    w_np = _pad_center_np(hann_window_np(win_length), n_fft)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * torch.as_tensor(w_np, dtype=frames.dtype,
                                      device=frames.device)
    batch, n_frames = frames.shape[:-2], frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    # fold sums each frame's n_fft samples into its hop-spaced slot
    y = F.fold(frames.reshape(-1, n_frames, n_fft).transpose(1, 2),
               output_size=(1, out_len), kernel_size=(1, n_fft),
               stride=(1, hop_length)).reshape(*batch, out_len)

    wsq = np.zeros(out_len, np.float64)
    for s in range(0, hop_length * n_frames, hop_length):
        wsq[s:s + n_fft] += w_np ** 2
    y = y / torch.as_tensor(np.maximum(wsq, 1e-11), dtype=y.dtype,
                            device=y.device)

    if center:
        y = y[..., n_fft // 2: out_len - n_fft // 2]
    if length is not None:
        y = y[..., :length]
        if y.shape[-1] < length:
            y = F.pad(y, (0, length - y.shape[-1]))
    return y
