"""Batched mel spectrograms, librosa's and tf.signal's (port of ``audiosourcesep_tpu/ops/spectrogram.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .mel import linear_to_mel_weight_matrix, mel_filterbank
from .stft import frame_signal, hann_window, stft


def db_limits_to_power(dbmin: float, dbmax: float) -> Tuple[float, float]:
    """Power clip range from dB limits."""
    return (float(np.exp(dbmin * np.log(10.0) / 10.0)),
            float(np.exp(dbmax * np.log(10.0) / 10.0)))


def melspectrogram(audio: torch.Tensor, sr: int = 16000, n_fft: int = 2048,
                   hop_length: int = 512, n_mels: int = 96,
                   fmin: float = 125.0, fmax: float = 7600.0,
                   dbmin: float = -100.0, dbmax: float = 20.0,
                   use_dB: bool = False, clip: bool = True) -> torch.Tensor:
    """librosa-parity mel spectrogram of ``[..., T]`` audio windows ->
    ``[..., n_mels, n_frames]`` power (or ``10*log10`` dB).

    ``clip`` clips the power to the range of ``[dbmin, dbmax]`` before the
    optional dB transform (the training-data transform); ``clip=False``
    keeps the raw power, which the separation input needs for
    ``power_to_db``'s per-window ``top_db`` floor.
    """
    spec = stft(audio, n_fft=n_fft, hop_length=hop_length)    # [..., bins, F]
    power = torch.square(torch.abs(spec))
    mel = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                          device=audio.device)
    melspec = torch.einsum("mb,...bf->...mf", mel, power)
    if clip:
        pmin, pmax = db_limits_to_power(dbmin, dbmax)
        melspec = torch.clamp(melspec, pmin, pmax)
    if use_dB:
        melspec = 10.0 * torch.log10(torch.clamp(melspec, min=1e-10))
    return melspec


def melspectrogram_tf_signal(audio: torch.Tensor, sr: int, frame_length: int,
                             n_fft: int = 2048, hop_length: int = 512,
                             n_mels: int = 128) -> torch.Tensor:
    """tf.signal-path mel spectrogram (preprocessing.py:104-125) of
    ``[..., T]`` audio -> ``[..., n_frames, n_mels]`` (frame-major): HTK
    mel over [0, sr/2], ``pad_end`` framing (``ceil(T / hop)`` frames),
    not centred, periodic Hann of ``frame_length``, and an ``n_fft``-point
    rfft of each frame (cropped to ``n_fft`` samples when the frame is
    longer, as ``rfft(n=n_fft)`` does)."""
    T = audio.shape[-1]
    n_frames = -(-T // hop_length)
    pad = max(0, (n_frames - 1) * hop_length + frame_length - T)
    x = F.pad(audio, (0, pad))
    frames = frame_signal(x, frame_length, hop_length)[..., :n_frames, :]
    frames = frames * hann_window(frame_length, dtype=x.dtype,
                                  device=x.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)          # [..., F, bins]
    power = torch.square(torch.abs(spec)).float()
    A = torch.as_tensor(linear_to_mel_weight_matrix(
        n_mels, n_fft // 2 + 1, sr, 0.0, sr / 2.0), device=audio.device)
    return torch.einsum("...fb,bm->...fm", power, A)
