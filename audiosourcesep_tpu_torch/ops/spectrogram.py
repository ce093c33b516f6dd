"""Batched mel spectrogram (port of ``melspectrogram`` in ``audiosourcesep_tpu/ops/spectrogram.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mel import mel_filterbank
from .stft import stft


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
