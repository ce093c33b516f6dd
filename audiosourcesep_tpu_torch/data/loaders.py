"""Song extracts for separation (port of ``load_wav`` and ``get_song_extract`` in ``audiosourcesep_tpu/data/loaders.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.mel import power_to_db
from ..ops.spectrogram import melspectrogram
from ..ops.stft import stft
from .wav import load_audio


def load_wav(path: str, length_sec: float, sr: Optional[int] = None,
             hop_sec: Optional[float] = None) -> Tuple[np.ndarray, int]:
    """Load a wav mono (optionally resampled) and window it into
    ``int(rate * length_sec)``-sample chunks, dropping the remainder;
    ``hop_sec`` < ``length_sec`` gives overlapping windows. Returns
    ``([n_windows, L], rate)``."""
    song, rate = load_audio(path, sr=sr, mono=True)
    L = int(rate * length_sec)
    hop = L if hop_sec is None else max(int(rate * hop_sec), 1)
    if hop == L:
        n = len(song) // L
        return song[:n * L].reshape(n, L), rate
    starts = np.arange(0, len(song) - L + 1, hop)
    return np.stack([song[s:s + L] for s in starts]), rate


def get_song_extract(mix_path: str, piano_path: str, violin_path: str,
                     duration: float, length_sec: float = 2.04,
                     sr: int = 16000, n_fft: int = 2048,
                     hop_length: int = 512, n_mels: int = 96,
                     fmin: float = 125.0, fmax: float = 7600.0,
                     dbmin: float = -100.0, dbmax: float = 20.0,
                     use_dB: bool = True, skip_frames: int = 2,
                     device="cpu"):
    """Load mixture + sources, window them, and compute the mel
    spectrograms and the complex mixture STFT (kept for phase-reuse
    inversion) on ``device``.

    Returns ``(mel_spec [3][n, n_mels, F, 1], raw_audio [3][T],
    stft_mixture [n, bins, F] complex64)`` as numpy arrays.
    """
    n_extract = int(round(duration / length_sec))
    windows = []
    for path in (mix_path, piano_path, violin_path):
        w, _ = load_wav(path, length_sec, sr=sr)
        windows.append(w[skip_frames: skip_frames + n_extract])
    raw_audio = [w.reshape(-1) for w in windows]

    all_w = torch.as_tensor(np.stack(windows), device=device)    # [3, n, L]
    stft_mixture = stft(all_w[0], n_fft=n_fft, hop_length=hop_length)
    stft_mixture = stft_mixture.cpu().numpy().astype(np.complex64)

    if use_dB:
        # unclipped mel power -> power_to_db with the per-window top_db=80
        # floor (it must see the unclipped window max) -> clip to the dB range
        mels = melspectrogram(all_w, sr=sr, n_fft=n_fft,
                              hop_length=hop_length, n_mels=n_mels,
                              fmin=fmin, fmax=fmax, use_dB=False, clip=False)
        mels = torch.clamp(power_to_db(mels, top_db=80.0, window_ndim=2),
                           dbmin, dbmax)
    else:
        mels = melspectrogram(all_w, sr=sr, n_fft=n_fft,
                              hop_length=hop_length, n_mels=n_mels,
                              fmin=fmin, fmax=fmax, dbmin=dbmin,
                              dbmax=dbmax, use_dB=False)
    mels = mels.cpu().numpy()
    mel_spec = [mels[i][..., None] for i in range(3)]
    return mel_spec, raw_audio, stft_mixture
