"""Mel filterbanks and dB conversions (port of ``audiosourcesep_tpu/ops/mel.py``).

The filterbanks are constant numpy matrices: librosa's (slaney scale and
norm, ``librosa.filters.mel``) and ``tf.signal``'s (HTK scale, no norm,
``linear_to_mel_weight_matrix``). The dB conversions are PyTorch tensor
functions with librosa semantics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def hz_to_mel_slaney(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep,
                    f / f_sp)


def mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   htk: bool = False, norm: Optional[str] = "slaney",
                   dtype=np.float32) -> np.ndarray:
    """librosa.filters.mel equivalent: ``[n_mels, 1 + n_fft//2]``."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sr / 2.0, n_bins)

    to_mel = hz_to_mel_htk if htk else hz_to_mel_slaney
    to_hz = mel_to_hz_htk if htk else mel_to_hz_slaney
    mel_f = to_hz(np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, None]
    return weights.astype(dtype)


def linear_to_mel_weight_matrix(num_mel_bins: int, num_spectrogram_bins: int,
                                sample_rate: float,
                                lower_edge_hertz: float = 125.0,
                                upper_edge_hertz: float = 3800.0,
                                dtype=np.float32) -> np.ndarray:
    """``tf.signal.linear_to_mel_weight_matrix`` equivalent:
    ``[num_spectrogram_bins, num_mel_bins]`` (HTK scale, unnormalised,
    DC bin dropped)."""
    bands_to_zero = 1
    nyquist = sample_rate / 2.0
    freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[bands_to_zero:]
    spec_mel = hz_to_mel_htk(freqs)[:, None]
    edges = np.linspace(hz_to_mel_htk(lower_edge_hertz),
                        hz_to_mel_htk(upper_edge_hertz), num_mel_bins + 2)
    lower, center, upper = (edges[:-2][None, :], edges[1:-1][None, :],
                            edges[2:][None, :])
    lower_slope = (spec_mel - lower) / (center - lower)
    upper_slope = (upper - spec_mel) / (upper - center)
    w = np.maximum(0.0, np.minimum(lower_slope, upper_slope))
    return np.pad(w, [[bands_to_zero, 0], [0, 0]]).astype(dtype)


def power_to_db(S: torch.Tensor, ref: float = 1.0, amin: float = 1e-10,
                top_db: Optional[float] = 80.0,
                window_ndim: Optional[int] = None) -> torch.Tensor:
    """``10*log10(max(S, amin)) - 10*log10(max(ref, amin))`` with an
    optional ``top_db`` floor (librosa semantics).

    ``window_ndim=None`` floors against the whole-array max; for batched
    windows pass the number of trailing per-window axes (2 for
    ``[..., n_mels, F]``) so the floor is per window, as the reference's
    per-window ``librosa.power_to_db`` calls are.
    """
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * float(np.log10(max(ref, amin)))
    if top_db is not None:
        if window_ndim is None:
            peak = log_spec.max()
        else:
            peak = log_spec.amax(dim=tuple(range(-window_ndim, 0)),
                                 keepdim=True)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def db_to_power(S_db: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    return ref * torch.pow(10.0, 0.1 * S_db)
