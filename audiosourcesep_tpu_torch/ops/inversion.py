"""Spectrogram inversion: NNLS mel->STFT, Griffin-Lim, phase reuse, Wiener
(port of ``audiosourcesep_tpu/ops/inversion.py``).

Every step is a batched tensor computation on the input's device: the
NNLS is an accelerated projected-gradient (FISTA) solve made of f32
matmuls, Griffin-Lim a loop of STFT/iSTFT round trips on complex64
tensors. Random initial phases come from an explicit ``torch.Generator``
or are passed in.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from .mel import db_to_power, mel_filterbank
from .stft import istft, stft


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls on the card in full f32 (no TF32) for the block, as the
    JAX package pins ``Precision.HIGHEST``, whatever the caller set.

    ``allow_tf32`` is PyTorch's legacy switch; setting it keeps the legacy
    and the newer ``fp32_precision`` settings in agreement (cuBLAS refuses
    to run when they disagree). The caller's TF32 choice is restored
    afterwards."""
    m = torch.backends.cuda.matmul
    was = m.fp32_precision          # readable in every state
    m.allow_tf32 = False
    try:
        yield
    finally:
        if was == "tf32":
            m.allow_tf32 = True
        else:
            m.fp32_precision = was


def mel_to_stft(melspec: torch.Tensor, sr: int = 16000, n_fft: int = 2048,
                fmin: float = 125.0, fmax: float = 7600.0,
                power: float = 2.0, n_iter: int = 300) -> torch.Tensor:
    """Approximate inverse of a mel *power* spectrogram -> STFT magnitude.

    Solves ``argmin_{x>=0} ||A x - M||^2`` per frame (librosa's NNLS) with
    ``n_iter`` FISTA steps of size ``1/||A||_2^2``, all frames at once.

    Args:
        melspec: ``[..., n_mels, F]`` mel power spectrogram (float32, or
            float64 for a reference run).
    Returns:
        ``[..., n_fft//2 + 1, F]`` STFT magnitude (``x ** (1/power)``).
    """
    n_mels, n_frames = melspec.shape[-2:]
    a_np = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    # Lipschitz constant of the gradient, on the host in float64
    lip = float(np.linalg.norm(a_np.astype(np.float64), 2) ** 2)
    a = torch.as_tensor(a_np, dtype=melspec.dtype, device=melspec.device)
    batch = melspec.shape[:-2]
    # frames of every batch entry side by side: [n_mels, prod(batch) * F]
    b = melspec.reshape(-1, n_mels, n_frames).permute(1, 0, 2).reshape(
        n_mels, -1)
    # the momentum scalar t in the input's precision, as in the JAX scan
    dt = np.float64 if melspec.dtype == torch.float64 else np.float32
    with _full_f32_matmul():
        ata = a.T @ a
        atb = a.T @ b
        x = torch.zeros_like(atb)
        y, t = x, dt(1.0)
        for _ in range(n_iter):
            x_new = torch.clamp_min(y - (ata @ y - atb) / lip, 0.0)
            t_new = dt(0.5) * (dt(1.0) + np.sqrt(dt(1.0) + dt(4.0) * t * t))
            y = x_new + float((t - dt(1.0)) / t_new) * (x_new - x)
            x, t = x_new, t_new
    x = x.reshape(x.shape[0], -1, n_frames).permute(1, 0, 2)
    return torch.pow(x.reshape(*batch, -1, n_frames), 1.0 / power)


def griffin_lim(magnitude: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                n_fft: int = 2048, hop_length: int = 512, n_iter: int = 32,
                momentum: float = 0.99, length: Optional[int] = None,
                angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction with momentum (librosa defaults).

    Args:
        magnitude: ``[..., n_fft//2 + 1, F]`` STFT magnitude.
        generator: draws the initial phases, uniform in turns, on
            ``magnitude``'s device.
        angles: the initial phases in turns (``[0, 1)``, ``magnitude``'s
            shape) instead of ``generator``'s draws; tests pass the JAX
            package's ``uniform(key)`` draws here.
    Returns:
        ``[..., T]`` audio.
    """
    if angles is None:
        angles = torch.rand(magnitude.shape, generator=generator,
                            device=magnitude.device)
    angles = torch.exp(2j * np.pi * angles.to(magnitude.device,
                                              torch.float32))
    S = magnitude.to(torch.complex64)
    eps = 1e-16
    mcoef = momentum / (1.0 + momentum)
    tprev = torch.zeros_like(S)
    for _ in range(n_iter):
        inv = istft(S * angles, n_fft=n_fft, hop_length=hop_length)
        rebuilt = stft(inv, n_fft=n_fft, hop_length=hop_length)
        angles = rebuilt - mcoef * tprev
        angles = angles / (torch.abs(angles) + eps)
        tprev = rebuilt
    return istft(S * angles, n_fft=n_fft, hop_length=hop_length,
                 length=length)


def mel_to_audio(melspec: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 sr: int = 16000, n_fft: int = 2048, hop_length: int = 512,
                 fmin: float = 125.0, fmax: float = 7600.0, n_iter: int = 32,
                 length: Optional[int] = None,
                 angles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mel power spectrogram -> audio via NNLS + Griffin-Lim
    (librosa.feature.inverse.mel_to_audio)."""
    mag = mel_to_stft(melspec, sr=sr, n_fft=n_fft, fmin=fmin, fmax=fmax)
    return griffin_lim(mag, generator, n_fft=n_fft, hop_length=hop_length,
                       n_iter=n_iter, length=length, angles=angles)


def single_channel_wiener_filter(psd_sources: torch.Tensor,
                                 stft_mixture: torch.Tensor) -> torch.Tensor:
    """``(PSD_i / sum_j PSD_j) * stft_mix``.

    Args:
        psd_sources: ``[n_src, ..., n_bins, F]`` power spectrograms.
        stft_mixture: complex ``[..., n_bins, F]``.
    """
    return (psd_sources / (psd_sources.sum(dim=0) + 1e-10)) * stft_mixture


def phase_reuse(magnitudes: torch.Tensor,
                stft_mixture: torch.Tensor) -> torch.Tensor:
    """``|S_i| * exp(i * angle(stft_mix))``."""
    phase = stft_mixture / (torch.abs(stft_mixture) + 1e-16)
    return magnitudes.to(torch.complex64) * phase


def invert_melspec_reuse_phase(melspecs: torch.Tensor,
                               stft_mixture: torch.Tensor, scale: str = "dB",
                               wiener_filter: bool = False, sr: int = 16000,
                               n_fft: int = 2048, hop_length: int = 512,
                               fmin: float = 125.0, fmax: float = 7600.0,
                               length: Optional[int] = None) -> torch.Tensor:
    """Batched phase-reuse inversion of separated mel spectrograms: mel ->
    STFT magnitude via NNLS, then the mixture's phase (or, with more than
    one source, single-channel Wiener filtering), then iSTFT.

    Args:
        melspecs: ``[n_src, ..., n_mels, F]`` in dB or power scale.
        stft_mixture: complex ``[..., n_bins, F]``, on ``melspecs``' device.
    Returns:
        ``[n_src, ..., T]`` audio.
    """
    if scale == "dB":
        melspecs = db_to_power(melspecs)
    mags = mel_to_stft(melspecs, sr=sr, n_fft=n_fft, fmin=fmin, fmax=fmax)
    if wiener_filter and melspecs.shape[0] > 1:
        stft_est = single_channel_wiener_filter(torch.square(mags),
                                                stft_mixture)
    else:
        stft_est = phase_reuse(mags, stft_mixture)
    return istft(stft_est, n_fft=n_fft, hop_length=hop_length, length=length)
