"""Oracle separation systems: IBM, IRM, MWF + mel-domain variants.

The port's own copy of ``audiosourcesep_tpu/evaluation/oracles.py``
(derived from sigsep-mus-oracle): upper-bound baselines that use
ground-truth sources to build time-frequency masks. STFTs follow
scipy.signal.stft defaults (nperseg=2048) so numbers are comparable. They
run on the host.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import istft as _istft
from scipy.signal import stft as _stft

_EPS = np.finfo(np.float64).eps
_NFFT = 2048


def _stft_all(x: np.ndarray, nfft: int = _NFFT):
    """x: [nsampl, nchan] -> complex [nchan, F, T]."""
    return _stft(x.T, nperseg=nfft)[-1]


def _istft_trim(X: np.ndarray, n: int) -> np.ndarray:
    """complex [nchan, F, T] -> [nsampl, nchan] trimmed to n."""
    return _istft(X)[1].T[:n, :]


def IBM(mixture: np.ndarray, sources: np.ndarray, alpha: float = 1,
        theta: float = 0.5, nfft: int = _NFFT) -> np.ndarray:
    """Ideal binary mask.

    mixture: [nsampl, nchan]; sources: [nsrc, nsampl, nchan].
    """
    N = mixture.shape[0]
    X = _stft_all(mixture, nfft)
    estimates = np.zeros_like(sources)
    for i, source in enumerate(sources):
        Yj = _stft_all(source, nfft)
        mask = (np.abs(Yj) ** alpha
                / (_EPS + np.abs(X) ** alpha) >= theta).astype(X.real.dtype)
        estimates[i] = _istft_trim(X * mask, N)
    return estimates


def IRM(mixture: np.ndarray, sources: np.ndarray,
        alpha: float = 2, nfft: int = _NFFT) -> np.ndarray:
    """Ideal ratio (soft) mask."""
    N = mixture.shape[0]
    X = _stft_all(mixture, nfft)
    specs = np.stack([np.abs(_stft_all(s, nfft)) ** alpha
                      for s in sources])
    model = _EPS + specs.sum(axis=0)
    estimates = np.zeros_like(sources)
    for i in range(len(sources)):
        estimates[i] = _istft_trim(X * (specs[i] / model), N)
    return estimates


def _invert2x2(M: np.ndarray, eps: float) -> np.ndarray:
    """Explicit 2x2 inverse over the trailing dims."""
    det = eps + M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    inv = np.empty_like(M)
    inv[..., 0, 0] = M[..., 1, 1]
    inv[..., 1, 1] = M[..., 0, 0]
    inv[..., 0, 1] = -M[..., 0, 1]
    inv[..., 1, 0] = -M[..., 1, 0]
    return inv / det[..., None, None]


def MWF(mixture: np.ndarray, sources: np.ndarray,
        nfft: int = _NFFT) -> np.ndarray:
    """Multichannel Wiener filter with time-invariant spatial covariances.
    Requires nchan == 2 (explicit 2x2 inverses)."""
    N = mixture.shape[0]
    X = _stft_all(mixture, nfft)             # [I, F, T]
    I = X.shape[0]

    P, R, Rjj_all = [], [], []
    for source in sources:
        Yj = _stft_all(source, nfft)
        # observed covariance [F, T, I, I]
        Rjj = np.einsum("aft,bft->ftab", Yj, np.conj(Yj))
        Pj = np.mean(np.abs(Yj) ** 2, axis=0)            # [F, T]
        Rj = np.mean(Rjj / (_EPS + Pj[..., None, None]), axis=1)  # [F, I, I]
        trace = np.trace(Rj, axis1=-2, axis2=-1)
        Rj = Rj * I / trace[..., None, None] + _EPS * np.eye(I)
        Rj_inv = _invert2x2(Rj, _EPS)
        # refined PSD
        Pj = np.real(np.einsum("fab,ftba->ft", Rj_inv, Rjj)) / I
        P.append(Pj)
        R.append(Rj)
        Rjj_all.append(Rjj)

    Cxx = sum(Pj[..., None, None] * Rj[:, None]
              for Pj, Rj in zip(P, R))                   # [F, T, I, I]
    invCxx = _invert2x2(Cxx, _EPS)

    estimates = np.zeros_like(sources)
    for i in range(len(sources)):
        SR = P[i][..., None, None] * R[i][:, None]       # [F, T, I, I]
        G = np.einsum("ftac,ftcb->ftab", SR, invCxx)
        Yj = np.einsum("ftab,bft->aft", G, X)
        estimates[i] = _istft_trim(Yj, N)
    return estimates


def IBM_melspec(mixture: np.ndarray, sources: np.ndarray,
                theta: float = 0.5) -> np.ndarray:
    """Binary mask directly on mel spectrograms."""
    mask = (sources / (_EPS + mixture) >= theta).astype(sources.dtype)
    return mixture * mask


def IRM_melspec(mixture: np.ndarray, sources: np.ndarray,
                alpha: float = 2) -> np.ndarray:
    """Ratio mask directly on mel spectrograms. (``alpha`` is kept for API
    parity; the ratio of the given spectrograms is applied directly.)"""
    model = sources.sum(axis=0) + _EPS
    return mixture * (sources / model)
