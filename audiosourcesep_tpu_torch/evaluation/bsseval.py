"""BSS Eval v4 metrics (SDR / ISR / SIR / SAR) — vectorized numpy.

The port's own copy of ``audiosourcesep_tpu/evaluation/bsseval.py`` (the
port imports nothing of the JAX package), derived from sigsep's bsseval v4:
framewise separation quality with least-squares time-invariant distortion
filters of length ``filters_len``. Gram matrices of delayed reference
sources are built from FFT cross-correlations (Toeplitz blocks), a block
linear solve gives the projection filters, and the estimate splits into
s_true/e_spat/e_interf/e_artif.

This is an offline metric that runs on the host; numpy is the right tool.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
from scipy.signal import fftconvolve

MAX_SOURCES = 100
_EPS = np.finfo(np.float64).eps


def _any_source_silent(sources: np.ndarray) -> bool:
    return bool(np.any(np.all(np.sum(
        sources, axis=tuple(range(2, sources.ndim))) == 0, axis=1)))


def validate(reference_sources: np.ndarray,
             estimated_sources: np.ndarray) -> None:
    if reference_sources.shape != estimated_sources.shape:
        raise ValueError(
            f"shape mismatch: references {reference_sources.shape} vs "
            f"estimates {estimated_sources.shape}")
    if reference_sources.ndim > 3:
        raise ValueError("inputs must be (nsrc, nsampl, nchan)")
    if reference_sources.size and _any_source_silent(reference_sources):
        raise ValueError("all reference sources must be non-silent")
    if estimated_sources.size and _any_source_silent(estimated_sources):
        raise ValueError("all estimated sources must be non-silent")
    if reference_sources.shape[0] > MAX_SOURCES:
        raise ValueError(f"too many sources (> {MAX_SOURCES})")


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _frames(window, hop, length):
    """Overlapping window slices (bsseval v4's Framing)."""
    if not (window < length):
        return [slice(0, length)]
    nwin = int(math.floor((length - window + hop) / hop))
    out = []
    for t in range(nwin):
        start = int(math.floor(t * hop))
        stop = min(int(math.floor(t * hop + window)), length)
        out.append(slice(start, stop))
    return out


# ---------------------------------------------------------------------------
# correlations / filters (vectorized)
# ---------------------------------------------------------------------------

def _stem_ffts(signals: np.ndarray, filters_len: int) -> np.ndarray:
    """FFT of zero-padded stems. signals: [M, nsampl] -> [M, n_fft]."""
    nsampl = signals.shape[-1]
    n_fft = int(2 ** math.ceil(math.log2(nsampl + filters_len - 1)))
    return np.fft.fft(signals, n=n_fft, axis=-1)


def _reference_correlations(reference_sources: np.ndarray,
                            filters_len: int):
    """Gram matrix of delayed references.

    reference_sources: [nsrc, nsampl, nchan]. Returns
    ``G [M, M, L, L]`` over stems ``M = nsrc*nchan`` (stem a = (src, chan)
    in C order) and the stem FFTs ``sf [M, n_fft]``.
    ``G[a, b, k, l] = <ref_a shifted by k, ref_b shifted by l>``.
    """
    nsrc, nsampl, nchan = reference_sources.shape
    stems = np.moveaxis(reference_sources, 1, 2).reshape(nsrc * nchan,
                                                         nsampl)
    sf = _stem_ffts(stems, filters_len)
    n_fft = sf.shape[-1]
    # circular cross-spectra: block (a, b) uses sf_a * conj(sf_b)
    cross = np.real(np.fft.ifft(
        sf[:, None, :] * np.conj(sf[None, :, :]), axis=-1))  # [M, M, n_fft]
    # Toeplitz gather: G[a, b, k, l] = r_ab[(l - k) mod n_fft]
    k = np.arange(filters_len)
    idx = (k[None, :] - k[:, None]) % n_fft                  # [L, L]
    G = cross[:, :, idx]
    return G, sf


def _projection_filters(G: np.ndarray, sf: np.ndarray,
                        estimated_source: np.ndarray,
                        filters_len: int) -> np.ndarray:
    """Least-squares filters projecting the estimate onto delayed references.

    G: [M, M, L, L]; sf: [M, n_fft]; estimated_source: [nsampl, nchan].
    Returns C: [M, L, nchan].
    """
    M = G.shape[0]
    nsampl, nchan = estimated_source.shape
    n_fft = sf.shape[-1]
    sef = np.fft.fft(estimated_source.T, n=n_fft, axis=-1)   # [nchan, n_fft]
    # D[a, l, c] = <ref_a shifted by l, est_c> = r[a, c][-l mod n_fft]
    cross = np.real(np.fft.ifft(
        sf[:, None, :] * np.conj(sef[None, :, :]), axis=-1))  # [M,nchan,nfft]
    lidx = (-np.arange(filters_len)) % n_fft
    D = np.moveaxis(cross[:, :, lidx], 1, 2)                 # [M, L, nchan]

    G_mat = np.transpose(G, (0, 2, 1, 3)).reshape(M * filters_len,
                                                  M * filters_len)
    D_mat = D.reshape(M * filters_len, nchan)
    try:
        C = np.linalg.solve(G_mat + _EPS * np.eye(G_mat.shape[0]), D_mat)
    except np.linalg.LinAlgError:
        C = np.linalg.lstsq(G_mat, D_mat, rcond=None)[0]
    return C.reshape(M, filters_len, nchan)


def _project(reference_stems: np.ndarray, C: np.ndarray,
             nsampl: int) -> np.ndarray:
    """Filter-and-sum projection. reference_stems: [M, nsampl];
    C: [M, L, nchan]. Returns [nsampl + L - 1, nchan]."""
    M, L, nchan = C.shape
    out = np.zeros((nsampl + L - 1, nchan))
    for a in range(M):
        # all channels of stem a at once: [L, nchan] filters
        conv = fftconvolve(C[a], reference_stems[a][:, None], axes=0)
        out += conv[:nsampl + L - 1]
    return out


def _safe_db(num: float, den: float) -> float:
    if den == 0:
        return np.inf
    return 10.0 * np.log10(num / den)


def _criteria(s_true, e_spat, e_interf, e_artif, sources_version: bool):
    """dB criteria of bsseval v4."""
    if sources_version:
        s_filt = s_true + e_spat
        energy = np.sum(s_filt ** 2)
        sdr = _safe_db(energy, np.sum((e_interf + e_artif) ** 2))
        isr = np.nan
        sir = _safe_db(energy, np.sum(e_interf ** 2))
        sar = _safe_db(np.sum((s_filt + e_interf) ** 2),
                       np.sum(e_artif ** 2))
    else:
        energy = np.sum(s_true ** 2)
        sdr = _safe_db(energy, np.sum((e_spat + e_interf + e_artif) ** 2))
        isr = _safe_db(energy, np.sum(e_spat ** 2))
        sir = _safe_db(np.sum((s_true + e_spat) ** 2),
                       np.sum(e_interf ** 2))
        sar = _safe_db(np.sum((s_true + e_spat + e_interf) ** 2),
                       np.sum(e_artif ** 2))
    return sdr, isr, sir, sar


# ---------------------------------------------------------------------------
# main entry points
# ---------------------------------------------------------------------------

def bss_eval(reference_sources, estimated_sources, window=2 * 44100,
             hop=1.5 * 44100, compute_permutation=False, filters_len=512,
             framewise_filters=False, bsseval_sources_version=False):
    """BSS Eval v4 (the API of sigsep's ``bss_eval``).

    Returns ``(sdr, isr, sir, sar, perm)``, each ``[nsrc, nwin]``.
    """
    estimated_sources = np.atleast_3d(np.asarray(estimated_sources,
                                                 np.float64))
    reference_sources = np.atleast_3d(np.asarray(reference_sources,
                                                 np.float64))
    validate(reference_sources, estimated_sources)
    if reference_sources.size == 0:
        return tuple(np.array([]) for _ in range(5))

    nsrc, nsampl, nchan = estimated_sources.shape
    L = filters_len

    if compute_permutation:
        perms = np.array(list(itertools.permutations(range(nsrc))))
    else:
        perms = np.arange(nsrc)[None, :]

    windows = _frames(window, hop, nsampl)
    nwin = len(windows)
    s_r = np.full((4, nsrc, nsrc, nwin), np.nan)

    def filters_for(win):
        ref = reference_sources[:, win]
        n = ref.shape[1]
        stems = np.moveaxis(ref, 1, 2).reshape(nsrc * nchan, n)
        G, sf = _reference_correlations(ref, L)
        # full-reference projection filters for each estimate
        C_full = [
            _projection_filters(G, sf, estimated_sources[j, win], L)
            for j in range(nsrc)]
        # single-reference filters per (true, est) pair needed
        C_single = {}
        for jtrue in range(nsrc):
            a0 = jtrue * nchan
            sub = slice(a0, a0 + nchan)
            G_jj = G[sub, sub]
            sf_j = sf[sub]
            for jest in set(perms[:, jtrue].tolist()):
                C_single[(jtrue, jest)] = _projection_filters(
                    G_jj, sf_j, estimated_sources[jest, win], L)
        return stems, C_full, C_single

    if not framewise_filters:
        stems_all, C_full, C_single = filters_for(slice(0, nsampl))

    for t, win in enumerate(windows):
        if framewise_filters:
            stems_all, C_full, C_single = filters_for(win)
            stems = stems_all
        else:
            stems = np.moveaxis(reference_sources[:, win], 1, 2).reshape(
                nsrc * nchan, -1)
        ref_slice = reference_sources[:, win]
        est_slice = estimated_sources[:, win]
        if _any_source_silent(ref_slice) or _any_source_silent(est_slice):
            continue
        n = ref_slice.shape[1]
        for jtrue in range(nsrc):
            for jest in set(perms[:, jtrue].tolist()):
                if not np.isnan(s_r[0, jtrue, jest, t]):
                    continue
                a0 = jtrue * nchan
                s_true = np.zeros((n + L - 1, nchan))
                s_true[:n] = ref_slice[jtrue]
                proj_single = _project(stems[a0:a0 + nchan],
                                       C_single[(jtrue, jest)], n)
                proj_full = _project(stems, C_full[jest], n)
                e_spat = proj_single - s_true
                e_interf = proj_full - s_true - e_spat
                e_artif = -s_true - e_spat - e_interf
                e_artif[:est_slice.shape[1]] += est_slice[jest]
                s_r[:, jtrue, jest, t] = _criteria(
                    s_true, e_spat, e_interf, e_artif,
                    bsseval_sources_version)

    # best permutation by mean SIR
    SIR = 2
    dum = np.arange(nsrc)
    if framewise_filters:
        mean_sir = np.stack([s_r[SIR, dum, p, :] for p in perms]).mean(1)
        popt = perms[np.argmax(mean_sir, axis=0)].T
        result = np.empty((4, nsrc, nwin))
        for m, t in itertools.product(range(4), range(nwin)):
            result[m, :, t] = s_r[m, dum, popt[:, t], t]
    else:
        mean_sir = np.array([np.mean(s_r[SIR, dum, p, :]) for p in perms])
        popt = perms[np.argmax(mean_sir)][:, None].repeat(nwin, 1)
        result = s_r[:, dum, popt[:, 0], :]

    return (result[0], result[1], result[2], result[3], popt)


def bss_eval_sources(reference_sources, estimated_sources,
                     compute_permutation=True):
    sdr, _, sir, sar, perm = bss_eval(
        reference_sources, estimated_sources, window=np.inf, hop=np.inf,
        compute_permutation=compute_permutation, filters_len=512,
        framewise_filters=True, bsseval_sources_version=True)
    return sdr, sir, sar, perm


def bss_eval_sources_framewise(reference_sources, estimated_sources,
                               window=30 * 44100, hop=15 * 44100,
                               compute_permutation=False):
    sdr, _, sir, sar, perm = bss_eval(
        reference_sources, estimated_sources, window=window, hop=hop,
        compute_permutation=compute_permutation, filters_len=512,
        framewise_filters=True, bsseval_sources_version=True)
    return sdr, sir, sar, perm


def bss_eval_images(reference_sources, estimated_sources,
                    compute_permutation=True):
    return bss_eval(
        reference_sources, estimated_sources, window=np.inf, hop=np.inf,
        compute_permutation=compute_permutation, filters_len=512,
        framewise_filters=True, bsseval_sources_version=False)


def bss_eval_images_framewise(reference_sources, estimated_sources,
                              window=30 * 44100, hop=15 * 44100,
                              compute_permutation=False):
    return bss_eval(
        reference_sources, estimated_sources, window=window, hop=hop,
        compute_permutation=compute_permutation, filters_len=512,
        framewise_filters=True, bsseval_sources_version=False)
