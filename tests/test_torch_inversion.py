"""Inversion of the port (audiosourcesep_tpu_torch.ops: istft and
ops.inversion) against audiosourcesep_tpu.ops, float32 on the CPU.

Tolerances, from the same comparisons at these sizes: the FISTA NNLS
agrees to ~1e-4 of the power's max (held to 1e-3); after ``** (1/2)`` the
magnitude's max-rel grows near zero, so it is held by its mean-rel
(1e-3). Griffin-Lim with the JAX package's initial phases agrees to ~4e-7
rel-L2 after 4 iterations (held to 1e-5); over 32 the 0.99 momentum
amplifies FFT rounding to ~2e-5 (held to 1e-3). The phase-reuse
inversion of a tone separation agrees to ~8e-4 rel-L2 (held to 1e-3); with
the Wiener filter the per-bin ratio PSD_1 / (PSD_1 + PSD_2) magnifies the
NNLS's f32 rounding where one source's solution is near zero, to ~3e-3
(held to 5e-3): the JAX package's own f32 result lies 1.8e-3 from the
same inversion in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.ops import inversion as jinv
from audiosourcesep_tpu.ops import istft as jistft
from audiosourcesep_tpu.ops import melspectrogram as jmelspectrogram
from audiosourcesep_tpu.ops import stft as jstft
from audiosourcesep_tpu_torch.ops import inversion as inv
from audiosourcesep_tpu_torch.ops.stft import istft

torch.set_num_threads(2)
SR = 16000


def _mels(shape, seed):
    """Mel power spectrograms spanning 1e-6 .. 20 (dB -60 .. 13)."""
    rng = np.random.default_rng(seed)
    return (10.0 ** rng.uniform(-6, 1.3, shape)).astype(np.float32)


def _stft_mixture(n_frames, seed):
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((n_frames, 512 * (16 - 1))).astype(
        np.float32)
    return np.asarray(jstft(jnp.asarray(audio))).astype(np.complex64)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("length", [None, 20000, 40000])
def test_istft_matches_jax(length):
    rng = np.random.default_rng(0)
    spec = (rng.standard_normal((3, 1025, 64))
            + 1j * rng.standard_normal((3, 1025, 64))).astype(np.complex64)
    got = istft(torch.from_numpy(spec), length=length).numpy()
    want = np.asarray(jistft(jnp.asarray(spec), length=length))
    assert got.shape == want.shape == (3, length or 512 * 63)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    if length == 40000:    # zero-padded past the signal
        assert not got[:, 512 * 63:].any()


def test_stft_istft_round_trip():
    x = np.random.default_rng(1).standard_normal((2, 32256)).astype(
        np.float32)
    spec = jstft(jnp.asarray(x))
    got = istft(torch.from_numpy(np.array(spec)), length=32256).numpy()
    np.testing.assert_allclose(got, x, atol=1e-5)


def test_mel_to_stft_matches_jax():
    mel = _mels((2, 96, 64), 2)
    got = inv.mel_to_stft(torch.from_numpy(mel), power=1.0).numpy()
    want = np.asarray(jinv.mel_to_stft(jnp.asarray(mel), power=1.0))
    assert got.shape == want.shape == (2, 1025, 64)
    assert _rel(got, want) < 1e-3
    mag = inv.mel_to_stft(torch.from_numpy(mel)).numpy()
    jmag = np.asarray(jinv.mel_to_stft(jnp.asarray(mel)))
    np.testing.assert_allclose(mag, np.sqrt(got), rtol=1e-6)
    assert np.abs(mag - jmag).mean() / np.abs(jmag).mean() < 1e-3


def test_mel_to_stft_in_float64_agrees_and_batches():
    mel = _mels((2, 3, 96, 8), 3)
    got = inv.mel_to_stft(torch.from_numpy(mel), power=1.0)
    ref = inv.mel_to_stft(torch.from_numpy(mel).double(), power=1.0)
    assert got.dtype == torch.float32 and ref.dtype == torch.float64
    assert got.shape == (2, 3, 1025, 8)
    assert _rel(got.numpy(), ref.numpy()) < 1e-3
    # frames are solved independently of their batch neighbours
    one = inv.mel_to_stft(torch.from_numpy(mel[1, 2]), power=1.0)
    np.testing.assert_allclose(one.numpy(), got[1, 2].numpy(), rtol=1e-5,
                               atol=1e-6 * float(got.abs().max()))


@pytest.mark.parametrize("api", ["allow_tf32", "fp32_precision"])
def test_mel_to_stft_runs_in_full_f32_and_restores_tf32(monkeypatch, api):
    m = torch.backends.cuda.matmul
    seen = []
    real_matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append((m.allow_tf32, m.fp32_precision))
        return real_matmul(a, b)

    monkeypatch.setattr(m, api, True if api == "allow_tf32" else "tf32")
    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    inv.mel_to_stft(torch.from_numpy(_mels((96, 4), 4)), n_iter=2)
    assert m.fp32_precision == "tf32"
    assert len(seen) == 4 and set(seen) == {(False, "ieee")}


def _two_tones(seconds=2.0):
    t = np.arange(int(SR * seconds)) / SR
    return (0.4 * np.sin(2 * np.pi * 220.0 * t)
            + 0.3 * np.sin(2 * np.pi * 554.4 * t)).astype(np.float32)


@pytest.mark.parametrize("n_iter,tol", [(4, 1e-5), (32, 1e-3)])
def test_griffin_lim_matches_jax_with_its_phases(n_iter, tol):
    mag = np.abs(np.asarray(jstft(jnp.asarray(_two_tones())))).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    turns = np.array(jax.random.uniform(key, mag.shape))
    got = inv.griffin_lim(torch.from_numpy(mag), n_iter=n_iter,
                          angles=torch.from_numpy(turns)).numpy()
    want = np.asarray(jinv.griffin_lim(jnp.asarray(mag), key,
                                       n_iter=n_iter))
    assert got.shape == want.shape == (512 * (mag.shape[-1] - 1),)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < tol


def test_griffin_lim_generator_is_seeded_and_length_pads():
    mag = torch.from_numpy(np.abs(np.asarray(jstft(jnp.asarray(
        _two_tones(0.5))))).astype(np.float32))
    runs = [inv.griffin_lim(mag, torch.Generator().manual_seed(s),
                            n_iter=2, length=9000) for s in (0, 0, 1)]
    assert runs[0].shape == (9000,)
    assert torch.isfinite(runs[0]).all()
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


def test_mel_to_audio_matches_jax_with_its_phases():
    mel = _mels((2, 96, 16), 5)
    key = jax.random.PRNGKey(6)
    turns = np.array(jax.random.uniform(key, (2, 1025, 16)))
    got = inv.mel_to_audio(torch.from_numpy(mel), n_iter=4,
                           angles=torch.from_numpy(turns)).numpy()
    want = np.asarray(jinv.mel_to_audio(jnp.asarray(mel), key, n_iter=4))
    assert got.shape == want.shape == (2, 512 * 15)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3


def test_wiener_and_phase_reuse_match_jax():
    psd = _mels((2, 3, 1025, 16), 7)
    mix = _stft_mixture(3, 8)
    got = inv.single_channel_wiener_filter(torch.from_numpy(psd),
                                           torch.from_numpy(mix)).numpy()
    want = np.asarray(jinv.single_channel_wiener_filter(jnp.asarray(psd),
                                                        jnp.asarray(mix)))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    got = inv.phase_reuse(torch.from_numpy(psd), torch.from_numpy(mix))
    want = np.asarray(jinv.phase_reuse(jnp.asarray(psd), jnp.asarray(mix)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def _separation(n_frames, seed):
    """Mel power spectrograms of two tones with a little noise, and the
    complex STFT of their sum: frames of 15 hops, as a separation gives."""
    t = np.arange(n_frames * 512 * 15) / SR
    noise = 0.01 * np.random.default_rng(seed).standard_normal((2, t.size))
    src = np.stack([
        0.4 * np.sin(2 * np.pi * 220.0 * t) * (1 + 0.3 * np.sin(
            2 * np.pi * 2.0 * t)),
        0.4 * np.sin(2 * np.pi * 554.4 * t + 3 * np.sin(2 * np.pi * 5.0 * t)),
    ]) + noise
    src = jnp.asarray(src.reshape(2, n_frames, -1).astype(np.float32))
    mels = np.array(jmelspectrogram(src, clip=False))
    mix = np.array(jstft(src.sum(axis=0))).astype(np.complex64)
    return mels, mix


@pytest.mark.parametrize("scale", ["dB", "power"])
@pytest.mark.parametrize("wiener", [False, True])
def test_invert_melspec_reuse_phase_matches_jax(scale, wiener):
    mels, mix = _separation(3, 9)
    if scale == "dB":
        mels = (10.0 * np.log10(np.maximum(mels, 1e-10))).astype(np.float32)
    got = inv.invert_melspec_reuse_phase(
        torch.from_numpy(mels), torch.from_numpy(mix), scale=scale,
        wiener_filter=wiener).numpy()
    want = np.asarray(jinv.invert_melspec_reuse_phase(
        jnp.asarray(mels), jnp.asarray(mix), scale=scale,
        wiener_filter=wiener))
    assert got.shape == want.shape == (2, 3, 512 * 15)
    tol = 5e-3 if wiener else 1e-3
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < tol
