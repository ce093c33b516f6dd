"""Audio front end of the port (stft, mel, melspectrogram, wav loading,
get_song_extract) against audiosourcesep_tpu, float32 on the CPU, on
synthetic wavs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.data import get_song_extract as jextract
from audiosourcesep_tpu.data import write_wav as jwrite_wav
from audiosourcesep_tpu.ops import melspectrogram as jmel
from audiosourcesep_tpu.ops import power_to_db as jp2db
from audiosourcesep_tpu.ops import stft as jstft
from audiosourcesep_tpu.ops.mel import mel_filterbank as jfilterbank
from audiosourcesep_tpu_torch.data import get_song_extract, read_wav
from audiosourcesep_tpu_torch.ops.mel import (db_to_power, mel_filterbank,
                                              power_to_db)
from audiosourcesep_tpu_torch.ops.spectrogram import melspectrogram
from audiosourcesep_tpu_torch.ops.stft import stft

torch.set_num_threads(2)
SR = 16000


def _tones(seconds, seed=0):
    t = np.arange(int(SR * seconds)) / SR
    rng = np.random.default_rng(seed)
    piano = 0.4 * np.sin(2 * np.pi * 220.0 * t) * (
        1 + 0.3 * np.sin(2 * np.pi * 2.0 * t))
    violin = 0.4 * np.sin(2 * np.pi * 554.4 * t + 3 * np.sin(
        2 * np.pi * 5.0 * t))
    noise = 0.01 * rng.standard_normal(t.shape)
    return [a.astype(np.float32) for a in
            (0.5 * (piano + violin) + noise, piano, violin)]


@pytest.fixture(scope="module")
def song_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("song")
    for name, audio in zip(("mix", "piano", "violin"), _tones(10.0)):
        jwrite_wav(str(d / f"{name}.wav"), audio, SR)
    return str(d)


def test_stft_matches_jax():
    x = np.stack(_tones(0.5, 1))[:, None, :4000]            # [3, 1, T]
    got = stft(torch.from_numpy(x), n_fft=512, hop_length=128).numpy()
    want = np.asarray(jstft(jnp.asarray(x), n_fft=512, hop_length=128))
    assert got.shape == want.shape == (3, 1, 257, 32)
    np.testing.assert_allclose(got, want, atol=2e-4 * np.abs(want).max())


def test_filterbank_and_melspectrogram_match_jax():
    np.testing.assert_array_equal(mel_filterbank(SR, 2048, 96, 125.0, 7600.0),
                                  jfilterbank(SR, 2048, 96, 125.0, 7600.0))
    x = np.stack(_tones(2.04, 2))[:, :32640]
    for use_dB, clip in ((False, False), (True, True)):
        got = melspectrogram(torch.from_numpy(x), use_dB=use_dB,
                             clip=clip).numpy()
        want = np.asarray(jmel(jnp.asarray(x), use_dB=use_dB, clip=clip))
        assert got.shape == (3, 96, 64)
        if use_dB:
            # within 60 dB of the peak to 1e-3 dB; further down both sit
            # closer to the f32 FFT round-off floor
            top = want > want.max() - 60.0
            np.testing.assert_allclose(got[top], want[top], atol=1e-3)
            np.testing.assert_allclose(got, want, atol=0.5)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-6 * want.max())


def test_power_to_db_window_floor_matches_jax():
    rng = np.random.default_rng(3)
    s = (10.0 ** rng.uniform(-14, 2, (3, 2, 6, 5))).astype(np.float32)
    for window_ndim in (None, 2):
        got = power_to_db(torch.from_numpy(s), top_db=80.0,
                          window_ndim=window_ndim).numpy()
        want = np.asarray(jp2db(jnp.asarray(s), top_db=80.0,
                                window_ndim=window_ndim))
        np.testing.assert_allclose(got, want, atol=1e-4)
    back = db_to_power(torch.from_numpy(10 * np.log10(s))).numpy()
    np.testing.assert_allclose(back, s, rtol=1e-4)


def test_get_song_extract_matches_jax(song_dir):
    paths = [f"{song_dir}/{n}.wav" for n in ("mix", "piano", "violin")]
    mel, raw, stft_mix = get_song_extract(*paths, duration=2 * 2.04,
                                          device="cpu")
    jmel_, jraw, jstft_mix = jextract(*paths, duration=2 * 2.04)
    for a, b in zip(raw, jraw):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert stft_mix.dtype == np.complex64 and stft_mix.shape == (2, 1025, 64)
    np.testing.assert_allclose(stft_mix, jstft_mix,
                               atol=2e-4 * np.abs(jstft_mix).max())
    for a, b in zip(mel, jmel_):
        assert a.shape == (2, 96, 64, 1)
        np.testing.assert_allclose(a, b, atol=1e-3)      # dB
    x, sr = read_wav(paths[0])
    assert sr == SR and x.dtype == np.float32


def test_get_song_extract_defaults_to_the_card(song_dir, monkeypatch):
    # the default device is the card; without one it raises instead of
    # falling back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = [f"{song_dir}/{n}.wav" for n in ("mix", "piano", "violin")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_song_extract(*paths, duration=2 * 2.04)
