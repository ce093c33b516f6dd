"""The port's training data path (audiosourcesep_tpu_torch.data.tfrecord,
.data.loaders, the tf.signal mel ops) against audiosourcesep_tpu on the
CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu import data as jdata
from audiosourcesep_tpu.data import tfrecord as jtfrecord
from audiosourcesep_tpu.ops import linear_to_mel_weight_matrix as jlinear_mel
from audiosourcesep_tpu.ops import melspectrogram_tf_signal as jmel_tf
from audiosourcesep_tpu_torch import data as tdata
from audiosourcesep_tpu_torch.data import tfrecord as ttfrecord
from audiosourcesep_tpu_torch.ops.mel import linear_to_mel_weight_matrix
from audiosourcesep_tpu_torch.ops.spectrogram import melspectrogram_tf_signal

torch.set_num_threads(2)


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(96, 64).astype(np.float32) * 30 - 40,
            rng.randn(7).astype(np.float32),
            rng.randn(2, 4, 6).astype(np.float32)]


class TestTFRecord:
    @pytest.mark.parametrize("native", [True, False])
    def test_crc32c_known_value(self, monkeypatch, native):
        # RFC 3720: crc32c of 32 zero bytes is 0x8a9136aa; TFRecord masks
        # it (rotate right by 15, add 0xa282ead8)
        if not native:
            monkeypatch.setattr(ttfrecord, "_native", False)
        elif not ttfrecord._load_native():
            pytest.skip("no C++ compiler here for native/asr_native.cpp")
        crc = 0x8A9136AA
        masked = (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
        assert ttfrecord.masked_crc32c(b"\x00" * 32) == masked
        payload = np.random.RandomState(4).bytes(1000)
        assert ttfrecord.masked_crc32c(payload) == \
            jtfrecord.masked_crc32c(payload)

    def test_files_byte_identical_to_jax(self, tmp_path):
        arrays = _arrays()
        n = tdata.save_tf_records(arrays, str(tmp_path / "port"))
        assert n == 3
        jdata.save_tf_records(arrays, str(tmp_path / "jax"))
        assert (tmp_path / "port.tfrecord").read_bytes() == \
            (tmp_path / "jax.tfrecord").read_bytes()

    def test_each_reads_the_others(self, tmp_path):
        arrays = _arrays(1)
        tdata.save_tf_records(arrays, str(tmp_path / "port.tfrecord"))
        jdata.save_tf_records(arrays, str(tmp_path / "jax.tfrecord"))
        for got in (jdata.load_tf_records([str(tmp_path / "port.tfrecord")]),
                    tdata.load_tf_records(str(tmp_path / "jax.tfrecord"))):
            assert len(got) == 3
            for a, b in zip(arrays, got):
                assert a.shape == b.shape
                np.testing.assert_array_equal(a, b)

    def test_parse_serialize_inverse(self):
        a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        np.testing.assert_array_equal(
            tdata.parse_example(tdata.serialize_example(a)), a)
        assert tdata.serialize_example(a) == jdata.serialize_example(a)

    @pytest.mark.parametrize("offset", [-6, 3])      # payload, length
    def test_corrupt_crc_raises(self, tmp_path, offset):
        p = tmp_path / "c.tfrecord"
        tdata.save_tf_records([np.ones(4, np.float32)], str(p))
        raw = bytearray(p.read_bytes())
        raw[offset] ^= 0xFF
        p.write_bytes(bytes(raw))
        with pytest.raises(ValueError, match="corrupt"):
            tdata.load_tf_records([str(p)])


class TestDatasets:
    def test_array_dataset_batch_order_equals_jax(self):
        data = np.arange(50 * 3, dtype=np.float32).reshape(50, 3)
        for kw in ({"shuffle": True, "seed": 7},
                   {"shuffle": False, "drop_remainder": False}):
            t = tdata.ArrayDataset(data, 8, **kw)
            j = jdata.ArrayDataset(data, 8, **kw)
            assert len(t) == len(j) and t.n_examples == j.n_examples
            for _ in range(3):                       # three epochs
                tb, jb = list(t), list(j)
                assert len(tb) == len(jb)
                for a, b in zip(tb, jb):
                    np.testing.assert_array_equal(a, b)

    def test_load_melspec_ds_equals_jax(self, tmp_path):
        rng = np.random.RandomState(3)
        for split, files in (("train", 3), ("test", 1)):
            d = tmp_path / split / "sub"
            d.mkdir(parents=True)
            for i in range(files):
                jdata.save_tf_records(
                    [rng.randn(12, 8).astype(np.float32) for _ in range(5)],
                    str(d / f"song{i}"))
        args = (str(tmp_path / "train"), str(tmp_path / "test"))
        t = tdata.load_melspec_ds(*args, batch_size=4)
        j = jdata.load_melspec_ds(*args, batch_size=4)
        assert t[3:] == j[3:] == (15, 5)
        np.testing.assert_array_equal(t[2], j[2])             # minibatch
        assert t[2].shape == (4, 12, 8, 1)
        for ts, js in zip(t[:2], j[:2]):
            np.testing.assert_array_equal(ts.data, js.data)
            assert len(ts) == len(js)
            for a, b in zip(ts, js):
                np.testing.assert_array_equal(a, b)
        assert len(t[1]) == 2                # the eval remainder is kept

    def test_npy_spectrograms_and_wav_windows_equal_jax(self, tmp_path):
        specs = _arrays(2)[:1] * 3
        (tmp_path / "a" / "b").mkdir(parents=True)
        assert tdata.save_mel_spectrograms(specs, str(tmp_path / "a" / "s")) \
            == 3
        jdata.save_mel_spectrograms(specs, str(tmp_path / "a" / "b" / "s"))
        for name in ("load_spec", "load_spec_tf"):
            got = getattr(tdata, name)(str(tmp_path / "a"))
            want = getattr(jdata, name)(str(tmp_path / "a"))
            assert len(got) == len(want) == (3 if name == "load_spec" else 6)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        t = np.arange(3 * 16000) / 16000
        tdata.write_wav(str(tmp_path / "w1.wav"),
                        (0.3 * np.sin(2 * np.pi * 330 * t)).astype(np.float32),
                        16000)
        np.testing.assert_array_equal(
            tdata.load_multiple_wav(str(tmp_path), 1.0),
            jdata.load_multiple_wav(str(tmp_path), 1.0))


class TestTFSignalMel:
    def test_linear_to_mel_weight_matrix_equals_jax(self):
        for args in ((64, 1025, 16000.0, 0.0, 8000.0),
                     (96, 513, 22050.0, 125.0, 3800.0)):
            np.testing.assert_array_equal(linear_to_mel_weight_matrix(*args),
                                          jlinear_mel(*args))

    # f32 FFTs of different libraries on power values up to ~1e5: 1e-4
    # relative to the largest value
    @pytest.mark.parametrize("frame_length,n_fft", [(2048, 2048),
                                                    (3000, 2048),
                                                    (1000, 2048)])
    def test_melspectrogram_tf_signal_matches_jax(self, frame_length, n_fft):
        rng = np.random.RandomState(5)
        audio = (0.5 * rng.randn(2, 5000)).astype(np.float32)
        kw = dict(sr=16000, frame_length=frame_length, n_fft=n_fft,
                  hop_length=512, n_mels=32)
        want = np.asarray(jmel_tf(jnp.asarray(audio), **kw))
        got = melspectrogram_tf_signal(torch.from_numpy(audio), **kw).numpy()
        assert got.shape == want.shape == (2, 10, 32)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
