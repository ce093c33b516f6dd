"""Datasets: wav windows, melspec TFRecord datasets, the MNIST / CIFAR-10 image sets, npy spectrograms, song extracts for separation (port of ``audiosourcesep_tpu/data/loaders.py``).

Host-side data is plain numpy (thousands of 96x64 patches or 32x32
images); batches are drawn by :class:`ArrayDataset` with the JAX
package's shuffle, so the same seed gives the same batch order. Under
data parallelism each process holds its shard of the examples
(``num_hosts`` / ``host_id``), the JAX package's shards exactly.
"""

from __future__ import annotations

import os
import re
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.mel import power_to_db
from ..ops.spectrogram import melspectrogram
from ..ops.stft import stft
from .tfrecord import load_tf_records
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


def load_multiple_wav(path: str, length_sec: float) -> np.ndarray:
    """Walk ``path`` for .wav files and concatenate their windows
    (preprocessing.py:29-57)."""
    wav_files = []
    for root, _, files in os.walk(os.path.abspath(path)):
        wav_files += [os.path.join(root, f) for f in files
                      if re.match(r".*\.wav$", f)]
    windows = [load_wav(f, length_sec)[0] for f in sorted(wav_files)]
    print(f"{len(wav_files)} wav files loaded")
    return np.concatenate(windows, axis=0) if windows else np.zeros((0, 0))


# ---------------------------------------------------------------------------
# in-memory dataset with reference-compatible batching
# ---------------------------------------------------------------------------

class ArrayDataset:
    """Shuffled, batched iteration over a numpy array: drop_remainder by
    default, like the reference's training batches; ``drop_remainder=False``
    keeps the final partial batch (the reference's eval batching). Each
    pass draws a new permutation from ``np.random.RandomState(seed)``.

    ``num_hosts > 1``: this process keeps examples ``host_id::num_hosts``,
    cut to ``len(data) // num_hosts`` so that every process runs the same
    number of batches (a process with one batch more would wait alone in
    the step's collective). ``n_global`` is the count before the cut."""

    def __init__(self, data: np.ndarray, batch_size: Optional[int],
                 shuffle: bool = True, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0,
                 drop_remainder: bool = True):
        self.n_global = len(data)
        if num_hosts > 1:
            data = data[host_id::num_hosts][:len(data) // num_hosts]
        self.data = data
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        if self.batch_size is None:
            return len(self.data)
        if self.drop_remainder:
            return len(self.data) // self.batch_size
        return -(-len(self.data) // self.batch_size)

    @property
    def n_examples(self) -> int:
        return len(self.data)

    def __iter__(self) -> Iterator[np.ndarray]:
        idx = np.arange(len(self.data))
        if self.shuffle:
            self._rng.shuffle(idx)
        bs = self.batch_size
        if bs is None:
            yield self.data[idx]
            return
        for i in range(len(self)):
            yield self.data[idx[i * bs:(i + 1) * bs]]


# ---------------------------------------------------------------------------
# melspec TFRecord datasets (data_loader.py:69-110)
# ---------------------------------------------------------------------------

def _find_tfrecords(dirpath: str) -> List[str]:
    files = []
    for root, _, names in os.walk(os.path.abspath(dirpath)):
        files += [os.path.join(root, f) for f in names
                  if re.match(r".*\.tfrecord$", f)]
    return sorted(files)


def load_melspec_ds(train_dirpath: str, test_dirpath: str,
                    batch_size: Optional[int] = 256, shuffle: bool = True,
                    seed: int = 0, num_hosts: int = 1, host_id: int = 0):
    """Load train/test melspec TFRecords.

    Returns ``(ds_train, ds_test, minibatch, n_train, n_test)``
    (data_loader.py:69-110): arrays get a trailing channel axis, training
    batches drop the remainder, evaluation batches keep it in a single
    process (a test split smaller than a batch would otherwise give no
    validation batch), and ``minibatch`` is the first training batch
    (drawn from ``ds_train``, so its shuffle advances as in the JAX
    package). ``num_hosts > 1``: each process holds its shard
    (:class:`ArrayDataset`) at the local ``batch_size``, evaluation drops
    its remainder too (every process must run the same batches), and
    ``minibatch`` is the first ``batch_size`` examples before sharding,
    the same on every process (a data-dependent init must not differ).
    ``n_train`` and ``n_test`` count every process's examples.
    """
    train = np.stack(load_tf_records(_find_tfrecords(train_dirpath)))
    test = np.stack(load_tf_records(_find_tfrecords(test_dirpath)))
    train = train[..., None].astype(np.float32)
    test = test[..., None].astype(np.float32)
    ds_train = ArrayDataset(train, batch_size, shuffle, seed, num_hosts,
                            host_id)
    ds_test = ArrayDataset(test, batch_size, shuffle, seed + 1, num_hosts,
                           host_id, drop_remainder=num_hosts > 1)
    if num_hosts > 1:
        minibatch = train[:max(batch_size, 1)]
    else:
        minibatch = next(iter(ds_train))
    return ds_train, ds_test, minibatch, len(train), len(test)


# ---------------------------------------------------------------------------
# toy images: MNIST / CIFAR-10 (data_loader.py:10-66)
# ---------------------------------------------------------------------------

def load_toydata(dataset: str = "mnist", batch_size: int = 256,
                 seed: int = 0, data_dir: Optional[str] = None,
                 num_hosts: int = 1, host_id: int = 0):
    """MNIST (zero-padded 28 -> 32) or CIFAR-10 as float32 NHWC arrays in
    [0, 256). Returns ``(ds_train, ds_test, minibatch)``.

    The data come from an npz with ``x_train`` and ``x_test`` (uint8):
    ``data_dir``, else ``ASR_MNIST_NPZ`` / ``ASR_CIFAR10_NPZ``, else the
    Keras cache (``~/.keras/datasets/mnist.npz`` / ``cifar10.npz``).
    Nothing is downloaded. ``scripts/build_mnist_cache.py --idx-dir``
    builds the MNIST npz from the raw IDX files, and
    ``scripts/build_cifar10_cache.py`` the CIFAR-10 one from the python
    batches. ``scripts/build_mnist_cache.py --synthetic-digits`` writes a
    stand-in that is NOT MNIST: sklearn's 8x8 digits upsampled to 28x28
    (its npz says so under ``provenance``, and this loader prints it), so
    no bits/dim or PSNR measured on it is an MNIST number.

    Training batches drop the remainder; the evaluation set is iterated
    in batches of up to 5,000 images, its remainder kept. The minibatch
    for data-dependent init is the first training batch. ``num_hosts >
    1``: each process holds its shard of both sets (:class:`ArrayDataset`),
    evaluates in batches of ``min(5000, n_test) // num_hosts`` with the
    remainder dropped, and takes the first ``batch_size`` training images
    before sharding as the minibatch, the same on every process.
    """
    if dataset == "mnist":
        path = (data_dir or os.environ.get("ASR_MNIST_NPZ")
                or os.path.expanduser("~/.keras/datasets/mnist.npz"))
        hint = ("build it with scripts/build_mnist_cache.py (nothing is "
                "downloaded)")
    elif dataset == "cifar10":
        path = (data_dir or os.environ.get("ASR_CIFAR10_NPZ")
                or os.path.expanduser("~/.keras/datasets/cifar10.npz"))
        hint = ("build it from the python batches with "
                "scripts/build_cifar10_cache.py (nothing is downloaded)")
    else:
        raise ValueError("dataset should be mnist or cifar10")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{dataset} cache not found at {path}; "
                                f"{hint}")
    with np.load(path) as d:
        x_train, x_test = d["x_train"], d["x_test"]
        if "provenance" in d.files:
            print(f"{dataset} cache {path}: provenance {d['provenance']}")
    if dataset == "mnist":
        x_train = np.pad(x_train, ((0, 0), (2, 2), (2, 2)))[..., None]
        x_test = np.pad(x_test, ((0, 0), (2, 2), (2, 2)))[..., None]
    x_train = x_train.astype(np.float32)
    x_test = x_test.astype(np.float32)
    ds_train = ArrayDataset(x_train, batch_size, True, seed, num_hosts,
                            host_id)
    # the evaluation batch is per process, bounded by the shard
    ds_test = ArrayDataset(x_test,
                           max(min(5000, len(x_test)) // num_hosts, 1),
                           False, seed, num_hosts, host_id,
                           drop_remainder=num_hosts > 1)
    if num_hosts > 1:
        minibatch = x_train[:max(batch_size, 1)]
    else:
        minibatch = next(iter(ds_train))
    return ds_train, ds_test, minibatch


def get_mixture_toydata(dataset: str = "mnist", n_mixed: int = 10,
                        seed: int = 0, data_dir: Optional[str] = None,
                        dequant: Optional[Tuple[np.ndarray, np.ndarray]]
                        = None,
                        generator: Optional[torch.Generator] = None):
    """Two dequantised image batches and their mean mixture. Returns
    ``(mixed, gt1, gt2, minibatch)`` as float32 numpy arrays.

    The sources are the first two ``n_mixed`` batches of the shuffled
    training set, each plus a uniform draw on [0, 1) in the raw [0, 256)
    scale (the separation CLI rescales per model type). ``dequant``
    gives the two draws (the JAX package's, in the tests); without it
    they are drawn from ``generator`` on the CPU.
    """
    ds, _, minibatch = load_toydata(dataset, n_mixed, seed, data_dir)
    it = iter(ds)
    gt1, gt2 = next(it), next(it)
    if dequant is None:
        dequant = [torch.rand(gt1.shape, generator=generator).numpy()
                   for _ in range(2)]
    gt1 = (gt1 + dequant[0]).astype(np.float32)
    gt2 = (gt2 + dequant[1]).astype(np.float32)
    return (gt1 + gt2) / 2.0, gt1, gt2, minibatch


def get_song_extract(mix_path: str, piano_path: str, violin_path: str,
                     duration: float, length_sec: float = 2.04,
                     sr: int = 16000, n_fft: int = 2048,
                     hop_length: int = 512, n_mels: int = 96,
                     fmin: float = 125.0, fmax: float = 7600.0,
                     dbmin: float = -100.0, dbmax: float = 20.0,
                     use_dB: bool = True, skip_frames: int = 2,
                     device="cuda"):
    """Load mixture + sources, window them, and compute the mel
    spectrograms and the complex mixture STFT (kept for phase-reuse
    inversion) on ``device``: the card by default, as the JAX package
    computes them on its device; ``cuda`` raises without a card (no
    fallback to the CPU).

    Returns ``(mel_spec [3][n, n_mels, F, 1], raw_audio [3][T],
    stft_mixture [n, bins, F] complex64)`` as numpy arrays.
    """
    from ..cli import resolve_device
    device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# npy spectrogram storage (preprocessing.py:128-184)
# ---------------------------------------------------------------------------

def save_mel_spectrograms(spectrograms, filename: str) -> int:
    """Save each spectrogram as ``{filename}_{i}.npy``
    (preprocessing.py:128-143)."""
    count = 0
    for i, spect in enumerate(spectrograms):
        np.save(f"{filename}_{i}", np.asarray(spect))
        count += 1
    return count


def load_spec(directory: str) -> List[np.ndarray]:
    """Load all .npy spectrograms of one directory
    (preprocessing.py:146-164)."""
    files = sorted(f for f in os.listdir(directory) if f.endswith(".npy"))
    return [np.load(os.path.join(directory, f)) for f in files]


def load_spec_tf(directory: str) -> List[np.ndarray]:
    """Walk a directory tree and load every .npy spectrogram
    (preprocessing.py:167-184)."""
    out: List[np.ndarray] = []
    for root, _, files in os.walk(os.path.abspath(directory)):
        if any(f.endswith(".npy") for f in files):
            out.extend(load_spec(root))
    return out
