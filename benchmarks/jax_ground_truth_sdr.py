#!/usr/bin/env python3
"""Ground-truth SDR and SIR of the JAX package's inversion, on the CPU, on
the synthetic song of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 benchmarks/jax_ground_truth_sdr.py

Writes ``chip_smoke.py``'s 70 s piano/violin/mix wavs (with its own
``_write_song``) to a temporary directory and takes the 30-frame extract
that the separation CLI takes (``get_song_extract``, dB scale). It then inverts the
two ground-truth mel spectrograms as ``melspec_inversion_basis.py
--algorithm reuse_phase --wiener_filter`` does (NNLS, Wiener filter of the
mixture STFT, frame by frame), writes and reads them back as PCM16 wavs,
and scores them with ``bss_eval`` against the raw stems, aligned per
window. ``chip_smoke.py`` holds the port's inversion on the card to these
numbers.
"""

import os
import shutil
import sys
import tempfile
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from audiosourcesep_tpu.data import (get_song_extract, read_wav,  # noqa: E402
                                     write_wav)
from audiosourcesep_tpu.evaluation import bss_eval  # noqa: E402
from audiosourcesep_tpu.ops import invert_melspec_reuse_phase  # noqa: E402
# the song and the window sizes are chip_smoke.py's own
from chip_smoke import W_INV, W_RAW, _write_song  # noqa: E402

SR, N_FRAMES = 16000, 30


def main():
    work = tempfile.mkdtemp(prefix="gt_sdr_")
    try:
        _write_song(work)
        mel_spec, raw_audio, stft_mixture = get_song_extract(
            *(os.path.join(work, f"{n}.wav")
              for n in ("mix", "piano", "violin")), 2.04 * N_FRAMES,
            use_dB=True)
        gts = np.stack([mel_spec[1][..., 0], mel_spec[2][..., 0]])
        t0 = time.time()
        audio = np.asarray(invert_melspec_reuse_phase(
            jax.numpy.asarray(gts), jax.numpy.asarray(stft_mixture),
            scale="dB", wiener_filter=True, sr=SR, n_fft=2048,
            hop_length=512, fmin=125.0, fmax=7600.0))
        print(f"inversion: {time.time() - t0:.2f} s on the CPU")
        refs, ests = [], []
        for i in range(2):
            path = os.path.join(work, f"gt{i + 1}.wav")
            write_wav(path, np.concatenate(list(audio[i])), SR)
            est, _ = read_wav(path)
            raw = raw_audio[i + 1]
            refs.append(np.concatenate(
                [raw[k * W_RAW:k * W_RAW + W_INV] for k in range(N_FRAMES)]))
            ests.append(est[:N_FRAMES * W_INV])
        t0 = time.time()
        sdr, _, sir, _, _ = bss_eval(
            np.stack(refs)[:, :, None], np.stack(ests)[:, :, None],
            window=np.inf, hop=np.inf, compute_permutation=False)
        print(f"bss_eval: {time.time() - t0:.2f} s on the host")
        for i in range(2):
            print(f"source {i + 1}: SDR {float(np.nanmean(sdr[i])):.4f} dB, "
                  f"SIR {float(np.nanmean(sir[i])):.4f} dB")
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
