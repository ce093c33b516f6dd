"""The port's separation and inversion CLIs
(audiosourcesep_tpu_torch.run_basis_sep, .melspec_inversion_basis) at tiny
size on the CPU, from synthetic wavs and a JAX-format checkpoint, and the
port's independence from JAX."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.data import write_wav
from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.training import CheckpointManager
from audiosourcesep_tpu_torch import melspec_inversion_basis, run_basis_sep
from audiosourcesep_tpu_torch.data import read_wav
from audiosourcesep_tpu_torch.evaluation import bss_eval

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def song_dir(tmp_path_factory):
    """Synthetic 10 s piano/violin/mix wavs at 16 kHz."""
    d = tmp_path_factory.mktemp("song")
    sr = 16000
    t = np.arange(10 * sr) / sr
    piano = 0.4 * np.sin(2 * np.pi * 220.0 * t) * (1 + 0.3 * np.sin(
        2 * np.pi * 2.0 * t))
    violin = 0.4 * np.sin(2 * np.pi * 554.4 * t + 3 * np.sin(
        2 * np.pi * 5.0 * t))
    for name, a in (("piano", piano), ("violin", violin),
                    ("mix", 0.5 * (piano + violin))):
        write_wav(str(d / f"{name}.wav"), a.astype(np.float32), sr)
    return str(d)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A JAX-trained-layout prior: ckpts/checkpoint.json + ckpt-1.npz."""
    d = tmp_path_factory.mktemp("prior")
    p = JRefineNet((96, 64, 1), 4, num_classes=2).init_params(
        jax.random.PRNGKey(0))
    CheckpointManager(str(d / "ckpts")).save({"params": p}, 1)
    return str(d)


@pytest.fixture(scope="module")
def basis_run(tmp_path_factory, song_dir, ckpt_dir):
    """One tiny CPU separation with --inverse (2 frames, 2 levels, T=2);
    returns its output directory."""
    out = str(tmp_path_factory.mktemp("runs") / "basis")
    run_basis_sep.main([ckpt_dir, ckpt_dir, "--output", out,
                        "--song_dir", song_dir, "--model_type", "ncsn",
                        "--version", "v1", "--n_mixed", "2", "--T", "2",
                        "--num_classes", "2", "--n_filters", "4",
                        "--device", "cpu", "--winograd", "--inverse"])
    return out


def test_cli_cpu_tiny_writes_results(basis_run):
    out = basis_run
    results = np.load(os.path.join(out, "results.npz"))
    for key in ("x1", "x2", "gt1", "gt2", "mixed", "stft_mixture"):
        assert key in results, key
    assert results["x1"].shape == (2, 96, 64)
    assert results["gt1"].shape == (2, 96, 64)
    assert np.isfinite(results["x1"]).all()
    assert results["x1"].min() >= -100.0 and results["x1"].max() <= 20.0
    assert results["stft_mixture"].dtype.kind == "c"
    conv = np.load(os.path.join(out, "results_convergence.npz"))
    assert conv["x1"].shape[0] == 3  # init + 2 levels
    for name in ("mix.wav", "ground_truth1.wav", "ground_truth2.wav"):
        assert os.path.exists(os.path.join(out, name))
    with open(os.path.join(out, "out.log")) as f:
        log = f.read()
    assert "Sigma = " in log and "Duration:" in log
    # --inverse: both frames of each source as one spectrogram
    for name in ("sep1.wav", "sep2.wav"):
        audio, sr = read_wav(os.path.join(out, name))
        assert sr == 16000 and audio.shape == (512 * (2 * 64 - 1),)
        assert np.isfinite(audio).all() and np.abs(audio).max() > 0


@pytest.mark.parametrize("flags,subdir,n_samples", [
    (["--algorithm", "reuse_phase", "--wiener_filter"],
     "inverse_reuse_phase_frame_wiener_filter", 2 * 512 * 63),
    (["--algorithm", "reuse_phase", "--method", "whole"],
     "inverse_reuse_phase_whole", 512 * 127),
    (["--algorithm", "griffin"], "inverse_griffin_frame", 2 * 512 * 63),
])
def test_inversion_cli_writes_its_outputs(basis_run, flags, subdir,
                                          n_samples):
    melspec_inversion_basis.main([basis_run, "--device", "cpu", *flags])
    out = os.path.join(basis_run, subdir)
    inv = np.load(os.path.join(out, "inverse_spectrograms.npz"))
    assert sorted(inv.files) == ["gt1_audio", "gt2_audio", "mix_audio",
                                 "x1_audio", "x2_audio"]
    for name, key in (("sep1", "x1"), ("sep2", "x2"), ("gt1", "gt1"),
                      ("gt2", "gt2"), ("mix", "mix")):
        a = inv[f"{key}_audio"]
        assert a.shape == (n_samples,) and np.isfinite(a).all()
        wav, sr = read_wav(os.path.join(out, f"{name}.wav"))
        assert sr == 16000 and wav.shape == (n_samples,)
    with open(os.path.join(out, "out.log")) as f:
        assert "Inversion duration:" in f.read()


def test_inversion_cli_ground_truth_sdr(basis_run):
    """Wiener filtering the mixture STFT with the true sources' PSDs must
    separate the two tones, scored with the port's bss_eval, as
    tests/test_cli_e2e.py scores the JAX package's inversion."""
    melspec_inversion_basis.main([basis_run, "--device", "cpu",
                                  "--algorithm", "reuse_phase",
                                  "--wiener_filter", "--output", "sdr"])
    inv_dir = os.path.join(basis_run, "sdr")
    g1, _ = read_wav(os.path.join(inv_dir, "gt1.wav"))
    g2, _ = read_wav(os.path.join(inv_dir, "gt2.wav"))
    raw1, _ = read_wav(os.path.join(basis_run, "ground_truth1.wav"))
    raw2, _ = read_wav(os.path.join(basis_run, "ground_truth2.wav"))
    # raw windows are 32640 samples, inverted ones hop * (frames - 1)
    W_RAW, W_INV, n_win = 32640, 32256, 2
    refs, ests = [], []
    for src_raw, src_inv in ((raw1, g1), (raw2, g2)):
        refs.append(np.concatenate(
            [src_raw[k * W_RAW:k * W_RAW + W_INV] for k in range(n_win)]))
        ests.append(src_inv[:n_win * W_INV])
    sdr, _, sir, _, _ = bss_eval(
        np.stack(refs)[:, :, None], np.stack(ests)[:, :, None],
        window=np.inf, hop=np.inf, compute_permutation=False)
    for i in range(2):
        assert float(np.nanmean(sdr[i])) > 4.0, (i, sdr)
        assert float(np.nanmean(sir[i])) > 20.0, (i, sir)


@pytest.mark.parametrize("flag", [["--dataset", "mnist"],
                                  ["--model_type", "glow"],
                                  ["--shard_sources"]])
def test_cli_refuses_what_is_not_ported(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_basis_sep.main(["a", "b", "--output", str(tmp_path),
                            "--song_dir", str(tmp_path), "--debug", *flag])


def test_cli_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_basis_sep.main(["a", "b", "--output", str(tmp_path),
                            "--song_dir", str(tmp_path), "--debug",
                            "--device", "cuda"])


def test_inversion_cli_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        melspec_inversion_basis.main([str(tmp_path), "--debug"])


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['audiosourcesep_tpu'] = None\n"
        "import audiosourcesep_tpu_torch\n"
        "import audiosourcesep_tpu_torch.run_basis_sep\n"
        "import audiosourcesep_tpu_torch.kernels.build\n"
        "import audiosourcesep_tpu_torch.ops.winograd\n"
        "import audiosourcesep_tpu_torch.ops.inversion\n"
        "import audiosourcesep_tpu_torch.evaluation\n"
        "import audiosourcesep_tpu_torch.melspec_inversion_basis\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in "
        "sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
