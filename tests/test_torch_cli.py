"""The port's separation CLI (audiosourcesep_tpu_torch.run_basis_sep) at
tiny size on the CPU, from synthetic wavs and a JAX-format checkpoint, and
the port's independence from JAX."""

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
from audiosourcesep_tpu_torch import run_basis_sep

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


def test_cli_cpu_tiny_writes_results(tmp_path, song_dir, ckpt_dir):
    out = str(tmp_path / "basis")
    run_basis_sep.main([ckpt_dir, ckpt_dir, "--output", out,
                        "--song_dir", song_dir, "--model_type", "ncsn",
                        "--version", "v1", "--n_mixed", "2", "--T", "2",
                        "--num_classes", "2", "--n_filters", "4",
                        "--device", "cpu", "--winograd"])
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


@pytest.mark.parametrize("flag", [["--inverse"], ["--model_type", "glow"],
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


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['audiosourcesep_tpu'] = None\n"
        "import audiosourcesep_tpu_torch\n"
        "import audiosourcesep_tpu_torch.run_basis_sep\n"
        "import audiosourcesep_tpu_torch.kernels.build\n"
        "import audiosourcesep_tpu_torch.ops.winograd\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in "
        "sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
