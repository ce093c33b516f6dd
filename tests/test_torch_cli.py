"""The port's CLIs at tiny size on the CPU, from synthetic wavs: the
separation and inversion CLIs (audiosourcesep_tpu_torch.run_basis_sep,
.melspec_inversion_basis) on a JAX-format checkpoint; the training chain
(.wav_to_spec -> .train_ncsn -> .run_basis_sep and
.ncsn_generate_samples) and the Glow chain (.train_glow ->
.train_noisy_glow -> .run_basis_sep --model_type glow), with checkpoints
crossing to and from the JAX package; and the port's independence from
JAX."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from audiosourcesep_tpu.data import write_wav
from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild_glow
from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.training import CheckpointManager
from audiosourcesep_tpu.training import init_train_state as jinit_state
from audiosourcesep_tpu.training import setup_optimizer as jsetup_optimizer
from audiosourcesep_tpu_torch import (melspec_inversion_basis,
                                      ncsn_generate_samples, run_basis_sep,
                                      train_glow, train_ncsn,
                                      train_noisy_glow, train_realnvp,
                                      wav_to_spec)
from audiosourcesep_tpu_torch.data import load_tf_records, read_wav
from audiosourcesep_tpu_torch.evaluation import bss_eval
from audiosourcesep_tpu_torch.training.checkpoint import load_flat

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


def test_shard_sources_on_one_process_is_ignored_and_separates(
        tmp_path, song_dir, ckpt_dir):
    """Without an even number of ranks --shard_sources prints the JAX
    script's line and separates on one process."""
    out = str(tmp_path / "sep")
    run_basis_sep.main([ckpt_dir, ckpt_dir, "--output", out, "--song_dir",
                        song_dir, "--n_mixed", "2", "--T", "1",
                        "--num_classes", "2", "--n_filters", "4",
                        "--device", "cpu", "--shard_sources"])
    with open(os.path.join(out, "out.log")) as f:
        assert "--shard_sources ignored (needs an even device count > 1)" \
            in f.read()
    res = np.load(os.path.join(out, "results.npz"))
    assert res["x1"].shape == (2, 96, 64) and np.isfinite(res["x1"]).all()


def test_separation_cli_under_the_ncsnv2_yaml(tmp_path, song_dir,
                                             monkeypatch):
    """``--config``: a copy of configs/melspec_ncsnv2.yml at 8 filters, 3
    levels and T=1, on random v2 priors written by training.checkpoint.
    The CLI builds v2 priors with the YAML's schedule (30 to 0.01,
    logarithmic, in place of the flags' default 1 to 0.01, geometric) and
    writes results.npz, one state a level besides the init."""
    from audiosourcesep_tpu_torch.models.ncsn import (get_score_model,
                                                      get_sigmas)
    from audiosourcesep_tpu_torch.training.checkpoint import (
        CheckpointManager as TManager, params_to_jax)
    with open(os.path.join(REPO, "configs", "melspec_ncsnv2.yml")) as f:
        cfg = yaml.safe_load(f)
    assert (cfg["version"], cfg["progression"]) == ("v2", "logarithmic")
    cfg.update(n_filters=8, num_classes=3, T=1)
    config = tmp_path / "ncsnv2.yml"
    config.write_text(yaml.safe_dump(cfg))
    sigmas = get_sigmas(30.0, 0.01, 3, "logarithmic")
    prior = tmp_path / "prior"
    m = get_score_model("v2", (96, 64, 1), 8, 3, sigmas=sigmas)
    m.reset_parameters(torch.Generator().manual_seed(0))
    TManager(str(prior / "ckpts")).save(
        {"params": params_to_jax(m.state_dict())}, 1)
    built, real = [], run_basis_sep.get_score_model

    def building(version, *args, sigmas=None, **kwargs):
        built.append((version, sigmas))
        return real(version, *args, sigmas=sigmas, **kwargs)

    monkeypatch.setattr(run_basis_sep, "get_score_model", building)
    out = str(tmp_path / "sep")
    run_basis_sep.main([str(prior), str(prior), "--output", out,
                        "--song_dir", song_dir, "--n_mixed", "2",
                        "--config", str(config), "--device", "cpu"])
    assert [v for v, _ in built] == ["v2", "v2"]
    for _, s in built:
        np.testing.assert_array_equal(s, sigmas)
    res = np.load(os.path.join(out, "results.npz"))
    assert res["x1"].shape == res["x2"].shape == (2, 96, 64)
    assert np.isfinite(res["x1"]).all() and np.isfinite(res["x2"]).all()
    conv = np.load(os.path.join(out, "results_convergence.npz"))
    assert conv["x1"].shape[0] == 4
    with open(os.path.join(out, "out.log")) as f:
        log = f.read()
    assert "Sigma = 30.0 (1 / 3) done" in log
    assert "progression = logarithmic" in log


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
    """Every module of the port imports with jax and the JAX package
    blocked."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['audiosourcesep_tpu'] = None\n"
        "import audiosourcesep_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'audiosourcesep_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'audiosourcesep_tpu_torch.train_ncsn' in names\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in "
        "sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# training: wav_to_spec -> train_ncsn -> run_basis_sep, ncsn_generate_samples
# ---------------------------------------------------------------------------

TINY = ["--n_filters", "4", "--num_classes", "2", "--T", "1",
        "--device", "cpu"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, song_dir):
    """``wav_to_spec --use_dB --tfrecords``: the piano and violin wavs
    into train/ (8 windows), the mix into test/ (4 windows)."""
    root = tmp_path_factory.mktemp("data")
    for split, names in (("train", ("piano", "violin")), ("test", ("mix",))):
        wavs = root / f"wavs_{split}"
        wavs.mkdir()
        for n in names:
            shutil.copy(os.path.join(song_dir, f"{n}.wav"), wavs / f"{n}.wav")
        wav_to_spec.main([str(wavs), str(root / "ds" / split), "--use_dB",
                          "--tfrecords", "--device", "cpu"])
    return str(root / "ds")


@pytest.fixture(scope="module")
def trained(tmp_path_factory, dataset):
    """One tiny ``train_ncsn --ema`` run (2 epochs, a Langevin snapshot
    each epoch); returns its output directory."""
    out = str(tmp_path_factory.mktemp("train") / "run")
    train_ncsn.main(["--dataset", dataset, "--output", out, "--ema",
                     "--n_epochs", "2", "--sample_every", "1",
                     "--batch_size", "2", *TINY])
    return out


def test_wav_to_spec_writes_the_dataset(dataset):
    recs = load_tf_records([os.path.join(dataset, "train", "piano.tfrecord")])
    assert len(recs) == 4 and recs[0].shape == (96, 64)
    assert all(-100.0 <= r.min() and r.max() <= 20.0 for r in recs)
    with open(os.path.join(dataset, "train", "out.log")) as f:
        assert "2 wav files saved as spectrograms" in f.read()


def test_wav_to_spec_npy_and_tf_signal(tmp_path, song_dir):
    wav_to_spec.main([song_dir, str(tmp_path / "npy"), "--device", "cpu"])
    assert np.load(tmp_path / "npy" / "mix_3.npy").shape == (96, 64)
    wav_to_spec.main([song_dir, str(tmp_path / "sig"), "--use_signal",
                      "--tfrecords", "--device", "cpu"])
    recs = load_tf_records([str(tmp_path / "sig" / "mix.tfrecord")])
    assert len(recs) == 4 and recs[0].shape == (64, 96)   # frame-major


def test_train_ncsn_outputs(trained):
    with open(os.path.join(trained, "out.log")) as f:
        log = f.read()
    assert "Total Trainable Variables: " in log and "Training time:" in log
    assert "Epoch 002" in log
    flat, step = load_flat(os.path.join(trained, "ckpts", "ckpt-8"))
    assert step == 8                       # 2 epochs x 4 batches of 2
    keys = set(flat)
    assert {"['step']", "['opt_state'][0].count",
            "['params']['begin_conv']['kernel']",
            "['ema_params']['begin_conv']['kernel']",
            "['opt_state'][0].mu['begin_conv']['kernel']",
            "['opt_state'][0].nu['begin_conv']['kernel']"} <= keys
    for epoch in (1, 2):
        s = np.load(os.path.join(trained, "generated_samples",
                                 f"generated_samples_{epoch}.npy"))
        assert s.shape == (3, 32, 96, 64, 1) and np.isfinite(s).all()


def test_trained_prior_separates_and_samples(trained, song_dir, tmp_path):
    out = str(tmp_path / "sep")
    run_basis_sep.main([trained, trained, "--output", out, "--song_dir",
                        song_dir, "--ema", "--n_mixed", "2", "--T", "1",
                        "--num_classes", "2", "--n_filters", "4",
                        "--device", "cpu"])
    res = np.load(os.path.join(out, "results.npz"))
    assert res["x1"].shape == (2, 96, 64) and np.isfinite(res["x1"]).all()
    gen = str(tmp_path / "gen")
    ncsn_generate_samples.main([trained, "--output", gen, "--ema",
                                "--n_samples", "3", "--return_arr",
                                *TINY])
    s = np.load(os.path.join(gen, "generated_samples.npy"))
    assert s.shape == (3, 3, 96, 64, 1) and np.isfinite(s).all()
    assert s.min() >= -100.0 and s.max() <= 20.0
    with open(os.path.join(gen, "out.log")) as f:
        assert "Restored EMA weights" in f.read()


def test_port_trained_prior_restores_in_jax(trained):
    sys.path.insert(0, REPO)
    from run_basis_sep import restore_ncsn_params as jrestore
    template = JRefineNet((96, 64, 1), 4, num_classes=2).init_params(
        jax.random.PRNGKey(0))
    flat, _ = load_flat(os.path.join(trained, "ckpts", "ckpt-8"))
    for ema in (False, True):
        p = jrestore(trained, template, ema=ema)
        key = "['res1_1']['conv1']['kernel']"
        sub = "['ema_params']" if ema else "['params']"
        np.testing.assert_array_equal(
            np.asarray(p["res1_1"]["conv1"]["kernel"]), flat[sub + key])


def test_jax_train_state_resumes_in_the_port(tmp_path, dataset):
    jp = JRefineNet((96, 64, 1), 4, num_classes=2).init_params(
        jax.random.PRNGKey(1))
    jstate = jinit_state(jp, jsetup_optimizer("adamax", 1e-3), ema=True)
    jstate = jax.tree_util.tree_map(
        lambda a: a + (5 if a.dtype == np.int32 else 0.125), jstate)
    CheckpointManager(str(tmp_path / "jax" / "ckpts")).save(jstate, 5)
    out = str(tmp_path / "resumed")
    train_ncsn.main(["--dataset", dataset, "--output", out, "--ema",
                     "--optimizer", "adamax", "--restore",
                     str(tmp_path / "jax"), "--n_epochs", "1",
                     "--sample_every", "5", "--batch_size", "2", *TINY])
    with open(os.path.join(out, "out.log")) as f:
        assert "at step 5" in f.read()
    flat, step = load_flat(os.path.join(out, "ckpts", "ckpt-9"))
    assert step == 9 and int(flat["['opt_state'][0].count"]) == 9


def test_train_ncsn_with_the_repo_config(tmp_path, dataset):
    """The YAML of configs/melspec_ncsnv1.yml, sizes cut, names neither
    seed nor sample_every: the flags keep them (the JAX script's
    wholesale replacement loses them)."""
    with open(os.path.join(REPO, "configs", "melspec_ncsnv1.yml")) as f:
        config = yaml.safe_load(f)
    assert "seed" not in config and "sample_every" not in config
    config.update(n_filters=4, num_classes=2, batch_size=2, n_epochs=1, T=1)
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(config))
    out = str(tmp_path / "cfg")
    train_ncsn.main(["--dataset", dataset, "--output", out, "--config",
                     str(path), "--device", "cpu", "--sample_every", "1"])
    flat, step = load_flat(os.path.join(out, "ckpts", "ckpt-4"))
    assert step == 4 and "['ema_params']['begin_conv']['kernel']" not in flat
    assert os.path.exists(os.path.join(out, "generated_samples",
                                       "generated_samples_1.npy"))


@pytest.mark.parametrize("cli,argv", [
    (wav_to_spec, ["a", "b"]),
    (train_ncsn, ["--dataset", "d", "--debug"]),
    (ncsn_generate_samples, ["r", "--debug"]),
    (train_glow, ["--dataset", "d", "--debug"]),
    (train_noisy_glow, ["r", "--dataset", "d", "--debug"]),
    (train_realnvp, ["--dataset", "mnist", "--debug"])])
def test_training_clis_cuda_without_gpu_raise(tmp_path, monkeypatch, cli,
                                              argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


def test_train_ncsn_multihost_one_process_over_gloo(tmp_path, dataset):
    """--multihost --num_processes 1 on the CPU: a gloo group of one rank
    (a file:// rendezvous) that trains exactly as the run without it,
    writes its checkpoint and leaves the group."""
    runs = {}
    for name, extra in (("plain", []), ("multihost", [
            "--multihost", "--coordinator_address",
            f"file://{tmp_path / 'rendezvous'}", "--num_processes", "1",
            "--process_id", "0"])):
        out = str(tmp_path / name)
        train_ncsn.main(["--dataset", dataset, "--output", out,
                         "--n_epochs", "1", "--sample_every", "5",
                         "--batch_size", "2", *TINY, *extra])
        runs[name], step = load_flat(os.path.join(out, "ckpts", "ckpt-4"))
        assert step == 4
    assert not torch.distributed.is_initialized()
    with open(tmp_path / "multihost" / "out.log") as f:
        assert "Multi-host initialised: process 0 of 1, backend gloo" \
            in f.read()
    assert set(runs["plain"]) == set(runs["multihost"])
    for k, v in runs["plain"].items():
        np.testing.assert_array_equal(runs["multihost"][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# Glow: train_glow -> train_noisy_glow -> run_basis_sep --model_type glow
# (the JAX chain of tests/test_cli_e2e.py::TestGlowPipeline, on the port)
# ---------------------------------------------------------------------------

GLOW_TINY = ["--L", "2", "--K", "1", "--n_filters", "4", "--batch_size",
             "2", "--learntop", "--device", "cpu"]
GLOW_SIGMAS = ["--sigma1", "1.0", "--sigmaL", "0.1", "--num_classes", "2"]


@pytest.fixture(scope="module")
def glow_chain(tmp_path_factory, dataset, song_dir):
    """The three Glow CLIs in a chain at tiny size; returns the output
    directories."""
    root = tmp_path_factory.mktemp("glow")
    glow, noisy, sep = (str(root / n) for n in ("glow", "noisy", "sep"))
    train_glow.main(["--dataset", dataset, "--output", glow, "--n_epochs",
                     "1", *GLOW_TINY])
    train_noisy_glow.main([glow, "--dataset", dataset, "--output", noisy,
                           "--n_epochs", "1", "--reinit_actnorm",
                           *GLOW_SIGMAS, *GLOW_TINY])
    run_basis_sep.main([noisy, noisy, "--output", sep, "--song_dir",
                        song_dir, "--model_type", "glow", "--n_mixed", "2",
                        "--T", "2", "--winograd", "--score_chunk", "1",
                        *GLOW_SIGMAS, *GLOW_TINY])
    return glow, noisy, sep


def test_glow_cli_chain_outputs(glow_chain):
    glow, noisy, sep = glow_chain
    with open(os.path.join(glow, "out.log")) as f:
        log = f.read()
    for line in ("Total Trainable Variables: ", "Epoch 001", "Training time",
                 "Validation bits/dim: ", "Validation bits/px ([0,1]"):
        assert line in log, line
    _, step = load_flat(os.path.join(glow, "ckpts", "ckpt-4"))
    assert step == 4                              # 8 windows in batches of 2
    s = np.load(os.path.join(glow, "generated_samples",
                             "generated_samples_1.npy"))
    assert s.shape == (32, 96, 64, 1) and np.isfinite(s).all()
    assert s.min() >= -100.0 and s.max() <= 20.0
    for sig, step in (("sigma_1.0", 8), ("sigma_0.1", 12)):
        assert latest_step(os.path.join(noisy, sig, "ckpts")) == step, sig
    with open(os.path.join(noisy, "out.log")) as f:
        assert f.read().count("Re-anchored ActNorm stats") == 2
    res = np.load(os.path.join(sep, "results.npz"))
    assert sorted(res.files) == ["gt1", "gt2", "mixed", "stft_mixture",
                                 "x1", "x2"]
    for key in ("x1", "x2", "mixed"):
        assert res[key].shape == (2, 96, 64) and np.isfinite(res[key]).all()
        assert res[key].min() >= -100.0 and res[key].max() <= 20.0
    # data scale: the mixture is kept in dB, not rescaled to [0, 1]
    assert res["mixed"].min() < -1.0
    conv = np.load(os.path.join(sep, "results_convergence.npz"))
    assert conv["x1"].shape[:2] == (3, 2)            # init + 2 levels
    with open(os.path.join(sep, "out.log")) as f:
        log = f.read()
    assert log.count("Model at noise level") == 4 and "Duration:" in log


def latest_step(ckpt_dir):
    from audiosourcesep_tpu_torch.training import CheckpointManager as M
    return load_flat(M(ckpt_dir).latest())[1]


def test_port_glow_checkpoints_restore_strictly_in_jax(glow_chain, dataset):
    """The JAX package restores the port's Glow train states (train_glow's
    and each noise level's) strictly into its own template, and its
    run_basis_sep restore reads each level's params."""
    from audiosourcesep_tpu.training import init_train_state as jinit
    from audiosourcesep_tpu.training import restore_pytree as jrestore
    sys.path.insert(0, REPO)
    from run_basis_sep import restore_ncsn_params as jrestore_params
    glow, noisy, _ = glow_chain
    mb = jax.numpy.zeros((2, 96, 64, 1)) - 50.0
    _, jp = jbuild_glow(jax.random.PRNGKey(0), mb, (96, 64, 1), L=2, K=1,
                        n_filters=4, learntop=True, data_type="melspec")
    template = jinit(jp, jsetup_optimizer("adamax", 1e-3))
    flat, _ = load_flat(os.path.join(glow, "ckpts", "ckpt-4"))
    state, step = jrestore(os.path.join(glow, "ckpts", "ckpt-4"), template,
                           strict=True)
    assert step == 4
    key = "['prior']['loc']"
    np.testing.assert_array_equal(np.asarray(state["params"]["prior"]["loc"]),
                                  flat["['params']" + key])
    for sig in ("sigma_1.0", "sigma_0.1"):
        p = jrestore_params(os.path.join(noisy, sig, "ckpts"), jp)
        assert np.isfinite(np.asarray(p["prior"]["log_scale"])).all()
