"""The port's image path on the CPU: ``data.load_toydata`` and
``get_mixture_toydata`` against the JAX package's (same batches in the
same order, the same mixture from the same dequantisation draws),
``cli.resolve_dataset`` on ``mnist`` / ``cifar10``, and every CLI that
runs on them at tiny width: ``train_ncsn`` -> ``ncsn_generate_samples``
and ``run_basis_sep --winograd`` on MNIST, ``train_glow`` ->
``train_noisy_glow`` -> ``run_basis_sep --model_type glow`` on CIFAR-10.
The JAX package restores the CLIs' checkpoints strictly.

The MNIST file is ``scripts/build_mnist_cache.py --synthetic-digits``:
sklearn's digits upsampled, a stand-in that is not MNIST. The CIFAR-10
file is ``scripts/build_cifar10_cache.py`` on random batches in the
standard pickle format."""

import argparse
import importlib.util
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu import cli as jcli
from audiosourcesep_tpu.data import get_mixture_toydata as jmixture
from audiosourcesep_tpu.data import load_toydata as jload
from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild_glow
from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu.training import CheckpointManager as JManager
from audiosourcesep_tpu.training import init_train_state as jinit_state
from audiosourcesep_tpu.training import setup_optimizer as jsetup_optimizer
from audiosourcesep_tpu_torch import (cli, ncsn_generate_samples,
                                      run_basis_sep, train_glow, train_ncsn,
                                      train_noisy_glow)
from audiosourcesep_tpu_torch.data import get_mixture_toydata, load_toydata
from audiosourcesep_tpu_torch.ops import counting

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mnist_npz(tmp_path_factory):
    """The digits stand-in, written by the cache script's own function."""
    spec = importlib.util.spec_from_file_location(
        "build_mnist_cache", os.path.join(REPO, "scripts",
                                          "build_mnist_cache.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = str(tmp_path_factory.mktemp("mnist") / "mnist.npz")
    np.savez_compressed(path, **mod.from_sklearn_digits(0))
    return path


@pytest.fixture(scope="module")
def cifar_npz(tmp_path_factory):
    """``scripts/build_cifar10_cache.py`` on random standard-format
    batches: 5 x 12 training images, 8 test images."""
    root = tmp_path_factory.mktemp("cifar")
    batches = root / "cifar-10-batches-py"
    batches.mkdir()
    rng = np.random.RandomState(0)
    for name, n in [(f"data_batch_{i}", 12) for i in range(1, 6)] + [
            ("test_batch", 8)]:
        with open(batches / name, "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (n, 3072)).astype(
                np.uint8), b"labels": list(rng.randint(0, 10, n))}, f)
    path = str(root / "cifar10.npz")
    r = subprocess.run([sys.executable, os.path.join(
        REPO, "scripts", "build_cifar10_cache.py"), str(batches), "--out",
        path], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return path


@pytest.fixture()
def caches(monkeypatch, mnist_npz, cifar_npz):
    monkeypatch.setenv("ASR_MNIST_NPZ", mnist_npz)
    monkeypatch.setenv("ASR_CIFAR10_NPZ", cifar_npz)


# ---------------------------------------------------------------------------
# loaders and resolve_dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_load_toydata_matches_jax(caches, dataset, capsys):
    """The same batches in the same order over two epochs, the same eval
    batch and minibatch."""
    got = load_toydata(dataset, 16, seed=3)
    want = jload(dataset, 16, seed=3)
    for g, w in zip(got[:2], want[:2]):
        assert (len(g), g.n_examples, g.batch_size) == \
            (len(w), w.n_examples, w.batch_size)
        for _ in range(2):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    shape = (16, 32, 32, 1 if dataset == "mnist" else 3)
    assert got[2].shape == shape and got[2].dtype == np.float32
    if dataset == "mnist":
        # the stand-in names itself in the output
        assert "NOT-MNIST" in capsys.readouterr().out


def test_get_mixture_toydata_matches_jax(caches):
    """With the JAX package's two dequantisation draws passed in, the
    same sources and mixture; without, draws from a generator."""
    jm, jg1, jg2, jmb = jmixture("mnist", n_mixed=4, seed=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(2))
    draws = [np.asarray(jax.random.uniform(k, jg1.shape)) for k in (k1, k2)]
    m, g1, g2, mb = get_mixture_toydata("mnist", 4, 2, dequant=draws)
    for a, b in ((m, jm), (g1, jg1), (g2, jg2), (mb, jmb)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    m2, g1b, _, _ = get_mixture_toydata(
        "cifar10", 3, generator=torch.Generator().manual_seed(0))
    assert m2.shape == (3, 32, 32, 3)
    frac = g1b - np.floor(g1b)
    assert (g1b >= 0).all() and (g1b < 256).all() and frac.any()


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_resolve_dataset_image_branch_matches_jax(caches, dataset):
    args = argparse.Namespace(dataset=dataset, batch_size=8)
    got, want = cli.resolve_dataset(args), jcli.resolve_dataset(args)
    for key in ("n_train", "n_test", "data_shape", "data_type", "minval",
                "maxval"):
        assert got[key] == want[key], key
    assert got["data_type"] == "image" and got["maxval"] == 256.0
    np.testing.assert_array_equal(got["minibatch"],
                                  np.asarray(want["minibatch"]))


def test_load_toydata_without_a_cache_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("ASR_CIFAR10_NPZ", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="build_cifar10_cache"):
        load_toydata("cifar10")
    with pytest.raises(ValueError, match="mnist or cifar10"):
        load_toydata("svhn")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

NCSN_TINY = ["--n_filters", "4", "--num_classes", "2", "--T", "1",
             "--device", "cpu"]


@pytest.fixture(scope="module")
def image_ncsn(tmp_path_factory, mnist_npz):
    """``train_ncsn --dataset mnist`` for one epoch at tiny width."""
    out = str(tmp_path_factory.mktemp("ncsn") / "ncsn")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ASR_MNIST_NPZ", mnist_npz)
        train_ncsn.main(["--dataset", "mnist", "--output", out,
                         "--batch_size", "64", "--n_epochs", "1", "--ema",
                         "--sample_every", "1", *NCSN_TINY])
    return out


def test_train_ncsn_on_mnist(image_ncsn, mnist_npz):
    """The JAX CLI's outputs: a train state the JAX package restores
    strictly (EMA included) and a 32 x 32 Langevin snapshot."""
    ckpts = os.path.join(image_ncsn, "ckpts")
    net = JRefineNet((32, 32, 1), 4, num_classes=2)
    template = jax.eval_shape(lambda: jinit_state(
        net.init_params(jax.random.PRNGKey(0)),
        jsetup_optimizer("adam", 1e-3), ema=True))
    _, step = JManager(ckpts).restore_latest(template)
    assert step == len(np.load(mnist_npz)["x_train"]) // 64
    snap = np.load(os.path.join(image_ncsn, "generated_samples",
                                "generated_samples_1.npy"))
    assert snap.shape == (3, 32, 32, 32, 1) and np.isfinite(snap).all()
    with open(os.path.join(image_ncsn, "out.log")) as f:
        assert "NOT-MNIST" in f.read()


@pytest.mark.parametrize("dataset,channels", [("mnist", 1), ("cifar10", 3)])
def test_ncsn_generate_samples_image_shapes(tmp_path, image_ncsn, dataset,
                                            channels):
    """32 x 32 x 1 for MNIST; a CIFAR-10 prior of 3 channels is refused
    by the strict restore of the MNIST checkpoint."""
    out = str(tmp_path / "gen")
    argv = [image_ncsn, "--dataset", dataset, "--output", out, "--ema",
            "--n_samples", "3", *NCSN_TINY]
    if channels == 3:
        with pytest.raises(ValueError, match="shape mismatch"):
            ncsn_generate_samples.main(argv)
        return
    ncsn_generate_samples.main(argv)
    g = np.load(os.path.join(out, "generated_samples.npy"))
    assert g.shape == (3, 32, 32, 1) and np.isfinite(g).all()


@pytest.mark.parametrize("routed", [False, True])
def test_run_basis_sep_on_mnist(tmp_path, caches, image_ncsn, routed):
    """The image branch: results.npz with the JAX keys, sources rounded
    to integers in [0, 255], the ground truths the dequantised images,
    stft_mixture None; with --winograd the convs take the kernel's plain
    version (no launch on the CPU)."""
    out = str(tmp_path / "sep")
    before = counting.snapshot()
    run_basis_sep.main([image_ncsn, image_ncsn, "--dataset", "mnist",
                        "--output", out, "--n_mixed", "3", "--T", "2",
                        "--ema", *NCSN_TINY[:4], "--device", "cpu"]
                       + (["--winograd"] if routed else []))
    assert counting.snapshot() == before
    res = np.load(os.path.join(out, "results.npz"), allow_pickle=True)
    assert sorted(res.files) == ["gt1", "gt2", "mixed", "stft_mixture",
                                 "x1", "x2"]
    for key in ("x1", "x2", "mixed"):
        a = res[key]
        assert a.shape == (3, 32, 32) and a.min() >= 0 and a.max() <= 255
        np.testing.assert_array_equal(a, np.round(a))
    _, g1, g2, _ = get_mixture_toydata(
        "mnist", 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(res["gt1"], g1[..., 0])
    np.testing.assert_array_equal(res["gt2"], g2[..., 0])
    assert res["stft_mixture"].item() is None
    conv = np.load(os.path.join(out, "results_convergence.npz"))
    assert conv["x1"].shape == (3, 3, 32, 32, 1)      # levels + 1
    assert not any(f.endswith(".wav") for f in os.listdir(out))


GLOW_TINY = ["--L", "2", "--K", "1", "--n_filters", "4", "--batch_size",
             "20", "--learntop", "--device", "cpu"]
# the sigmas and step of the [0, 256) data scale (span 256)
GLOW_SIGMAS = ["--sigma1", "256.0", "--sigmaL", "2.56", "--num_classes",
               "2", "--progression", "logarithmic"]


def test_glow_chain_on_cifar10(tmp_path, caches):
    """train_glow -> train_noisy_glow -> run_basis_sep --model_type glow
    on CIFAR-10: bits/dim, the sigma_*/ckpts layout (strictly restored by
    the JAX package), and results of 32 x 32 x 3 images."""
    glow, noisy, sep = (str(tmp_path / n) for n in ("glow", "noisy", "sep"))
    train_glow.main(["--dataset", "cifar10", "--output", glow, "--n_epochs",
                     "1", *GLOW_TINY])
    with open(os.path.join(glow, "out.log")) as f:
        bpd = float(f.read().split("Validation bits/dim:")[1].split()[0])
    assert np.isfinite(bpd)
    train_noisy_glow.main([glow, "--dataset", "cifar10", "--output", noisy,
                           "--n_epochs", "1", *GLOW_TINY, *GLOW_SIGMAS])
    assert sorted(os.listdir(noisy)) == ["out.log", "sigma_2.56",
                                         "sigma_256.0"]
    template = jax.eval_shape(lambda x: jinit_state(jbuild_glow(
        jax.random.PRNGKey(0), x, (32, 32, 3), L=2, K=1, n_filters=4,
        learntop=True, data_type="image")[1],
        jsetup_optimizer("adamax", 1e-3)), jnp.zeros((2, 32, 32, 3)))
    _, step = JManager(os.path.join(noisy, "sigma_2.56", "ckpts")
                       ).restore_latest(template)
    # 3 steps an epoch: train_glow's, then each level's counted on
    assert step == 3 * (60 // 20)
    run_basis_sep.main([noisy, noisy, "--dataset", "cifar10",
                        "--model_type", "glow", "--output", sep, "--L", "2",
                        "--K", "1", "--n_filters", "4", "--learntop",
                        "--T", "2", "--n_mixed", "2", "--step_lr",
                        str(2e-5 * 256.0 ** 2), *GLOW_SIGMAS,
                        "--device", "cpu"])
    res = np.load(os.path.join(sep, "results.npz"), allow_pickle=True)
    for key in ("x1", "x2"):
        assert res[key].shape == (2, 32, 32, 3)
        assert res[key].min() >= 0 and res[key].max() <= 255
        np.testing.assert_array_equal(res[key], np.round(res[key]))
