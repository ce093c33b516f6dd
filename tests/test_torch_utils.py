"""The port's utils (audiosourcesep_tpu_torch.utils) and the NCSNv2
technique CLIs against the JAX package: technique 1's blocked Gram
distance, techniques 2 and 4, the trainable-variable counts and
summaries of NCSN v1 and Glow, and the profiling helpers."""

import contextlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu import utils as jutils
from audiosourcesep_tpu.data import save_tf_records
from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild_glow
from audiosourcesep_tpu.models.ncsn import RefineNetDilated as JRefineNet
from audiosourcesep_tpu_torch import technique1_ncsnv2, technique2and4_ncsnv2
from audiosourcesep_tpu_torch import nn as tnn
from audiosourcesep_tpu_torch import utils
from audiosourcesep_tpu_torch.models import build_glow
from audiosourcesep_tpu_torch.models.ncsn import RefineNetDilated
from audiosourcesep_tpu_torch.separation import graphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spectrograms(n=300, seed=0):
    return np.random.default_rng(seed).uniform(
        -100.0, 20.0, (n, 16, 12, 1)).astype(np.float32)


# f32 Gram products summed in other orders, then a square root: 1e-6
# relative to JAX's; both to 1e-5 of the float64 pairwise maximum
def test_max_pairwise_distance_matches_jax_and_float64():
    X = _spectrograms() / 120.0
    want = jutils.max_pairwise_distance(X, block=128)
    got = utils.max_pairwise_distance(X, block=128, device="cpu")
    flat = X.reshape(len(X), -1).astype(np.float64)
    exact = np.sqrt(max(((a - flat) ** 2).sum(1).max() for a in flat))
    assert abs(got - want) <= 1e-6 * want
    assert abs(got - exact) <= 1e-5 * exact
    # blocks that do not divide the rows
    assert abs(utils.max_pairwise_distance(X, block=77, device="cpu")
               - got) <= 1e-6 * got


def test_technique1_sigma1_matches_jax():
    X = _spectrograms(seed=1)
    for max_samples in (2000, 100):
        want = jutils.technique1_sigma1(X, max_samples=max_samples)
        got = utils.technique1_sigma1(X, max_samples=max_samples,
                                      device="cpu")
        assert abs(got - want) <= 1e-6 * want


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA")
def test_technique1_defaults_to_the_card_and_raises_without_one():
    """The JAX functions run on the default accelerator; these default to
    ``cuda`` and do not fall back to the CPU."""
    X = _spectrograms(n=4)
    for fn in (utils.max_pairwise_distance, utils.technique1_sigma1):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(X)


@pytest.mark.parametrize("D,sigma1,sigmaL,T", [(96 * 64, 55.0, 0.01, 5.0),
                                               (32 * 32 * 3, 50.0, 0.01, 3.0)])
def test_techniques_2_and_4_match_jax(D, sigma1, sigmaL, T):
    want = jutils.technique2_gamma(D, sigma1, sigmaL, verbose=False)
    got = utils.technique2_gamma(D, sigma1, sigmaL, verbose=False)
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-6 * abs(w)
    eps = utils.technique4_epsilon(T, sigmaL, got[0], verbose=False)
    want_eps = jutils.technique4_epsilon(T, sigmaL, want[0], verbose=False)
    assert eps > 0 and abs(eps - want_eps) <= 1e-6 * want_eps


def _stdout(fn, *a):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


def test_technique_clis_match_the_jax_scripts(tmp_path):
    """technique1 writes the JAX script's max_norm.txt and prints its
    lines (the distance to 1e-6 relative); technique2and4 prints exactly
    what the JAX script prints."""
    sys.path.insert(0, REPO)
    import argparse

    import technique1_ncsnv2 as jt1
    import technique2and4_ncsnv2 as jt24
    for split, n in (("train", 40), ("test", 4)):
        (tmp_path / split).mkdir()
        save_tf_records(list(_spectrograms(n, seed=2)[..., 0]),
                        str(tmp_path / split / "piano.tfrecord"))
    want_log = _stdout(jt1.main, argparse.Namespace(dataset=str(tmp_path)))
    want = (tmp_path / "max_norm.txt").read_text()
    got_log = _stdout(technique1_ncsnv2.main, [str(tmp_path), "--device",
                                               "cpu"])
    got = (tmp_path / "max_norm.txt").read_text()

    def value(text):
        return float(text.rsplit(" ", 1)[-1])

    assert got.rsplit("= ", 1)[0] == want.rsplit("= ", 1)[0]
    assert abs(value(got) - value(want)) <= 1e-6 * value(want)
    assert got_log.splitlines()[:2] == want_log.splitlines()[:2]
    argv = ["--D", "32,32,3", "--T", "3", "--sigma1", "50"]
    parser = argparse.ArgumentParser()
    for flag, default in (("--D", "96,64,1"), ("--T", 5.0),
                          ("--sigma1", 55.0), ("--sigmaL", 0.01)):
        parser.add_argument(flag, type=type(default), default=default)
    assert _stdout(technique2and4_ncsnv2.main, argv) == _stdout(
        jt24.main, parser.parse_args(argv))


def _models(kind):
    if kind == "ncsn_v1":
        jp = JRefineNet((96, 64, 1), 8, num_classes=4).init_params(
            jax.random.PRNGKey(0))
        return jp, RefineNetDilated((96, 64, 1), 8, num_classes=4)
    mb = jnp.asarray(np.random.default_rng(0).uniform(
        -100.0, 20.0, (4, 16, 16, 1)), jnp.float32)
    _, jp = jbuild_glow(jax.random.PRNGKey(0), mb, (16, 16, 1), L=2, K=2,
                        n_filters=8, learntop=True, data_type="melspec")
    return jp, build_glow((16, 16, 1), L=2, K=2, n_filters=8, learntop=True,
                          data_type="melspec")


@pytest.mark.parametrize("kind", ["ncsn_v1", "glow"])
def test_trainable_variables_and_summary_match_jax(kind):
    jp, model = _models(kind)
    n = jutils.total_trainable_variables(jp)
    assert utils.total_trainable_variables(model) == n > 0
    # a JAX-layout params tree counts as in the JAX package
    from audiosourcesep_tpu_torch.training.checkpoint import params_to_jax
    assert utils.total_trainable_variables(
        params_to_jax(dict(model.named_parameters()))) == n
    for depth in (2, 4):
        want = _stdout(jutils.print_summary, jp, depth).splitlines()
        got = _stdout(utils.print_summary, model, depth).splitlines()
        # the same subtrees and counts, in the JAX tree's key order or not
        assert got[0] == want[0] and got[-1] == want[-1]
        assert sorted(got) == sorted(want)


def test_trace_noop_and_trace_with_annotations(tmp_path):
    """No log dir: nothing. With one: a trace file, and an anneal level
    that starts inside records its module spans (the port's
    annotations)."""
    with utils.trace(None) as prof:
        x = torch.ones(3) + 1
    assert prof is None and float(x[0]) == 2.0

    def make_step(level):
        def step(x, noise):
            x.add_(tnn.elu(x) * 0.0 + noise)
        return step

    with utils.trace(str(tmp_path)) as prof, graphs.recording() as record:
        y = graphs.anneal(make_step, torch.zeros(8), 1, 2, False,
                          torch.Generator().manual_seed(0))
    assert prof is not None and torch.isfinite(y).all()
    assert [s.name for s in record.spans] == [
        "anneal.steps", "anneal.turnover", "anneal.noise", "act",
        "anneal.release"]
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))
