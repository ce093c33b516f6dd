"""BSS-Eval v4 and the oracles of the port (audiosourcesep_tpu_torch.
evaluation) against audiosourcesep_tpu.evaluation on the same signals.
Both are the same float64 numpy and scipy code, so they agree to 1e-10."""

import numpy as np
import pytest

from audiosourcesep_tpu import evaluation as jeval
from audiosourcesep_tpu_torch import evaluation as teval

TOL = dict(rtol=1e-10, atol=1e-10)


def make_signals(seed=0, nsrc=2, n=3000, nchan=1):
    """The signal maker of tests/test_evaluation.py: filtered mixtures of
    the references plus noise (non-trivial SIR/SAR)."""
    rng = np.random.RandomState(seed)
    refs = rng.randn(nsrc, n, nchan)
    ests = np.zeros_like(refs)
    for j in range(nsrc):
        for i in range(nsrc):
            h = rng.randn(16) * (0.8 if i == j else 0.2)
            for c in range(nchan):
                ests[j, :, c] += np.convolve(refs[i, :, c], h, "same")
        ests[j] += 0.05 * rng.randn(n, nchan)
    return refs, ests


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("case,signals,kw", [
    ("images", dict(seed=3), dict(window=np.inf, hop=np.inf,
                                  compute_permutation=False,
                                  filters_len=64)),
    ("framewise_permutation", dict(seed=4, swap=True),
     dict(window=1000, hop=500, compute_permutation=True, filters_len=32,
          framewise_filters=True)),
    ("sources", dict(seed=5), dict(window=np.inf, hop=np.inf,
                                   filters_len=32,
                                   bsseval_sources_version=True)),
    ("stereo", dict(seed=6, nchan=2, n=2000),
     dict(window=np.inf, hop=np.inf, filters_len=16)),
])
def test_bss_eval_matches_jax(case, signals, kw):
    swap = signals.pop("swap", False)
    refs, ests = make_signals(**signals)
    if swap:    # the permutation search must recover the order
        ests = ests[::-1]
    got = teval.bss_eval(refs, ests, **kw)
    _assert_same(got, jeval.bss_eval(refs, ests, **kw))
    assert np.isfinite(got[0]).all()
    if swap:
        assert (got[4] == np.array([[1], [0]])).all()


@pytest.mark.parametrize("name", ["bss_eval_sources", "bss_eval_images",
                                  "bss_eval_sources_framewise",
                                  "bss_eval_images_framewise"])
def test_bss_eval_wrappers_match_jax(name):
    refs, ests = make_signals(seed=7, n=1500)
    kw = dict(window=1000, hop=500) if name.endswith("framewise") else {}
    _assert_same(getattr(teval, name)(refs, ests, **kw),
                 getattr(jeval, name)(refs, ests, **kw))


def test_validate_rejects_what_jax_rejects():
    refs, ests = make_signals(seed=8)
    for bad in (ests[:, :10], np.zeros_like(ests)):
        with pytest.raises(ValueError):
            jeval.validate(refs, bad)
        with pytest.raises(ValueError):
            teval.validate(refs, bad)


@pytest.mark.parametrize("name,shape", [("IBM", (2, 8000, 1)),
                                        ("IRM", (2, 8000, 1)),
                                        ("MWF", (2, 8000, 2)),
                                        ("IBM_melspec", (2, 5, 96, 64)),
                                        ("IRM_melspec", (2, 5, 96, 64))])
def test_oracles_match_jax(name, shape):
    rng = np.random.RandomState(9)
    sources = rng.randn(*shape)
    if name.endswith("melspec"):
        sources = np.abs(sources)
    mixture = sources.sum(axis=0)
    got = getattr(teval, name)(mixture, sources)
    assert got.shape == sources.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, getattr(jeval, name)(mixture, sources),
                               **TOL)
