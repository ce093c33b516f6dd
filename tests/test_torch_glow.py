"""The port's Glow (audiosourcesep_tpu_torch.models.build_glow) against
audiosourcesep_tpu.models.build_glow on the CPU, float32: L=2, K=2, 8
filters on [16, 16, 1] dB patches, both priors, with the JAX package's
params carried across. log p, the score, a sample from a given latent
and bits/dim agree, also with the Winograd routing on (its plain version
on the CPU); the port's own init is held to its properties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.models.flow_builder import build_glow as jbuild
from audiosourcesep_tpu_torch import nn
from audiosourcesep_tpu_torch.bijectors import ActNorm
from audiosourcesep_tpu_torch.models import build_glow
from audiosourcesep_tpu_torch.training.checkpoint import (_flatten,
                                                          params_from_jax,
                                                          params_to_jax)

torch.set_num_threads(2)
SHAPE = (16, 16, 1)
CFG = dict(L=2, K=2, n_filters=8, data_type="melspec", use_logit=False,
           minval=-100.0, maxval=20.0)
# through the whole flow (2 x 2 steps, f32): log p (|log p| ~ 5e3) to
# 1e-5 relative, the score and samples to 1e-4 of their largest element
RTOL_LP, TOL = 1e-5, 1e-4


def _db(seed, n):
    return np.random.default_rng(seed).uniform(
        -95.0, 15.0, (n, *SHAPE)).astype(np.float32)


def _perturb(jp, scale=0.05):
    """The JAX params with every coupling's last conv (zero at init) set
    to small random values, so the couplings do work."""
    def f(path, a):
        if "conv3" not in jax.tree_util.keystr(path):
            return a
        return a + scale * jnp.asarray(
            np.random.default_rng(a.size).standard_normal(a.shape),
            jnp.float32)
    return jax.tree_util.tree_map_with_path(f, jp)


@pytest.fixture(scope="module", params=[True, False],
                ids=["learntop", "isotropic"])
def pair(request):
    """(JAX model, JAX params, port model with those params)."""
    jm, jp = jbuild(jax.random.PRNGKey(0), jnp.asarray(_db(0, 8)), SHAPE,
                    learntop=request.param, **CFG)
    jp = _perturb(jp)
    tm = build_glow(SHAPE, learntop=request.param, **CFG)
    tm.load_state_dict(params_from_jax(_flatten(jp)))
    return jm, jp, tm


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_parameter_names_are_the_jax_key_paths(pair):
    jm, jp, tm = pair
    got = _flatten(params_to_jax(dict(tm.named_parameters())))
    want = _flatten(jp)
    assert set(got) == set(want)
    assert ("['bijector']['glow_multiscale_1']['block1']['glow_step_1']"
            "['coupling_split_2']['net']['conv1']['kernel']") in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("routed", [False, True])
def test_log_prob_score_and_bits_match_jax(pair, routed):
    jm, jp, tm = pair
    x = _db(1, 3)
    want_lp = np.asarray(jm.log_prob(jp, jnp.asarray(x)))
    want_score = np.asarray(jm.score(jp, jnp.asarray(x)))
    want_bpd = np.asarray(jm.bits_per_dim(jp, jnp.asarray(x)))
    try:
        nn.set_winograd(routed)
        lp = tm.log_prob(torch.from_numpy(x)).detach().numpy()
        score = tm.score(torch.from_numpy(x)).numpy()
        bpd = tm.bits_per_dim(torch.from_numpy(x)).detach().numpy()
    finally:
        nn.set_winograd(False)
    np.testing.assert_allclose(lp, want_lp, rtol=RTOL_LP)
    np.testing.assert_allclose(bpd, want_bpd, rtol=RTOL_LP)
    assert _max_rel(score, want_score) < TOL
    assert np.abs(want_score).max() > 1e-2          # a score that moves


def test_sample_from_a_given_latent_matches_jax(pair):
    jm, jp, tm = pair
    z = np.array(jax.random.normal(jax.random.PRNGKey(2), (3, 4, 4, 16)))
    want = np.asarray(jm.bijector.inverse(jp["bijector"], jnp.asarray(z))[0])
    got = tm.sample(torch.from_numpy(z)).detach().numpy()
    assert got.shape == (3, *SHAPE)
    assert _max_rel(got, want) < TOL
    # and back: the latent of the sample is z
    z_back, _ = tm.bijector(torch.from_numpy(got))
    np.testing.assert_allclose(z_back.detach().numpy(), z, atol=1e-3)


def test_reinit_reanchors_actnorm_only_as_jax_does(pair):
    jm, jp, tm = pair
    x = _db(3, 8) * 0.5 + 10.0
    jp2 = jm.reinit_data_dependent(jp, jnp.asarray(x))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    tm.reinit_data_dependent(torch.from_numpy(x))
    got = _flatten(params_to_jax(dict(tm.named_parameters())))
    for k, v in _flatten(jp2).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for n, p in tm.named_parameters():
        if "actnorm" not in n:
            assert torch.equal(p, before[n]), n
    tm.load_state_dict(params_from_jax(_flatten(jp)))        # restore


@torch.no_grad()
def test_port_init_properties():
    """build_glow with a minibatch: the first ActNorm normalises it, each
    coupling starts as the identity (zero last conv), the prior starts at
    N(0, 1), and the flow is invertible with finite log p."""
    mb = torch.from_numpy(_db(4, 8))
    for learntop in (True, False):
        m = build_glow(SHAPE, learntop=learntop, minibatch=mb,
                       generator=torch.Generator().manual_seed(0), **CFG)
        prep, glow = m.bijector.bijectors
        squeeze, step1 = glow.block1.bijectors[:2]
        assert isinstance(step1.actnorm_0, ActNorm)
        an = step1.actnorm_0(squeeze(prep(mb)[0])[0])[0]
        assert float(an.mean(dim=(0, 1, 2)).abs().max()) < 1e-4
        assert all(float(c.net.conv3.kernel.abs().max()) == 0
                   for c in m.modules() if hasattr(c, "net"))
        if learntop:
            assert float(m.prior.loc.abs().max()) == 0
        assert torch.isfinite(m.log_prob(mb)).all()
        z, _ = m.bijector(mb)
        torch.testing.assert_close(m.sample(z), mb, atol=1e-3, rtol=0)
