"""The port's bijectors (audiosourcesep_tpu_torch.bijectors) against
audiosourcesep_tpu.bijectors on the CPU, float32: each bijector's
forward, inverse, log-dets and reinit with the JAX package's params
carried across (params_from_jax), the port's own inits by their
properties, and the JAX package's Invertible1x1Conv defect (P and sign_s
are trained) reproduced in both packages."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audiosourcesep_tpu import bijectors as jb
from audiosourcesep_tpu_torch import bijectors as tb
from audiosourcesep_tpu_torch.training import setup_optimizer
from audiosourcesep_tpu_torch.training.checkpoint import (_flatten,
                                                          params_from_jax,
                                                          params_to_jax)

torch.set_num_threads(2)
LOG2 = math.log(2.0)
# f32 through one bijector: the two packages sum in other orders
RTOL, ATOL = 1e-5, 1e-5


def _x(seed, shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            + shift).astype(np.float32)


def _load(module, jparams):
    """``module`` with the JAX params pytree ``jparams`` loaded strictly."""
    module.load_state_dict(params_from_jax(_flatten(jparams)))
    return module


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _check(jbij, jp, tbij, x, rtol=RTOL, atol=ATOL):
    """Forward and inverse (outputs and forward log-dets) of the port's
    bijector against the JAX one on ``x``, and the port's round trip."""
    jy, jf = jbij.forward(jp, jnp.asarray(x))
    ty, tf = tbij(torch.from_numpy(x))
    _close(ty, jy, rtol, atol)
    _close(tf, jf, rtol, atol)
    jx, jfi = jbij.inverse(jp, jy)
    tx, tfi = tbij.inverse(ty)
    _close(tx, jx, rtol, atol)
    _close(tfi, jfi, rtol, atol)
    np.testing.assert_allclose(tx.detach().numpy(), x, rtol=1e-4,
                               atol=1e-4)
    _close(tfi, tf.detach(), 1e-5, 1e-4)


@pytest.mark.parametrize("normalize,shape", [("channel", 3),
                                             ("all", (4, 4, 3))])
def test_actnorm_matches_jax_and_reinit(normalize, shape):
    x = _x(0, (8, 4, 4, 3), 2.0, 3.0)
    jbij = jb.ActNorm(normalize=normalize)
    jp = jbij.init_params(None, jnp.asarray(x))
    tbij = tb.ActNorm(shape, normalize=normalize)
    # the port's data-dependent init gives the JAX package's params
    # (std with ddof 0, as jnp.std)
    y = tbij.init(torch.from_numpy(x))
    _close(tbij.log_scale, jp["log_scale"])
    _close(tbij.shift, jp["shift"])
    dims = (0, 1, 2) if normalize == "channel" else (0,)
    assert float(y.mean(dim=dims).abs().max()) < 1e-5
    assert float((y.std(dim=dims, correction=0) - 1).abs().max()) < 1e-4
    _check(jbij, jp, tbij, _x(1, (5, 4, 4, 3)))
    # reinit on a shifted batch re-anchors the stats, as JAX's reinit
    x2 = x * 50.0 + 20.0
    jp2, jy2 = jbij.reinit(jp, jnp.asarray(x2))
    _close(tbij.reinit(torch.from_numpy(x2)), jy2, atol=1e-4)
    _close(tbij.log_scale, jp2["log_scale"])
    _close(tbij.shift, jp2["shift"])


def test_actnorm_crafted_minibatch_logdet():
    """Per-channel std 2 and mean 0: log_scale = -log 2, log-det
    -H*W*C*log 2."""
    x = (2.0 * np.array([1.0, -1.0] * 8, np.float32)).reshape(8, 2, 1, 1)
    bij = tb.ActNorm(1, eps=0.0)
    bij.init(torch.from_numpy(x))
    _, fldj = bij(torch.from_numpy(x))
    np.testing.assert_allclose(fldj.detach().numpy(), -2 * LOG2, rtol=1e-6)


def test_invertible_1x1_conv_matches_jax():
    x = _x(2, (3, 4, 4, 6))
    jbij = jb.Invertible1x1Conv()
    jp = jbij.init_params(jax.random.PRNGKey(5), jnp.asarray(x))
    tbij = _load(tb.Invertible1x1Conv(6), jp)
    _check(jbij, jp, tbij, x)


def test_invertible_1x1_conv_init_properties():
    """torch's draws are not threefry's: the port's init is held to what
    the JAX init guarantees. W = P L U is orthogonal (the Q of a QR), P a
    permutation, L unit lower and U upper triangular, sign_s = +-1, and
    the log-det is H*W*log|det W|."""
    C = 6
    bij = tb.Invertible1x1Conv(C)
    x = torch.from_numpy(_x(3, (2, 3, 3, C)))
    bij.init(x, torch.Generator().manual_seed(0))
    P = bij.P.detach()
    assert torch.equal(P.sum(0), torch.ones(C)) and torch.equal(
        P.sum(1), torch.ones(C)) and torch.equal(P, P.round())
    assert torch.equal(bij.sign_s.detach().abs(), torch.ones(C))
    L, U, eye = bij._assemble()
    W = (P @ (L @ U)).detach()
    torch.testing.assert_close(W @ W.t(), eye, atol=1e-5, rtol=0)
    _, fldj = bij(x)
    logdet = torch.linalg.slogdet(W.double())[1]
    np.testing.assert_allclose(fldj.detach().numpy(), 9 * float(logdet),
                               atol=1e-4)
    back, _ = bij.inverse(bij(x)[0])
    torch.testing.assert_close(back, x, atol=1e-5, rtol=1e-5)
    b2 = tb.Invertible1x1Conv(C)
    b2.init(x, torch.Generator().manual_seed(0))
    assert torch.equal(b2.L, bij.L)                 # seeded


def test_squeeze_matches_jax_and_order():
    x = np.arange(2 * 4 * 4 * 2, dtype=np.float32).reshape(2, 4, 4, 2)
    jbij = jb.Squeeze()
    _check(jbij, (), tb.Squeeze(), x, 0, 0)
    y, _ = tb.Squeeze()(torch.from_numpy(x))
    assert y.shape == (2, 2, 2, 8)
    # output channels iterate (c, di, dj) with c outermost
    want = [x[0, 0, 0, 0], x[0, 0, 1, 0], x[0, 1, 0, 0], x[0, 1, 1, 0],
            x[0, 0, 0, 1], x[0, 0, 1, 1], x[0, 1, 0, 1], x[0, 1, 1, 1]]
    np.testing.assert_array_equal(y[0, 0, 0].numpy(), want)


@pytest.mark.parametrize("use_logit", [False, True])
def test_spec_preprocessing_matches_jax(use_logit):
    x = np.random.default_rng(4).uniform(-99.0, 19.0, (3, 8, 8, 1)).astype(
        np.float32)
    jbij = jb.SpecPreprocessing(-100.0, 20.0, use_logit=use_logit)
    tbij = tb.SpecPreprocessing(-100.0, 20.0, use_logit=use_logit)
    # log-dets sum 64 elements of magnitude ~5 (1e-3 for the logit's)
    _check(jbij, (), tbij, x, 1e-5, 1e-3)


@pytest.mark.parametrize("use_logit", [False, True])
def test_img_preprocessing_matches_jax_with_its_draw(use_logit):
    """Dequantisation: the port adds the noise it is given; fed the JAX
    package's uniform draw it gives JAX's output and log-det."""
    x = np.random.default_rng(5).integers(0, 256, (3, 4, 4, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    jbij = jb.ImgPreprocessing(use_logit=use_logit)
    tbij = tb.ImgPreprocessing(use_logit=use_logit)
    jy, jf = jbij.forward((), jnp.asarray(x), key)
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))
    ty, tf = tbij(torch.from_numpy(x), torch.from_numpy(u))
    _close(ty, jy)
    _close(tf, jf, atol=1e-3)
    _check(jbij, (), tbij, x, 1e-5, 1e-3)


def test_coupling_with_constant_net_has_the_analytic_logdet():
    """log_s = log 2 on the xb half of (2, 2, 4) events: 8 elements."""
    x = _x(6, (3, 2, 2, 4))
    jbij = jb.AffineCouplingSplit(jb.ConstantShiftAndLogScale())
    tbij = tb.AffineCouplingSplit(tb.ConstantShiftAndLogScale())
    _check(jbij, {"net": ()}, tbij, x)
    _, fldj = tbij(torch.from_numpy(x))
    np.testing.assert_allclose(fldj.numpy(), 8 * LOG2, rtol=1e-6)


def test_coupling_with_conv_net_matches_jax():
    """The conv net's last conv is zero at init (identity coupling), so the
    JAX params are perturbed first to make the coupling do work."""
    x = _x(7, (2, 4, 4, 6))
    jbij = jb.AffineCouplingSplit(jb.ShiftAndLogScaleConvNet(8))
    jp = jbij.init_params(jax.random.PRNGKey(7), jnp.asarray(x))
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * jnp.asarray(_x(a.size, a.shape)), jp)
    tbij = _load(tb.AffineCouplingSplit(tb.ShiftAndLogScaleConvNet(3, 8)),
                 jp)
    _check(jbij, jp, tbij, x)
    # the port's own init: a zero last conv, so the identity
    fresh = tb.AffineCouplingSplit(tb.ShiftAndLogScaleConvNet(3, 8))
    y = fresh.init(torch.from_numpy(x), torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(y.numpy(), x)
    assert float(fresh.net.conv1.kernel.detach().abs().max()) > 0


def test_chain_names_and_identity():
    """A chain's children are named ``f"{name}_{i}"``: named_parameters()
    gives the JAX key paths."""
    x = _x(8, (4, 2, 2, 4))
    jchain = jb.Chain([jb.ActNorm(), jb.Identity(), jb.Invertible1x1Conv()],
                      name="toy")
    jp, jy = jchain.init(jax.random.PRNGKey(8), jnp.asarray(x))
    tchain = tb.Chain([tb.ActNorm(4), tb.Identity(),
                       tb.Invertible1x1Conv(4)], name="toy")
    want = set(_flatten(jp))
    got = set(_flatten(params_to_jax(dict(tchain.named_parameters()))))
    assert got == want and "['inv1x1_2']['P']" in got
    _load(tchain, jp)
    _check(jchain, jp, tchain, x)
    # the port's init threads the minibatch as JAX's does: the ActNorm's
    # output, not x, reaches the 1x1 conv
    fresh = tb.Chain([tb.ActNorm(4), tb.Invertible1x1Conv(4)])
    y = fresh.init(torch.from_numpy(x), torch.Generator().manual_seed(0))
    z, _ = fresh(torch.from_numpy(x))
    torch.testing.assert_close(y, z.detach())


def test_invert_wrapper_shares_params_and_swaps_directions():
    x = _x(9, (4, 2, 2, 2))
    jbij = jb.ActNorm()
    jp = jbij.init_params(None, jnp.asarray(x))
    jinv = jb.Invert(jbij)
    tinv = tb.Invert(tb.ActNorm(2))
    assert set(dict(tinv.named_parameters())) == {"log_scale", "shift"}
    _load(tinv, jp)
    _check(jinv, jp, tinv, x)
    # init: the wrapped bijector's init on x, then the inverse direction
    fresh = tb.Invert(tb.ActNorm(2))
    y = fresh.init(torch.from_numpy(x))
    _close(fresh.inner.log_scale, jp["log_scale"])
    _close(y, jinv.forward(jp, jnp.asarray(x))[0])


def test_priors_match_jax():
    z = _x(10, (3, 2, 2, 4))
    shape = (2, 2, 4)
    jiso = jb.IsotropicNormalPrior(shape)
    _close(tb.IsotropicNormalPrior(shape).log_prob(torch.from_numpy(z)),
           jiso.log_prob((), jnp.asarray(z)))
    jdiag = jb.LearnableDiagNormalPrior(shape)
    jp = {"loc": jnp.asarray(_x(11, shape)),
          "log_scale": jnp.asarray(_x(12, shape, 0.3))}
    tdiag = _load(tb.LearnableDiagNormalPrior(shape), jp)
    _close(tdiag.log_prob(torch.from_numpy(z)),
           jdiag.log_prob(jp, jnp.asarray(z)))
    # sample = loc + eps * exp(log_scale), eps ~ N(0, 1)
    s = tdiag.sample(4000, torch.Generator().manual_seed(0)).detach()
    u = (s - tdiag.loc.detach()) * torch.exp(-tdiag.log_scale.detach())
    assert abs(float(u.mean())) < 0.02 and abs(float(u.std()) - 1) < 0.02


def test_invertible_1x1_conv_trains_p_and_sign_s_in_both_packages():
    """The JAX package calls P and sign_s fixed, but its optimizer moves
    every leaf of the params pytree. After three Adamax steps on the same
    loss, P is no longer a permutation matrix and sign_s no longer +-1,
    in both packages alike (the port copies the defect); the log-det
    formula H*W*sum(log_s) then differs from H*W*log|det W|."""
    x = _x(13, (4, 3, 3, 4))
    jbij = jb.Invertible1x1Conv()
    jp = jbij.init_params(jax.random.PRNGKey(9), jnp.asarray(x))
    tbij = _load(tb.Invertible1x1Conv(4), jp)
    opt = optax.adamax(1e-2)
    ostate = opt.init(jp)

    def loss(p):
        return jnp.sum(jbij.forward(p, jnp.asarray(x))[0] ** 2)

    topt = setup_optimizer("adamax", 1e-2).init(tbij.parameters())
    for _ in range(3):
        grads = jax.grad(loss)(jp)
        updates, ostate = opt.update(grads, ostate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad()
        (tbij(torch.from_numpy(x))[0] ** 2).sum().backward()
        topt.step()
    for name in ("P", "sign_s", "L", "U", "log_s"):
        _close(getattr(tbij, name), jp[name], 1e-5, 1e-6)
    for P in (np.asarray(jp["P"]), tbij.P.detach().numpy()):
        assert not np.array_equal(P, np.round(P))
    assert not np.array_equal(np.abs(np.asarray(jp["sign_s"])), np.ones(4))
    L, U, _ = tbij._assemble()
    W = (tbij.P @ (L @ U)).detach().double()
    _, fldj = tbij(torch.from_numpy(x))
    exact = 9 * float(torch.linalg.slogdet(W)[1])
    assert abs(float(fldj[0]) - exact) > 1e-3
