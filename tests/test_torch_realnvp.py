"""The port's RealNVP path against the JAX package on the CPU, float32: the
nn primitives RealNVP and Flow++ call (dense, instance and layer norm,
the weight-normalised conv, SAME max pooling, embedding), the masked
couplings and their ResNet / dense nets, RealNVP and ``build_realnvp``
(log p, log-det, inverse, bits/dim, train steps), and the
``train_realnvp`` CLI. Weights cross from the JAX package with
``params_from_jax``; the draws are the JAX package's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu import nn as jnn
from audiosourcesep_tpu.bijectors import FlowModel as JFlowModel
from audiosourcesep_tpu.bijectors import IsotropicNormalPrior as JIsoPrior
from audiosourcesep_tpu.bijectors import LearnableDiagNormalPrior as JDiag
from audiosourcesep_tpu.bijectors import coupling as jcoupling
from audiosourcesep_tpu.bijectors import nets as jnets
from audiosourcesep_tpu.models.realnvp import RealNVP as JRealNVP
from audiosourcesep_tpu.training import CheckpointManager as JManager
from audiosourcesep_tpu.training import init_train_state as jinit_state
from audiosourcesep_tpu.training import make_flow_train_step as jmake_step
from audiosourcesep_tpu.training import setup_optimizer as jsetup_optimizer
from audiosourcesep_tpu_torch import nn, train_realnvp
from audiosourcesep_tpu_torch.bijectors import (AffineCouplingMasked,
                                                ConstantShiftAndLogScale,
                                                ShiftAndLogScaleDenseNet,
                                                ShiftAndLogScaleResNet,
                                                binary_mask,
                                                stacked_masked_couplings)
from audiosourcesep_tpu_torch.models import build_realnvp
from audiosourcesep_tpu_torch.training import (init_train_state,
                                               make_flow_train_step,
                                               setup_optimizer)
from audiosourcesep_tpu_torch.training.checkpoint import (_flatten,
                                                          params_from_jax,
                                                          params_to_jax)

torch.set_num_threads(2)
SHAPE = (8, 8, 1)
CFG = dict(n_filters=4, n_blocks=1)
# f32 through a few convs: 1e-5 of the largest element; through the whole
# RealNVP (10 couplings, |log p| ~ 400): log p and log-dets to 1e-5
# relative, the inverse to 1e-4 of the largest element
TOL, RTOL_LP, TOL_INV = 1e-5, 1e-5, 1e-4


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _images(seed, n):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *SHAPE)).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _load(module, jparams):
    module.load_state_dict(params_from_jax(_flatten(jparams)))
    return module


def jax_params_of(jm, tm, x):
    """The params pytree of the JAX model ``jm`` (its structure from
    tracing ``jm.init`` on ``x``, no compute) holding the values of the
    port model ``tm``."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    flat = _flatten(params_to_jax(dict(tm.named_parameters())))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(flat[jax.tree_util.keystr(path)]),
        shapes)


def _perturb(jp, key="conv_out", scale=0.05):
    """``jp`` with every ``key`` weight (zero at init) set to small random
    values, so that the couplings do work."""
    def f(path, a):
        if key not in jax.tree_util.keystr(path):
            return a
        return a + scale * jnp.asarray(_rand(a.size, a.shape))
    return jax.tree_util.tree_map_with_path(f, jp)


# ---------------------------------------------------------------------------
# nn primitives
# ---------------------------------------------------------------------------

def test_dense_matches_jax():
    p = jnn.dense_init(jax.random.PRNGKey(0), 6, 5)
    p["bias"] = jnp.asarray(_rand(1, 5))
    x = _rand(2, (3, 4, 6))
    m = _load(nn.Dense(6, 5), p)
    _close(m(torch.from_numpy(x)), jnn.dense(p, jnp.asarray(x)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    """Statistics in f32 whatever the input dtype; in bf16 the output is
    rounded once, to bf16's 2^-8."""
    x = _rand(3, (2, 6, 4, 5), 3.0) + 1.0                     # NHWC
    g, b = _rand(4, 5), _rand(5, 5)
    want = jnn.instance_norm({"gamma": jnp.asarray(g),
                              "beta": jnp.asarray(b)},
                             jnp.asarray(x, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = nn.instance_norm(xt, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == xt.dtype
    tol = TOL if dtype == "float32" else 2 ** -7
    _close(got.float().permute(0, 2, 3, 1), np.asarray(want, np.float32),
           tol)
    plain = jnn.instance_norm({}, jnp.asarray(x))
    _close(nn.instance_norm(torch.from_numpy(x).permute(0, 3, 1, 2))
           .permute(0, 2, 3, 1), plain)


def test_layer_norm_matches_jax():
    p = {"gamma": jnp.asarray(_rand(6, 7)), "beta": jnp.asarray(_rand(7, 7))}
    x = _rand(8, (2, 3, 4, 7), 2.0)
    m = _load(nn.LayerNorm(7), p)
    _close(m(torch.from_numpy(x)), jnn.layer_norm(p, jnp.asarray(x)))


@pytest.mark.parametrize("zero_init,use_bias", [(False, True),
                                                (False, False),
                                                (True, True)])
def test_wnconv2d_matches_jax(zero_init, use_bias):
    p = jnn.wnconv2d_init(jax.random.PRNGKey(1), 3, 5, 3, use_bias=use_bias,
                          zero_init=zero_init)
    p["g"] = p["g"] * 1.5
    if use_bias:
        p["bias"] = jnp.asarray(_rand(9, 5))
    x = _rand(10, (2, 6, 8, 3))
    m = _load(nn.WNConv2d(3, 5, 3, use_bias=use_bias), p)
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, jnn.wnconv2d(p, jnp.asarray(x)))
    # the port's own init: ||v|| = g, so the kernel starts as v
    m.reset_parameters(torch.Generator().manual_seed(0), zero_init)
    norm = torch.sqrt((m.v ** 2).sum(dim=(1, 2, 3)) + 1e-12)
    torch.testing.assert_close(m.g.detach(), norm.detach())


@pytest.mark.parametrize("hw,window,stride", [((6, 8), 3, 1),
                                              ((5, 7), 5, 1),
                                              ((6, 8), 3, 2),
                                              ((5, 7), 3, 2)])
def test_max_pool_same_matches_jax(hw, window, stride):
    x = _rand(11, (2, *hw, 3))
    want = jnn.max_pool_same(jnp.asarray(x), window, stride)
    got = nn.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), window,
                           stride).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embedding_matches_jax():
    table = jnn.embedding_init(jax.random.PRNGKey(2), 10, 4)["table"]
    idx = np.array([3, 0, 9, 3])
    np.testing.assert_array_equal(
        nn.embedding(torch.from_numpy(np.array(table)),
                     torch.from_numpy(idx)).numpy(),
        np.asarray(jnn.embedding({"table": table}, jnp.asarray(idx))))
    t = nn.embedding_init(10, 4, torch.Generator().manual_seed(0))
    assert t.shape == (10, 4) and -0.05 <= t.min() and t.max() < 0.05


# ---------------------------------------------------------------------------
# masked couplings and their nets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masking", ["channel", "checkerboard"])
@pytest.mark.parametrize("state", [0, 1])
def test_binary_mask_matches_jax(masking, state):
    shape = (4, 6, 2)
    np.testing.assert_array_equal(
        binary_mask(shape, masking, state).numpy(),
        np.asarray(jcoupling.binary_mask(shape, masking, state)))


def test_masked_coupling_with_constant_net_has_analytic_logdet():
    """log_s = log 2, t = 1 on the unmasked half: y doubles and shifts
    there, the log-det is (unmasked count) x log 2, the inverse is
    exact."""
    bij = AffineCouplingMasked(ConstantShiftAndLogScale(), "checkerboard", 0)
    x = torch.from_numpy(_rand(12, (2, 4, 4, 1)))
    y, ld = bij(x)
    b = binary_mask((4, 4, 1), "checkerboard", 0)
    torch.testing.assert_close(y, b * x + (1 - b) * (2 * x + 1))
    torch.testing.assert_close(ld, torch.full((2,), 8 * np.log(2.0)))
    x_rec, ld_inv = bij.inverse(y)
    torch.testing.assert_close(x_rec, x)
    torch.testing.assert_close(ld_inv, ld)


def _jax_resnet(in_ch, seed=3):
    net = jnets.ShiftAndLogScaleResNet(4, n_blocks=2)
    return net, _perturb(net.init_params(jax.random.PRNGKey(seed), in_ch))


def test_resnet_matches_jax():
    net, p = _jax_resnet(2)
    x = _rand(13, (3, 6, 4, 2))
    m = _load(ShiftAndLogScaleResNet(2, 4, n_blocks=2), p)
    want = net.apply(p, jnp.asarray(x))
    for g, w in zip(m(torch.from_numpy(x)), want):
        _close(g, w)
    # the port's own init: the zero output conv makes log_s = t = 0
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(t, torch.zeros_like(t))
               for t in m(torch.from_numpy(x)))


def test_dense_net_matches_jax():
    net = jnets.ShiftAndLogScaleDenseNet(8)
    p = net.init_params(jax.random.PRNGKey(4), 6)
    x = _rand(14, (5, 6))
    m = _load(ShiftAndLogScaleDenseNet(6, 8), p)
    for g, w in zip(m(torch.from_numpy(x)), net.apply(p, jnp.asarray(x))):
        _close(g, w)


@pytest.mark.parametrize("masking,state", [("channel", 0),
                                           ("checkerboard", 1)])
def test_masked_coupling_matches_jax(masking, state):
    net, p = _jax_resnet(2)
    jbij = jcoupling.AffineCouplingMasked(net, masking, state)
    bij = _load(AffineCouplingMasked(ShiftAndLogScaleResNet(2, 4, 2),
                                     masking, state), {"net": p})
    x = _rand(15, (3, 6, 4, 2))
    (jy, jld), (y, ld) = jbij.forward({"net": p}, jnp.asarray(x)), \
        bij(torch.from_numpy(x))
    _close(y, jy)
    _close(ld, jld)
    jx, jld_inv = jbij.inverse({"net": p}, jy)
    x_rec, ld_inv = bij.inverse(torch.from_numpy(np.asarray(jy)))
    _close(x_rec, jx)
    _close(ld_inv, jld_inv)
    _close(x_rec, x, TOL_INV)


def test_stacked_masked_couplings_match_jax_and_init():
    """The chain's key paths and output equal the JAX package's with its
    params; the port's own init gives each ActNorm's output zero mean and
    unit variance per channel and leaves the couplings the identity."""
    jchain = jcoupling.stacked_masked_couplings(
        3, lambda: jnets.ShiftAndLogScaleResNet(4, 1), "checkerboard",
        name="stack1")
    x = _rand(16, (6, 4, 4, 2), 2.0) + 1.0
    jp, _ = jchain.init(jax.random.PRNGKey(5), jnp.asarray(x))
    jp = _perturb(jp)
    chain = stacked_masked_couplings(
        3, lambda: ShiftAndLogScaleResNet(2, 4, 1), "checkerboard", 2,
        name="stack1")
    assert set(_flatten(params_to_jax(dict(chain.named_parameters())))) \
        == set(_flatten(jp))
    _load(chain, jp)
    jy, jld = jchain.forward(jp, jnp.asarray(x))
    y, ld = chain(torch.from_numpy(x))
    _close(y, jy)
    _close(ld, jld)
    fresh = stacked_masked_couplings(
        3, lambda: ShiftAndLogScaleResNet(2, 4, 1), "checkerboard", 2)
    out = fresh.init(torch.from_numpy(x), torch.Generator().manual_seed(0))
    torch.testing.assert_close(out.mean(dim=(0, 1, 2)), torch.zeros(2),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(out.std(dim=(0, 1, 2), correction=0),
                               torch.ones(2), atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# RealNVP and build_realnvp
# ---------------------------------------------------------------------------

def _dequant_key(key):
    """The key of the uniform dequantisation draw of the JAX RealNVP's
    ``log_prob(params, x, key)``: RealNVP splits it in two, the first
    chain (scale1) splits its half over its four stages, and the
    ImgPreprocessing stage is the first."""
    return jax.random.split(jax.random.split(key)[0], 4)[0]


def jax_realnvp(shape=SHAPE, learntop=True, n_filters=4, n_blocks=1):
    """The JAX package's ``build_realnvp`` model, without its init."""
    H, W, C = shape
    prior = (JDiag if learntop else JIsoPrior)((H // 2, W // 2, 4 * C))
    return JFlowModel(JRealNVP(n_filters=n_filters, n_blocks=n_blocks),
                      prior)


def _pair(seed=0, learntop=True):
    """(JAX model, JAX params, port model with those params): the port's
    own init from a minibatch, carried into the JAX pytree, every
    coupling's zero-init output conv perturbed, and carried back by
    ``params_from_jax``."""
    x = _images(seed, 8)
    tm = build_realnvp(SHAPE, learntop=learntop, minibatch=torch.from_numpy(
        x), generator=torch.Generator().manual_seed(seed), **CFG)
    jm = jax_realnvp(learntop=learntop)
    jp = _perturb(jax_params_of(jm, tm, x))
    return jm, jp, _load(tm, jp)


@pytest.fixture(scope="module", params=[True, False],
                ids=["learntop", "isotropic"])
def pair(request):
    return _pair(0, request.param)


def test_realnvp_parameter_names_are_the_jax_key_paths(pair):
    jm, jp, tm = pair
    got = _flatten(params_to_jax(dict(tm.named_parameters())))
    want = _flatten(jp)
    assert set(got) == set(want)
    assert ("['bijector']['scale1']['stack1_1']['coupling_masked_0']['net']"
            "['conv_in']['v']") in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_realnvp_log_prob_inverse_and_bits_match_jax(pair):
    jm, jp, tm = pair
    x = _images(1, 3)
    key = jax.random.PRNGKey(7)
    u = torch.from_numpy(np.array(jax.random.uniform(_dequant_key(key),
                                                     x.shape)))
    want_lp = np.asarray(jm.log_prob(jp, jnp.asarray(x), key))
    lp = tm.log_prob(torch.from_numpy(x), u).detach().numpy()
    np.testing.assert_allclose(lp, want_lp, rtol=RTOL_LP)
    # the JAX bits_per_dim: -log p / (H W C ln 2)
    np.testing.assert_allclose(
        tm.bits_per_dim(torch.from_numpy(x), u).detach().numpy(),
        -want_lp / (np.prod(SHAPE) * np.log(2.0)), rtol=RTOL_LP)
    # the bijector's log-det and latent without dequantisation
    jz, jld = jm.bijector.forward(jp["bijector"], jnp.asarray(x))
    z, ld = tm.bijector(torch.from_numpy(x))
    assert tuple(z.shape) == (3, 4, 4, 4)
    _close(z, jz)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld),
                               rtol=RTOL_LP)
    # inverse: the sample of a given latent, and back
    zs = np.array(jax.random.normal(jax.random.PRNGKey(8), (3, 4, 4, 4)))
    jx, jld_inv = jm.bijector.inverse(jp["bijector"], jnp.asarray(zs))
    xs, ld_inv = tm.bijector.inverse(torch.from_numpy(zs))
    _close(xs, jx, TOL_INV)
    np.testing.assert_allclose(ld_inv.detach().numpy(), np.asarray(jld_inv),
                               rtol=RTOL_LP)
    _close(tm.bijector(xs)[0], zs, TOL_INV)


def test_build_realnvp_init():
    """The port's own init: the couplings start as the identity (zero
    output convs), so the latent of the minibatch has zero mean and unit
    variance per channel after each ActNorm; log p is finite."""
    x = torch.from_numpy(_images(2, 16))
    m = build_realnvp(SHAPE, minibatch=x,
                      generator=torch.Generator().manual_seed(0), **CFG)
    z, _ = m.bijector(x)
    z2 = z[..., 2:]                                  # scale2's output
    torch.testing.assert_close(z2.mean(dim=(0, 1, 2)), torch.zeros(2),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(z2.std(dim=(0, 1, 2), correction=0),
                               torch.ones(2), atol=1e-4, rtol=0)
    assert torch.isfinite(m.log_prob(x, torch.rand(x.shape))).all()


def test_realnvp_train_steps_match_jax():
    """Three Adam steps on the same batches with JAX's dequantisation
    draws: the losses to 1e-5 relative and the params, which Adam moves
    by about lr (1e-3) a step, to 2e-4 and Adam's moments to 1e-4 of
    their norm."""
    jm, jp, tm = _pair(3)
    opt = jsetup_optimizer("adam", 1e-3)
    jstate = jinit_state(jp, opt)
    jstep, _ = jmake_step(jm, opt)
    state = init_train_state(tm, setup_optimizer("adam", 1e-3))
    step, _ = make_flow_train_step()
    for s in range(3):
        x = _images(10 + s, 4)
        key = jax.random.PRNGKey(20 + s)
        jstate, jl = jstep(jstate, jnp.asarray(x), key)
        # the step splits its key (noise, dequantisation) first
        u = np.array(jax.random.uniform(
            _dequant_key(jax.random.split(key)[1]), x.shape))
        state, loss = step(state, torch.from_numpy(x),
                           dequant=torch.from_numpy(u))
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    want, got = _flatten(jstate), _flatten(state.tree())
    assert set(want) == set(got)
    for k, w in want.items():
        if k.startswith("['params']"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2e-4,
                                       err_msg=k)
    # Adam moves each param by about lr whatever the gradient's size, so
    # the moments (mu, nu: the clipped gradient and its square) carry
    # the gradients' scale: each leaf to 1e-4 of its norm (measured
    # 1.3e-5 at worst)
    moments = [k for k in want
               if k.startswith("['opt_state']") and np.ndim(want[k]) > 0]
    assert any(".mu[" in k for k in moments) and \
        any(".nu[" in k for k in moments)
    for k in moments:
        w = np.asarray(want[k], np.float64)
        assert np.linalg.norm(got[k] - w) <= 1e-4 * np.linalg.norm(w), k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mnist_npz(tmp_path_factory):
    """A small MNIST-layout npz (uint8 28x28) drawn with numpy."""
    path = str(tmp_path_factory.mktemp("mnist") / "mnist.npz")
    rng = np.random.default_rng(0)
    np.savez(path, x_train=rng.integers(0, 256, (96, 28, 28), np.uint8),
             x_test=rng.integers(0, 256, (20, 28, 28), np.uint8))
    return path


def test_train_realnvp_cli(tmp_path, monkeypatch, capsys, mnist_npz):
    """One epoch at tiny width on the CPU: the JAX CLI's contract (the
    ``Validation bits/dim`` line; a train state that the JAX package
    restores strictly)."""
    monkeypatch.setenv("ASR_MNIST_NPZ", mnist_npz)
    out = str(tmp_path / "realnvp")
    train_realnvp.main(["--dataset", "mnist", "--output", out, "--debug",
                        "--n_filters", "4", "--n_blocks", "1", "--n_epochs",
                        "1", "--batch_size", "32", "--learntop",
                        "--device", "cpu"])
    text = capsys.readouterr().out
    bpd = float(text.split("Validation bits/dim:")[1].split()[0])
    assert np.isfinite(bpd) and 4.0 < bpd < 12.0, bpd
    assert os.path.isfile(os.path.join(out, "out.log"))
    jm = jax_realnvp((32, 32, 1))
    template = jax.eval_shape(lambda x: jinit_state(
        jm.init(jax.random.PRNGKey(0), x), jsetup_optimizer("adam", 1e-3)),
        jnp.zeros((2, 32, 32, 1)))
    restored, step = JManager(os.path.join(out, "ckpts")).restore_latest(
        template)
    assert step == 3                      # 96 // 32 steps
    assert np.isfinite(np.asarray(restored["params"]["prior"]["loc"])).all()
