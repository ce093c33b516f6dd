"""The port's Flow++ against the JAX package on the CPU, float32: the
mixture-of-logistics CDF, density and bisection inverse, the conv-attention
nets, the coupling, its layers and blocks, the variational
dequantisation, ``build_flowpp`` (log p, inverse, routed and not) and
train steps. Weights cross from the JAX package with ``params_from_jax``;
the draws are the JAX package's."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiosourcesep_tpu.bijectors import Chain as JChain
from audiosourcesep_tpu.bijectors import FlowModel as JFlowModel
from audiosourcesep_tpu.bijectors import IsotropicNormalPrior as JIsoPrior
from audiosourcesep_tpu.bijectors import flowpp_nets as jnets
from audiosourcesep_tpu.bijectors import mixlogcdf as jmix
from audiosourcesep_tpu.models import flowpp as jflowpp
from audiosourcesep_tpu.training import init_train_state as jinit_state
from audiosourcesep_tpu.training import make_flow_train_step as jmake_step
from audiosourcesep_tpu.training import restore_pytree as jrestore
from audiosourcesep_tpu.training import setup_optimizer as jsetup_optimizer
from audiosourcesep_tpu_torch import nn
from audiosourcesep_tpu_torch.bijectors import flowpp_nets as nets
from audiosourcesep_tpu_torch.bijectors import mixlogcdf as mix
from audiosourcesep_tpu_torch.models import (FlowppBlock,
                                             FlowppCouplingLayer,
                                             VariationalDequant,
                                             build_flowpp)
from audiosourcesep_tpu_torch.ops import counting
from audiosourcesep_tpu_torch.ops import winograd as W
from audiosourcesep_tpu_torch.training import (init_train_state,
                                               make_flow_train_step,
                                               setup_optimizer)
from audiosourcesep_tpu_torch.training.checkpoint import (_flatten,
                                                          params_from_jax,
                                                          params_to_jax,
                                                          save_pytree)

torch.set_num_threads(2)
SHAPE = (8, 8, 1)
CFG = dict(n_components=2, n_blocks_flow=1, n_blocks_dequant=1, filters=8,
           heads=2)
NET = dict(n_components=2, n_blocks=1, filters=8, heads=2)
# f32: a net or a coupling to 1e-5 of its largest output; the whole flow
# (13 coupling layers) with the couplings' output convs scaled to 0.1 of
# their Glorot init (at this narrow width a full-scale init drives the
# mixture CDF to its clip, where f32 rounding is amplified: 4e-5
# measured) to 1e-5
# relative; bisection inverses to 1e-4 of the largest element
TOL, RTOL_LP, TOL_INV = 1e-5, 1e-5, 1e-4


def _rand(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _images(seed, n, shape=SHAPE):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _carry(module, shapes, scale_out=1.0):
    """The port ``module``'s parameters (its own init) as a JAX pytree of
    the structure ``shapes`` (from ``jax.eval_shape`` of the JAX init),
    each ``conv_out`` scaled by ``scale_out``; loaded back into
    ``module`` with ``params_from_jax``. Returns the pytree."""
    flat = _flatten(params_to_jax(dict(module.named_parameters())))

    def leaf(path, s):
        k = jax.tree_util.keystr(path)
        return jnp.asarray(flat[k] * (scale_out if "conv_out" in k else 1.0))

    jp = jax.tree_util.tree_map_with_path(leaf, shapes)
    module.load_state_dict(params_from_jax(_flatten(jp)))
    return jp


def _reset(module, seed=0):
    """The port's random init of every net under ``module``."""
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nets.ConvAttnNet, nets.ShallowProcessor)):
            m.reset_parameters(g)
    return module


# ---------------------------------------------------------------------------
# mixture of logistics
# ---------------------------------------------------------------------------

def _mixture(seed, n, k):
    return (_rand(seed, (n, k)), 2.0 * _rand(seed + 1, (n, k)),
            -np.abs(_rand(seed + 2, (n, k))) - 0.2)


def test_mixlog_logcdf_and_logpdf_match_jax():
    params = _mixture(0, 16, 4)
    x = np.linspace(-6, 6, 16).astype(np.float32)
    jp = [jnp.asarray(p) for p in params]
    tp = [_t(p) for p in params]
    _close(mix.mixlog_logcdf(_t(x), *tp), jmix.mixlog_logcdf(
        jnp.asarray(x), *jp))
    _close(mix.mixlog_logpdf(_t(x), *tp), jmix.mixlog_logpdf(
        jnp.asarray(x), *jp))
    # the clamp of the log scales at -7
    ls = np.full((16, 4), -9.0, np.float32)
    _close(mix.mixlog_logcdf(_t(x), tp[0], tp[1], _t(ls)),
           jmix.mixlog_logcdf(jnp.asarray(x), jp[0], jp[1], jnp.asarray(ls)))


def test_mixlog_inv_cdf_round_trip_matches_jax():
    """64 bisection steps: x back from its CDF to 1e-3, the JAX
    package's x to 1e-4. y of 0 and 1 are clipped to [1e-10, 1 - 1e-7]:
    there the CDF is flat to f32's resolution, so the root is held by its
    CDF (within 2e-7 of the clip's log) rather than by its place."""
    params = _mixture(3, 18, 8)
    tp = [_t(p) for p in params]
    x = np.linspace(-3, 3, 16).astype(np.float32)
    y = np.exp(np.asarray(jmix.mixlog_logcdf(
        jnp.asarray(x), *[jnp.asarray(p[:16]) for p in params])))
    y = np.concatenate([y, [0.0, 1.0]]).astype(np.float32)
    want = np.asarray(jmix.mixlog_inv_cdf(jnp.asarray(y),
                                          *[jnp.asarray(p) for p in params]))
    got = mix.mixlog_inv_cdf(_t(y), *tp)
    np.testing.assert_allclose(got[:16].numpy(), want[:16], rtol=0,
                               atol=TOL_INV)
    np.testing.assert_allclose(got[:16].numpy(), x, rtol=0, atol=1e-3)
    ends = mix.mixlog_logcdf(got[16:], *[p[16:] for p in tp])
    clip = torch.log(torch.tensor([mix._CLIP_LO, mix._CLIP_HI]))
    torch.testing.assert_close(ends, clip, rtol=2e-7, atol=2e-7)


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------

def test_concat_elu_matches_jax():
    x = _rand(4, (2, 3, 4, 5))
    _close(nets.concat_elu(_t(x)), jnets.concat_elu(jnp.asarray(x)))


@pytest.mark.parametrize("use_nin", [True, False])
def test_glu_and_gated_conv_match_jax(use_nin):
    x = _rand(5, (2, 4, 6, 6))
    a = _rand(6, (2, 4, 6, 3))
    jgc = jnets.GatedConv(6, context=use_nin, use_nin=use_nin)
    gc = nets.GatedConv(6, 6, 3 if use_nin else 0, use_nin=use_nin)
    for m in gc.modules():
        if isinstance(m, (nn.Conv2d, nn.Dense)):
            m.reset_parameters(torch.Generator().manual_seed(1))
    jp = _carry(gc, jax.eval_shape(lambda: jgc.init_params(
        jax.random.PRNGKey(0), 6, 3 if use_nin else 0)))
    want = jgc.apply(jp, jnp.asarray(x), jnp.asarray(a))
    _close(gc(_t(x), _t(a)), want)


def test_gated_attn_and_block_match_jax():
    x = _rand(7, (2, 4, 6, 8))
    pos = _rand(8, (4, 6, 8))
    ctx = _rand(9, (2, 4, 6, 5))
    jblock = jnets.ConvAttnBlock(8, context=True, heads=2)
    block = nets.ConvAttnBlock(8, 5, heads=2)
    _reset(block)
    for m in block.modules():
        if isinstance(m, (nn.Conv2d, nn.Dense)):
            m.reset_parameters(torch.Generator().manual_seed(2))
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    jp = _carry(block, jax.eval_shape(lambda: jblock.init_params(
        jax.random.PRNGKey(0), 5)))
    _close(block.attn(_t(x), _t(pos)), jblock.attn.apply(
        jp["attn"], jnp.asarray(x), jnp.asarray(pos)))
    _close(block(_t(x), _t(pos), _t(ctx)), jblock.apply(
        jp, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ctx)))


@pytest.mark.parametrize("context_ch", [0, 5])
def test_conv_attn_net_matches_jax(context_ch):
    shape = (4, 6, 2)
    jnet = jnets.ConvAttnNet(shape, context=bool(context_ch), **NET)
    net = _reset(nets.ConvAttnNet(shape, context_ch=context_ch, **NET))
    jp = _carry(net, jax.eval_shape(lambda: jnet.init_params(
        jax.random.PRNGKey(0), context_ch)))
    x = _rand(10, (3, *shape))
    ctx = _rand(11, (3, 4, 6, 5)) if context_ch else None
    want = jnet.apply(jp, jnp.asarray(x),
                      None if ctx is None else jnp.asarray(ctx))
    got = net(_t(x), None if ctx is None else _t(ctx))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (3, 4, 6, 2)] * 2 + [(3, 4, 6, 2, 2)] * 3
    for g, w in zip(got, want):
        _close(g, w)


def test_shallow_processor_matches_jax():
    jproc = jnets.ShallowProcessor(8)
    proc = _reset(nets.ShallowProcessor(2, 8))
    jp = _carry(proc, jax.eval_shape(lambda: jproc.init_params(
        jax.random.PRNGKey(0), 2)))
    x = _images(12, 2, (4, 6, 2))
    _close(proc(_t(x)), jproc.apply(jp, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# coupling, layers, blocks, dequantisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split,state", [("channel", 0), ("channel", 1),
                                         ("checkerboard", 0),
                                         ("checkerboard", 1)])
def test_mixlogcdf_coupling_matches_jax(split, state):
    shape = (4, 4, 2)
    nn_shape = (4, 4, 1) if split == "channel" else (4, 2, 2)
    jbij = jmix.MixLogisticCDFCoupling(jnets.ConvAttnNet(nn_shape, **NET),
                                       split, state)
    bij = mix.MixLogisticCDFCoupling(
        _reset(nets.ConvAttnNet(nn_shape, **NET)), split, state)
    x = _rand(13, (2, *shape), 0.5)
    jp = _carry(bij, jax.eval_shape(lambda: jbij.init_params(
        jax.random.PRNGKey(0), jnp.asarray(x))), 0.1)
    jy, jld = jax.jit(jbij.forward)(jp, jnp.asarray(x))
    y, ld = bij(_t(x))
    _close(y, jy)
    _close(ld, jld)
    jx, jld_inv = jax.jit(jbij.inverse)(jp, jy)
    x_rec, ld_inv = bij.inverse(_t(jy))
    _close(x_rec, jx, TOL_INV)
    _close(ld_inv, jld_inv, TOL_INV)
    _close(x_rec, x, TOL_INV)


def test_coupling_layer_and_block_match_jax():
    """A context-conditioned block of two layers (the dequantisation
    flow's kind) forward and inverse, with the port's own init carried
    across; that init gives its first ActNorm's output zero mean and unit
    variance per element."""
    shape = (4, 4, 2)
    jblock = jflowpp.FlowppBlock(shape, 2, "checkerboard", context=True,
                                 **NET)
    block = FlowppBlock(shape, 2, "checkerboard", context_ch=5, **NET)
    x = _rand(14, (6, *shape))
    out = block.init(_t(x), torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    a = block.layer_0.actnorm(_t(x))[0]
    torch.testing.assert_close(a.mean(0), torch.zeros(shape), atol=1e-5,
                               rtol=0)
    torch.testing.assert_close(a.std(0, correction=0), torch.ones(shape),
                               atol=1e-4, rtol=0)
    jp = _carry(block, jax.eval_shape(lambda: jblock.init(
        jax.random.PRNGKey(0), jnp.asarray(x), context_ch=5)[0]), 0.1)
    ctx = _rand(15, (6, 4, 2, 5))
    jy, jld = jax.jit(lambda p, v, c: jblock.forward(p, v, context=c))(
        jp, jnp.asarray(x), jnp.asarray(ctx))
    y, ld = block(_t(x), context=_t(ctx))
    _close(y, jy)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld),
                               rtol=RTOL_LP)
    jx, _ = jax.jit(lambda p, v, c: jblock.inverse(p, v, context=c))(
        jp, jy, jnp.asarray(ctx))
    x_rec, _ = block.inverse(_t(jy), context=_t(ctx))
    _close(x_rec, jx, TOL_INV)
    _close(x_rec, x, TOL_INV)
    # a single layer is a block of one
    layer = FlowppCouplingLayer(shape, "channel", 1, **NET)
    jlayer = jflowpp.FlowppCouplingLayer(shape, "channel", 1, **NET)
    layer.init(_t(x), torch.Generator().manual_seed(1))
    jpl = _carry(layer, jax.eval_shape(lambda: jlayer.init(
        jax.random.PRNGKey(0), jnp.asarray(x))[0]), 0.1)
    jy, jld = jax.jit(jlayer.forward)(jpl, jnp.asarray(x))
    y, ld = layer(_t(x))
    _close(y, jy)
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld),
                               rtol=RTOL_LP)


def test_variational_dequant_matches_jax():
    """With JAX's eps: x + u and the bound's log-det; u in (0, 1)."""
    jdq = jflowpp.VariationalDequant(SHAPE, **{**NET, "n_blocks": 1})
    dq = VariationalDequant(SHAPE, **{**NET, "n_blocks": 1})
    x = _images(16, 4)
    dq.init(_t(x), torch.Generator().manual_seed(0))
    jp = _carry(dq, jax.eval_shape(lambda: jdq.init(
        jax.random.PRNGKey(0), jnp.asarray(x))[0]), 0.1)
    key = jax.random.PRNGKey(3)
    jy, jld = jax.jit(jdq.forward)(jp, jnp.asarray(x), key)
    y, ld = dq(_t(x), _t(jax.random.normal(key, x.shape)))
    _close(y - _t(x), np.asarray(jy) - x)
    u = (y - _t(x)).detach()
    assert 0.0 < float(u.min()) and float(u.max()) < 1.0
    np.testing.assert_allclose(ld.detach().numpy(), np.asarray(jld),
                               rtol=RTOL_LP)
    y_inv, ld_inv = dq.inverse(y)
    assert torch.equal(y_inv, y) and not ld_inv.any()


# ---------------------------------------------------------------------------
# build_flowpp
# ---------------------------------------------------------------------------

def jax_flowpp(shape=SHAPE, n_components=2, n_blocks_flow=1,
               n_blocks_dequant=1, filters=8, heads=2):
    """The JAX package's ``build_flowpp`` model, without its init."""
    H, W, C = shape
    dequant = jflowpp.VariationalDequant(shape, n_components,
                                         n_blocks_dequant, filters, heads)
    flow = jflowpp.FlowppCifar10(shape, n_components, n_blocks_flow,
                                 filters, heads)
    return JFlowModel(JChain([dequant, flow], name="flowpp"),
                      JIsoPrior((H // 2, W // 2, 4 * C)))


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX params, port model with those params): the port's
    own init from a minibatch, carried into the JAX pytree with every
    coupling net's output conv scaled by 0.1, and back."""
    x = _images(0, 8)
    tm = build_flowpp(SHAPE, minibatch=_t(x),
                      generator=torch.Generator().manual_seed(0), **CFG)
    jm = jax_flowpp()
    jp = _carry(tm, jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                   jnp.asarray(x)), 0.1)
    return jm, jp, tm


def _eps(key, shape):
    """The dequantisation's eps in the JAX ``log_prob(params, x, key)``:
    the flow's chain splits the key in two, the first half to the
    dequantisation."""
    return np.array(jax.random.normal(jax.random.split(key, 2)[0], shape))


def test_flowpp_parameter_names_are_the_jax_key_paths(pair):
    jm, jp, tm = pair
    got = set(_flatten(params_to_jax(dict(tm.named_parameters()))))
    assert got == set(_flatten(jp))
    assert ("['bijector']['flowpp_cifar10_1']['block3']['layer_2']"
            "['coupling']['net']['block_0']['attn']['qkv']['kernel']") in got
    assert tm.noise == "normal"


def test_flowpp_log_prob_and_inverse_match_jax(pair):
    """log p with JAX's eps, routed through the Winograd plain version
    and not; the flow's inverse of the latent of a dequantised batch (a
    sample from a latent in the data's typical set; elsewhere the
    mixture CDFs are flat and their bisection inverse ill-conditioned)
    gives the batch back."""
    jm, jp, tm = pair
    x = _images(1, 3)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax.jit(jm.log_prob)(jp, jnp.asarray(x), key))
    eps = _t(_eps(key, x.shape))
    for routed in (False, True):
        try:
            nn.set_winograd(routed)
            lp = tm.log_prob(_t(x), eps).detach().numpy()
        finally:
            nn.set_winograd(False)
        np.testing.assert_allclose(lp, want, rtol=RTOL_LP,
                                   err_msg=f"routed={routed}")
    y = x + np.random.default_rng(17).uniform(size=x.shape).astype(
        np.float32)
    jflow, pflow = jm.bijector.bijectors[1], jp["bijector"]["flowpp_cifar10_1"]
    z = jax.jit(jflow.forward)(pflow, jnp.asarray(y))[0]
    with torch.no_grad():
        ys = tm.sample(_t(z))
    _close(ys, y, TOL_INV)


def test_flowpp_routes_its_3x3_convs():
    """With routing on, every 3x3 conv of the flow (conv_in, the gated
    convs' conv1, conv_out, the processor's convs and its GLUs) reaches
    ``winograd_conv2d``; on the CPU it runs the plain version, so no
    kernel launch is counted."""
    tm = build_flowpp(SHAPE, minibatch=_t(_images(2, 4)),
                      generator=torch.Generator().manual_seed(0), **CFG)
    convs = [m for m in tm.modules() if isinstance(m, nn.Conv2d)]
    # 13 coupling nets x (conv_in, conv1, conv_out); the processor's conv,
    # 3 x (conv1, GLU conv)
    assert len(convs) == 13 * 3 + 1 + 3 * 2
    calls = []
    real = W.winograd_conv2d

    def spy(x, k, u=None):
        calls.append(tuple(x.shape))
        return real(x, k, u)

    x = _t(_images(3, 2))
    try:
        nn.set_winograd(True)
        W.winograd_conv2d, before = spy, counting.snapshot()
        tm.log_prob(x, tm.draw_noise(x.shape))
    finally:
        W.winograd_conv2d = real
        nn.set_winograd(False)
    assert len(calls) == len(convs) and counting.snapshot() == before


def test_flowpp_train_steps_match_jax(pair, tmp_path):
    """Two steps of Adam with the global-norm clip at 1 (the Flow++
    recipe) on the same batch with JAX's eps: the losses to 1e-5
    relative, the params (moved by about lr, 1e-3, a step) to 2e-4 and
    Adam's moments to 1e-4 of their norm; the train state's checkpoint
    restores strictly in the JAX package."""
    jm, jp, tm = pair
    opt = jsetup_optimizer("adam", 1e-3, clipnorm=1.0)
    jstate = jinit_state(jax.tree_util.tree_map(jnp.copy, jp), opt)
    jstep, _ = jmake_step(jm, opt)
    state = init_train_state(copy.deepcopy(tm),
                             setup_optimizer("adam", 1e-3, clipnorm=1.0))
    step, _ = make_flow_train_step()
    x = _images(5, 4)
    for s in range(2):
        key = jax.random.PRNGKey(30 + s)
        jstate, jl = jstep(jstate, jnp.asarray(x), key)
        # the step splits its key (noise, dequantisation) first
        eps = _t(_eps(jax.random.split(key)[1], x.shape))
        state, loss = step(state, _t(x), dequant=eps)
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
    # the port's train-state checkpoint restores strictly into the JAX
    # train state, every leaf equal
    path = save_pytree(str(tmp_path / "ckpt-2"), state.tree(), 2)
    restored, step_no = jrestore(path, jstate, strict=True)
    assert step_no == 2
    for k, v in _flatten(restored).items():
        np.testing.assert_array_equal(v, got[k], err_msg=k)
    # without a draw the step takes a normal one from its generator
    _, loss = step(state, _t(x), torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))


# ---------------------------------------------------------------------------
# the attention core and the melspec Flow++ (the port's own)
# ---------------------------------------------------------------------------

def test_gated_attn_core_is_sdpa_and_matches_the_jax_einsums(monkeypatch):
    """``GatedAttn``'s core is one ``F.scaled_dot_product_attention`` call
    of ``[N, heads, T, d]`` views (``ops.attention``), inside an ``attn``
    span; at 4 heads over 48 positions it matches the JAX package's two
    einsums and softmax, alone and inside ``ConvAttnBlock``."""
    from audiosourcesep_tpu_torch.ops import attention as attn_op
    seen = []
    real = attn_op.F.scaled_dot_product_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn_op.F, "scaled_dot_product_attention", spy)
    x = _rand(20, (3, 6, 8, 16))
    pos = _rand(21, (6, 8, 16))
    jblock = jnets.ConvAttnBlock(16, context=False, heads=4)
    block = nets.ConvAttnBlock(16, 0, heads=4)
    for m in block.modules():
        if isinstance(m, (nn.Conv2d, nn.Dense)):
            m.reset_parameters(torch.Generator().manual_seed(3))
        elif isinstance(m, nn.LayerNorm):
            m.reset_parameters()
    jp = _carry(block, jax.eval_shape(lambda: jblock.init_params(
        jax.random.PRNGKey(0), 0)))
    _close(block.attn(_t(x), _t(pos)), jblock.attn.apply(
        jp["attn"], jnp.asarray(x), jnp.asarray(pos)))
    _close(block(_t(x), _t(pos)), jblock.apply(
        jp, jnp.asarray(x), jnp.asarray(pos), None))
    assert seen == [((3, 4, 48, 4), {"scale": 0.5})] * 2


def _melspec_flowpp(shape=(16, 16, 1), seed=0):
    g = torch.Generator().manual_seed(seed)
    mb = torch.rand(4, *shape, generator=g) * 120.0 - 100.0
    return build_flowpp(shape, n_components=2, n_blocks_flow=1, filters=8,
                        heads=2, data_type="melspec", minibatch=mb,
                        generator=g)


def test_melspec_flowpp_has_no_dequantiser_and_draws_no_noise(monkeypatch):
    """The melspec form: the CIFAR-10 bijector's 4 + 2 + 3 couplings with
    no dequantisation, a model whose noise is ``none``; its log p and
    score draw nothing (every draw raises) and repeat exactly. Its traced
    score asks for the ``attn`` and ``mixlog`` leaves."""
    from audiosourcesep_tpu_torch.models import FlowppCifar10
    m = _melspec_flowpp().eval().requires_grad_(False)
    assert not [b for b in m.modules() if isinstance(b, VariationalDequant)]
    (flow,) = m.bijector.bijectors
    assert isinstance(flow, FlowppCifar10)
    assert [len(list(b.children())) for b in
            (flow.block1, flow.block2, flow.block3)] == [4, 2, 3]
    assert m.noise == "none" and m.draw_noise((2, 16, 16, 1)) is None
    assert m.traced_leaves == ("attn", "mixlog")
    names = {n for n, _ in m.named_parameters()}
    assert "bijector.flowpp_cifar10_0.block3.layer_2.coupling.net." \
        "block_0.attn.qkv.kernel" in names
    assert not any("dequant" in n or "processor" in n for n in names)
    x = torch.rand(3, 16, 16, 1, generator=torch.Generator().manual_seed(1)
                   ) * 120.0 - 100.0
    lp, s = m.log_prob(x), m.score(x)

    def no_draw(*args, **kwargs):
        raise AssertionError("a draw")

    for name in ("randn", "rand", "randn_like", "rand_like", "normal"):
        monkeypatch.setattr(torch, name, no_draw)
    monkeypatch.setattr(torch, "Generator", no_draw)
    assert torch.equal(m.log_prob(x), lp) and torch.equal(m.score(x), s)
    assert torch.isfinite(s).all() and s.abs().max() > 0


def test_melspec_flowpp_preprocessing_is_the_melspec_glows():
    """The rescaling ``(x - min) / (max - min) - 0.5``, no logit, and its
    log-det are ``build_glow(data_type="melspec")``'s, bit for bit; the
    image form keeps its logit preprocessing and dequantisation."""
    from audiosourcesep_tpu_torch.bijectors import (ImgPreprocessing,
                                                    SpecPreprocessing)
    from audiosourcesep_tpu_torch.models import build_glow
    m = _melspec_flowpp()
    glow = build_glow((16, 16, 1), L=2, K=1, n_filters=4,
                      data_type="melspec", device="meta")
    prep, gprep = m.bijector.bijectors[0].prep, glow.bijector.bijectors[0]
    assert isinstance(prep, SpecPreprocessing) and not prep.use_logit
    assert (prep.minval, prep.maxval) == (gprep.minval, gprep.maxval) == \
        (-100.0, 20.0)
    x = torch.rand(3, 16, 16, 1, generator=torch.Generator().manual_seed(2)
                   ) * 120.0 - 100.0
    (u, ld), (gu, gld) = prep(x), gprep(x)
    assert torch.equal(u, gu) and torch.equal(ld, gld)
    assert torch.equal(u, (x + 100.0) / 120.0 - 0.5)
    image = build_flowpp(SHAPE, device="meta", **CFG)
    assert isinstance(image.bijector.bijectors[1].prep, ImgPreprocessing)
    assert isinstance(image.bijector.bijectors[0], VariationalDequant)
    assert image.noise == "normal" and image.traced_leaves == ()
