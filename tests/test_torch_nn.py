"""NN primitives of the port (audiosourcesep_tpu_torch/nn.py) against
audiosourcesep_tpu.nn, float32 on the CPU (atol 1e-5: same math, another
summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audiosourcesep_tpu.nn as jnn
import audiosourcesep_tpu_torch.nn as tnn

torch.set_num_threads(2)
ATOL = 1e-5


def _nhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _to_torch(x):
    """NHWC numpy -> NCHW torch in channels_last memory (the models'
    layout)."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("ksize,dilation,bias", [(3, 1, True), (3, 2, False),
                                                 (3, 4, True), (1, 1, True)])
@pytest.mark.parametrize("winograd", [False, True])
def test_conv2d_matches_jax(ksize, dilation, bias, winograd):
    rng = np.random.default_rng(0)
    x = _nhwc(1, (2, 8, 12, 5))
    k = (rng.standard_normal((ksize, ksize, 5, 7)) * 0.2).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    params = {"kernel": jnp.asarray(k)}
    if bias:
        params["bias"] = jnp.asarray(b)
    want = np.asarray(jnn.conv2d(params, jnp.asarray(x), dilation=dilation))
    try:
        tnn.set_winograd(winograd)
        got = tnn.conv2d(_to_torch(x), torch.from_numpy(k).permute(3, 2, 0, 1),
                         torch.from_numpy(b) if bias else None, dilation)
    finally:
        tnn.set_winograd(False)
    np.testing.assert_allclose(_to_nhwc(got), want, atol=ATOL)


def test_conv2d_routes_only_eligible_convs(monkeypatch):
    from audiosourcesep_tpu_torch.ops import winograd as twino
    calls = []
    real = twino.winograd_conv2d

    def spy(x, kernel):
        calls.append(tuple(x.shape))
        return real(x, kernel)

    monkeypatch.setattr(twino, "winograd_conv2d", spy)
    x = _to_torch(_nhwc(2, (1, 4, 6, 3)))
    k3 = torch.ones(4, 3, 3, 3) * 0.1
    tnn.conv2d(x, k3)
    assert calls == []                      # off by default
    try:
        tnn.set_winograd(True)
        tnn.conv2d(x, k3)
        assert calls == [(1, 4, 6, 3)]      # NHWC view of the input
        tnn.conv2d(x, k3, dilation=2)       # dilated: F.conv2d
        tnn.conv2d(x, torch.ones(4, 3, 1, 1))  # 1x1: F.conv2d
        tnn.conv2d(_to_torch(_nhwc(3, (1, 5, 6, 3))), k3)  # odd H
        assert len(calls) == 1
    finally:
        tnn.set_winograd(False)


def test_avg_pool_same_matches_jax():
    x = _nhwc(4, (2, 9, 12, 3))
    want = np.asarray(jnn.avg_pool_same(jnp.asarray(x), 5))
    np.testing.assert_allclose(_to_nhwc(tnn.avg_pool_same(_to_torch(x), 5)),
                               want, atol=ATOL)


@pytest.mark.parametrize("shape", [(2, 9, 12, 3), (1, 2, 7, 4)])
def test_avg_pool_same_gradient_matches_jax(shape):
    """The pool's own backward (through its forward op) against JAX's
    VJP of avg_pool_same, channels_last input."""
    import jax
    x = _nhwc(6, shape)
    w = _nhwc(7, shape)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        jnn.avg_pool_same(a, 5) * w))(jnp.asarray(x)))
    xt = _to_torch(x).detach().requires_grad_()
    (tnn.avg_pool_same(xt, 5) * _to_torch(w)).sum().backward()
    np.testing.assert_allclose(_to_nhwc(xt.grad), want, atol=ATOL)


def test_avg_pool2_matches_jax():
    x = _nhwc(5, (2, 8, 12, 3))
    want = np.asarray(jnn.avg_pool2(jnp.asarray(x)))
    np.testing.assert_allclose(_to_nhwc(tnn.avg_pool2(_to_torch(x))), want,
                               atol=ATOL)


# NHWC shapes the card's pool kernel treats as edges: N = 1, H or W below
# the 5x5 window, odd W, 3 or 12 channels (a 2x2 VALID pool needs 2 rows
# and 2 columns)
EDGE_POOL_SHAPES = [(1, 3, 4, 3), (2, 7, 5, 12), (1, 2, 9, 8), (3, 6, 1, 16)]


@pytest.mark.parametrize("name,shape", [
    (name, shape) for name in ("avg_pool_same", "max_pool_same", "avg_pool2")
    for shape in EDGE_POOL_SHAPES
    if name != "avg_pool2" or min(shape[1:3]) >= 2])
def test_pools_on_the_cpu_match_jax_at_edge_shapes(name, shape):
    """The three NCSN pools on CPU tensors at the card kernel's edge
    shapes: the JAX package's numbers, and no kernel launch counted."""
    from audiosourcesep_tpu_torch.ops import counting
    x = _nhwc(8, shape)
    args = () if name == "avg_pool2" else (5,)
    want = np.asarray(getattr(jnn, name)(jnp.asarray(x), *args))
    before = counting.snapshot()
    got = _to_nhwc(getattr(tnn, name)(_to_torch(x), *args))
    assert counting.snapshot() == before
    assert got.shape == want.shape
    if name == "max_pool_same":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("src,dst", [((48, 32), (96, 64)), ((5, 7), (10, 14)),
                                     ((6, 4), (6, 4))])
def test_resize_bilinear_matches_jax(src, dst):
    x = _nhwc(6, (2, *src, 3))
    want = np.asarray(jnn.resize_bilinear(jnp.asarray(x), dst))
    got = tnn.resize_bilinear(_to_torch(x), dst)
    np.testing.assert_allclose(_to_nhwc(got), want, atol=ATOL)


def test_glorot_uniform_bounds_and_fans():
    g = torch.Generator().manual_seed(0)
    w = tnn.glorot_uniform((384, 192, 3, 3), g)
    limit = np.sqrt(6.0 / (192 * 9 + 384 * 9))
    assert w.shape == (384, 192, 3, 3)
    assert float(w.abs().max()) <= limit
    assert float(w.abs().max()) > 0.95 * limit
    n = tnn.normal_init((10, 1000), 0.02, g)
    assert abs(float(n.std()) - 0.02) < 1e-3


def test_winograd_weight_cache_follows_the_kernel():
    from audiosourcesep_tpu_torch.ops import winograd as twino
    kernel = torch.randn(5, 4, 3, 3)                 # OIHW
    cache = {}

    def u_of(k, dtype=torch.float32):
        return tnn._winograd_weights(cache, k, k.permute(2, 3, 1, 0), dtype)

    first = u_of(kernel)
    torch.testing.assert_close(
        first, twino.transform_weights(kernel.permute(2, 3, 1, 0)))
    assert u_of(kernel) is first                     # unchanged: reused
    with torch.no_grad():
        kernel.mul_(2.0)                             # in place: recomputed
    torch.testing.assert_close(u_of(kernel), 2.0 * first)
    doubled = u_of(kernel)
    other = kernel.clone()                           # another tensor
    assert u_of(other) is not doubled and cache["kernel"] is other
    assert u_of(other, torch.bfloat16).dtype == torch.bfloat16
