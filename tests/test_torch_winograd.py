"""Port of the Winograd conv (audiosourcesep_tpu_torch/ops/winograd.py)
against the JAX package: the Pallas kernel in interpret mode, the JAX
plain Winograd, and F.conv2d, in float32 on the CPU (atol 2e-4, as the
JAX package's own Pallas test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from audiosourcesep_tpu.ops import winograd as jwino
from audiosourcesep_tpu_torch.ops import winograd as twino

torch.set_num_threads(2)
ATOL = 2e-4


def _inputs(seed, shape, cout, scale=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, shape[-1], cout)) * scale
         ).astype(np.float32)
    return x, k


def _torch_conv(x, k):
    """NHWC x, HWIO k -> NHWC, through F.conv2d."""
    y = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                 torch.from_numpy(k).permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).numpy()


def test_plain_path_matches_pallas_interpret_reference_and_conv():
    # the JAX package's Pallas test shape: >1 row block and >1 batch entry
    x, k = _inputs(1, (2, 12, 8, 64), 64)
    got = twino.winograd_conv2d(torch.from_numpy(x),
                                torch.from_numpy(k)).numpy()
    pallas = np.asarray(jwino.winograd_conv2d(jnp.asarray(x), jnp.asarray(k),
                                              True))
    jref = np.asarray(jwino.winograd_conv2d_reference(jnp.asarray(x),
                                                      jnp.asarray(k)))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, jref, atol=ATOL)
    np.testing.assert_allclose(got, _torch_conv(x, k), atol=ATOL)


@pytest.mark.parametrize("shape,cout", [((2, 8, 12, 5), 7),
                                        ((1, 4, 4, 3), 2),
                                        ((3, 10, 6, 4), 4),
                                        ((2, 6, 4, 1), 3),
                                        ((1, 4, 6, 8), 1)])
def test_reference_matches_jax_reference_and_conv(shape, cout):
    x, k = _inputs(2, shape, cout, 0.3)
    got = twino.winograd_conv2d_reference(torch.from_numpy(x),
                                          torch.from_numpy(k)).numpy()
    jref = np.asarray(jwino.winograd_conv2d_reference(jnp.asarray(x),
                                                      jnp.asarray(k)))
    np.testing.assert_allclose(got, jref, atol=2e-5)
    np.testing.assert_allclose(got, _torch_conv(x, k), atol=2e-5)


def test_transform_weights_matches_jax():
    _, k = _inputs(3, (1, 4, 4, 6), 5)
    got = twino.transform_weights(torch.from_numpy(k)).numpy()
    want = np.asarray(jwino.transform_weights(jnp.asarray(k)))
    assert got.shape == (16, 6, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_autograd_matches_conv_gradient():
    x, k = _inputs(4, (1, 4, 6, 16), 8)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    (twino.winograd_conv2d(xt, kt) ** 2).sum().backward()

    xc = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    kc = torch.from_numpy(k).permute(3, 2, 0, 1).requires_grad_()
    (F.conv2d(xc, kc, padding=1) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               xc.grad.permute(0, 2, 3, 1).numpy(), atol=1e-3)
    np.testing.assert_allclose(kt.grad.numpy(),
                               kc.grad.permute(2, 3, 1, 0).numpy(), atol=1e-3)

    # and against the JAX package's custom VJP (Pallas forward, interpret)
    gx, gk = jax.grad(lambda a, b: jnp.sum(jwino.winograd_conv2d(a, b, True)
                                           ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-3)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk), atol=1e-3)


def test_cpu_path_does_not_launch_and_counts_stay():
    before = twino.launch_count
    x, k = _inputs(5, (1, 4, 4, 2), 2)
    twino.winograd_conv2d(torch.from_numpy(x), torch.from_numpy(k))
    assert twino.launch_count == before


def test_eligibility_follows_the_kernel_limits():
    assert twino.winograd_eligible((30, 96, 64, 1), (3, 3, 1, 192))
    assert twino.winograd_eligible((30, 48, 32, 384), (3, 3, 384, 384))
    assert twino.winograd_eligible((1, 2, 2, 1), (3, 3, 1, 1))
    assert not twino.winograd_eligible((2, 31, 32, 8), (3, 3, 8, 8))
    assert not twino.winograd_eligible((2, 32, 32, 8), (1, 1, 8, 8))
    assert not twino.winograd_eligible((2, 32, 32, 8), (3, 3, 8, 8),
                                       dilation=2)


def test_odd_spatial_dims_raise():
    x = torch.zeros(1, 5, 4, 2)
    with pytest.raises(ValueError):
        twino.winograd_conv2d(x, torch.zeros(3, 3, 2, 2))



# The bf16 numerics the card's kernel is held to: the JAX Pallas kernel
# itself (U rounded to bf16 by its wrapper, V formed in bf16) differs from
# the plain f32-accumulated version by this much. tests/test_torch_cuda.py
# and chip_smoke.py hold the Hopper bf16 kernel to the same pair.
BF16_MAX_REL, BF16_MEAN_REL = 2e-2, 1e-2


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 64), 128),
                                        ((2, 16, 12, 40), 33)])
def test_bf16_pallas_kernel_within_card_tolerance(shape, cout):
    x, k = _inputs(6, shape, cout, (1.0 / (9 * shape[-1])) ** 0.5)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(jwino.winograd_conv2d(xb, jnp.asarray(k), True)
                        .astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    plain = twino.winograd_conv2d_reference(xt, torch.from_numpy(k))
    assert plain.dtype == torch.bfloat16
    plain = plain.float().numpy()
    err = np.abs(pallas - plain)
    assert err.max() <= BF16_MAX_REL * np.abs(plain).max()
    assert err.mean() <= BF16_MEAN_REL * np.abs(plain).mean()


@pytest.mark.parametrize("cin,cout", [(6, 5), (64, 128), (1, 192)])
def test_transform_weights_in_bf16_match_jax_exactly(cin, cout):
    # the U operand the bf16 kernel takes, and the f32 U before rounding
    _, k = _inputs(7, (1, 4, 4, cin), cout, 0.3)
    got = twino.transform_weights(torch.from_numpy(k))
    want = jwino.transform_weights(jnp.asarray(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.to(torch.bfloat16).float().numpy(),
        np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("d", [2, 4])
def test_dilated_matches_pallas_interpret_and_conv(d):
    """The phase split around the plain version (the CPU path) against the
    JAX package's phase split around the Pallas kernel, and F.conv2d."""
    x, k = _inputs(7 + d, (2, 16, 8, 8), 16)
    before = dict(twino.launch_counts)
    got = twino.dilated_winograd_conv2d(torch.from_numpy(x),
                                        torch.from_numpy(k), d).numpy()
    assert twino.launch_counts == before     # CPU: no launch
    pallas = np.asarray(jwino.dilated_winograd_conv2d(
        jnp.asarray(x), jnp.asarray(k), d, interpret=True))
    conv = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(k).permute(3, 2, 0, 1), padding=d,
                    dilation=d).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 16, 8, 16)
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    np.testing.assert_allclose(got, conv, atol=ATOL)
    ref = twino.dilated_winograd_conv2d_reference(torch.from_numpy(x),
                                                  torch.from_numpy(k), d)
    np.testing.assert_array_equal(ref.numpy(), got)


def _phase_gather_reference(x, k, d):
    """The dilated conv by the kernels' own addressing, with no phase copy:
    tile (a, c) of phase (p, q) gathers x[d (2a + i - 1) + p,
    d (2c + j - 1) + q] (zero outside the image) with strided indices and
    writes y[d (2a + r) + p, d (2c + s) + q]."""
    b, h, w, cin = x.shape
    xp = F.pad(x, (0, 0, d, d, d, d))          # row d (2a + i) + p of xp
    ph = torch.arange(d)

    def taps(n_tiles, i):                      # [tiles, d] padded indices
        return d * (2 * torch.arange(n_tiles)[:, None] + i) + ph[None, :]

    th, tw = h // (2 * d), w // (2 * d)
    # dd[i, j, b, a, p, c, q, cin]
    dd = torch.stack([torch.stack([xp[:, taps(th, i)][:, :, :, taps(tw, j)]
                                   for j in range(4)]) for i in range(4)])
    bt, at = torch.from_numpy(twino._BT), torch.from_numpy(twino._AT)
    u = twino.transform_weights(k).reshape(4, 4, cin, -1)
    v = torch.einsum("ui,vj,ijbapcqn->uvbapcqn", bt, bt, dd)
    m = torch.einsum("uvbapcqn,uvnm->uvbapcqm", v, u)
    y = torch.einsum("ru,sv,uvbapcqm->barpcsqm", at, at, m)
    return y.reshape(b, h, w, -1)              # row a 2d + r d + p


@pytest.mark.parametrize("cin,cout", [(5, 7), (40, 33)])
@pytest.mark.parametrize("d", [2, 4])
def test_kernel_addressing_matches_pallas_interpret_and_phase_split(d, cin,
                                                                    cout):
    """The kernels read each phase's taps in place from the undilated x
    and write its outputs in place; that addressing, as plain PyTorch,
    against the JAX package's phase split around the Pallas kernel and
    the port's plain phase split, to 1e-5 relative."""
    x, k = _inputs(20 + d, (2, 16, 24, cin), cout)
    got = _phase_gather_reference(torch.from_numpy(x), torch.from_numpy(k),
                                  d).numpy()
    pallas = np.asarray(jwino.dilated_winograd_conv2d(
        jnp.asarray(x), jnp.asarray(k), d, interpret=True))
    split = twino.dilated_winograd_conv2d_reference(
        torch.from_numpy(x), torch.from_numpy(k), d).numpy()
    assert got.shape == (2, 16, 24, cout)
    for want in (pallas, split):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_phase_gather_reference_is_the_dense_conv_at_d1():
    x, k = _inputs(24, (2, 8, 12, 6), 5)
    got = _phase_gather_reference(torch.from_numpy(x), torch.from_numpy(k), 1)
    want = twino.winograd_conv2d_reference(torch.from_numpy(x),
                                           torch.from_numpy(k))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("h,w,d,rows,idle", [(48, 32, 1, 4, 0.0),
                                             (48, 32, 2, 4, 0.0),
                                             (48, 32, 4, 8, 0.25),
                                             (96, 64, 1, 4, 0.0)])
def test_block_shape_fills_the_cascade_grids(h, w, d, rows, idle):
    """The 32-tile block the wrappers pick for a (phase) grid: the dense
    and d = 2 grids of the cascade's 48x32 convs leave no tile slot idle,
    the d = 4 grid (6 x 4 tiles) at most a quarter."""
    th, tw = h // (2 * d), w // (2 * d)
    assert twino._block_rows(th, tw) == rows
    cols = 32 // rows
    slots = -(-th // rows) * rows * -(-tw // cols) * cols
    assert 1 - th * tw / slots == pytest.approx(idle)


@pytest.mark.parametrize("d", [2, 4])
def test_dilated_gradient_is_the_dilated_conv_vjp(d):
    x, k = _inputs(30 + d, (1, 16, 8, 6), 5)
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    (twino.dilated_winograd_conv2d(xt, kt, d) ** 2).sum().backward()
    xc = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    kc = torch.from_numpy(k).permute(3, 2, 0, 1).requires_grad_()
    (F.conv2d(xc, kc, padding=d, dilation=d) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(),
                               xc.grad.permute(0, 2, 3, 1).numpy(), atol=1e-3)
    np.testing.assert_allclose(kt.grad.numpy(),
                               kc.grad.permute(2, 3, 1, 0).numpy(), atol=1e-3)


def test_dilated_eligibility_and_refusal():
    assert twino.dilated_eligible((30, 48, 32, 384), (3, 3, 384, 384),
                                  dilation=2)
    assert twino.dilated_eligible((30, 48, 32, 384), (3, 3, 384, 384),
                                  dilation=4)
    assert not twino.dilated_eligible((30, 48, 32, 8), (3, 3, 8, 8))
    assert not twino.dilated_eligible((2, 12, 8, 8), (3, 3, 8, 8),
                                      dilation=4)
    assert not twino.dilated_eligible((2, 16, 16, 8), (3, 3, 8, 8),
                                      stride=2, dilation=2)
    with pytest.raises(ValueError):
        twino.dilated_winograd_conv2d(torch.zeros(1, 12, 8, 2),
                                      torch.zeros(3, 3, 2, 2), 4)
