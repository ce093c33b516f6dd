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
from audiosourcesep_tpu_torch.ops import counting
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


@pytest.mark.parametrize("dtype,tf32", [(torch.float32, False),
                                        (torch.float64, True)])
def test_float32_backward_runs_cudnn_without_tf32(monkeypatch, dtype, tf32):
    """The backward's conv VJPs of a float32 conv run with cuDNN's TF32
    off, as the forward kernel computes in full float32, whatever the
    caller allowed (PyTorch allows it by default); another dtype keeps the
    caller's choice; the choice is the caller's again afterwards."""
    seen = []

    def spy(fn):
        def call(*args, **kwargs):
            seen.append(torch.backends.cudnn.allow_tf32)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(torch.nn.grad, "conv2d_input",
                        spy(torch.nn.grad.conv2d_input))
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight",
                        spy(torch.nn.grad.conv2d_weight))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x, k = _inputs(5, (1, 4, 6, 8), 8)
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    kt = torch.from_numpy(k).to(dtype).requires_grad_()
    (twino.winograd_conv2d(xt, kt) ** 2).sum().backward()
    assert seen == [tf32, tf32]
    assert torch.backends.cudnn.allow_tf32 is True


def test_cpu_path_does_not_launch_and_counts_stay():
    before = counting.snapshot()
    x, k = _inputs(5, (1, 4, 4, 2), 2)
    twino.winograd_conv2d(torch.from_numpy(x), torch.from_numpy(k))
    assert counting.snapshot() == before


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
    before = counting.snapshot()
    got = twino.dilated_winograd_conv2d(torch.from_numpy(x),
                                        torch.from_numpy(k), d).numpy()
    assert counting.snapshot() == before     # CPU: no launch
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


# ---------------------------------------------------------------------------
# the bf16 kernel's decomposition (csrc/winograd_mma.cu), modelled in numpy
# ---------------------------------------------------------------------------
# A block: 64 tiles of one column phase q (TC tile columns x 64 / TC tile
# rows from P row phases), 64 output channels, C_in in chunks of 16. A stage
# holds U [16 points][16 rows][64] (128-byte swizzled) at byte 0 and the x
# slab's two column-parity boxes at U_BYTES and U_BYTES + X_HALF.
KC, NB, U_BYTES, X_HALF, U_POINT = 16, 64, 32768, 6912, 2048
STAGE_BYTES = 47104


def _bf16r(a):
    """Round float32 values to bf16 (round to nearest even), as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _k_channel(k):
    """The chunk channel that U row (A column) k holds: lane q's A columns
    2q, 2q+1, 2q+8, 2q+9 are channels 4q..4q+3."""
    return 4 * ((k >> 1) & 3) + 2 * (k >> 3) + (k & 1)


def _swz128(off):
    """TMA's and wgmma's 128-byte swizzle of a byte offset."""
    return off ^ (((off >> 7) & 7) << 4)


def _tma_box(view, start, box, estride):
    """TMA tiled load of a box (``box``: the boxDim of each dimension,
    innermost first) from ``view`` (an array indexed innermost-last, i.e.
    ``view[i4, .., i0]``) at ``start`` with element strides ``estride``:
    dim k loads ceil(box[k] / estride[k]) elements, element ``i`` at
    ``start[k] + i * estride[k]``, zero outside the tensor. Returns the box
    in shared-memory order (innermost last)."""
    dims = view.shape[::-1]
    idx = [start[k] + estride[k] * np.arange(-(-box[k] // estride[k]))
           for k in range(5)]
    ok = [(i >= 0) & (i < n) for i, n in zip(idx, dims)]
    clip = [np.clip(i, 0, n - 1) for i, n in zip(idx, dims)]
    out = view[np.ix_(*clip[::-1])]
    keep = np.ones(out.shape, bool)
    for axis, m in enumerate(ok[::-1]):
        shape = [1] * 5
        shape[axis] = m.size
        keep &= m.reshape(shape)
    return np.where(keep, out, 0.0).astype(view.dtype)


def _stage_tma(x, u, d, P, TC, blk, j):
    """A stage as the producer's three TMA loads land it, as float32
    [STAGE_BYTES / 2] (one entry per bf16)."""
    b, p0, q, tr0, tc0, co0 = blk
    bsz, h, w, cin = x.shape
    cout = u.shape[2]
    trp = 64 // (TC * P)
    stage = np.zeros(STAGE_BYTES // 2, np.float32)
    for par in range(2):
        w0 = d * (2 * tc0 - 1 + par) + q     # the slab's first column
        if d <= twino.BF16_STRIDED_MAX_DILATION:
            # x as (C, W, row phase, phase row, batch), W strided by 2d
            box = _tma_box(x.reshape(bsz, h // d, d, w, cin),
                           (KC * j, w0, p0, 2 * tr0 - 1, b),
                           (KC, 2 * d * (TC + 1), P, 2 * trp + 2, 1),
                           (1, 2 * d, 1, 1, 1))
        else:
            # x as (2d C, W / 2d, row phase, phase row, batch): column w0
            # is place w0 - 2d g of group g, each next one a group on
            g = tc0 - 1 + par
            box = _tma_box(x.reshape(bsz, h // d, d, w // (2 * d),
                                     2 * d * cin),
                           (KC * j + (w0 - 2 * d * g) * cin, g, p0,
                            2 * tr0 - 1, b),
                           (KC, TC + 1, P, 2 * trp + 2, 1), (1,) * 5)
        box = box.reshape(-1)
        off = (U_BYTES + par * X_HALF) // 2
        stage[off:off + box.size] = box
    # U as (n, e, qj, h, point): channel 4 qj + 2 h + e
    uv = np.zeros((16, 2, cin // 4, 2, cout), np.float32)
    for e in range(2):
        for hh in range(2):
            uv[:, hh, :, e, :] = u[:, 2 * hh + e::4, :][:, :cin // 4]
    # strides of the view: point, h, qj, e, n (innermost last)
    ubox = _tma_box(uv, (co0, 0, 4 * j, 0, 0), (NB, 2, 4, 2, 16),
                    (1, 1, 1, 1, 1)).reshape(-1)
    offs = np.arange(ubox.size) * 2                  # unswizzled byte offset
    stage[_swz128(offs) // 2] = ubox
    return stage


def _stage_plain(x, u, d, P, TC, blk, j):
    """The same stage as the plain-load producer writes it."""
    b, p0, q, tr0, tc0, co0 = blk
    _, h, w, cin = x.shape
    cout = u.shape[2]
    trp = 64 // (TC * P)
    sr_n, sch = 2 * trp + 2, TC + 1
    stage = np.zeros(STAGE_BYTES // 2, np.float32)
    for par in range(2):
        for sr in range(sr_n):
            for ph in range(P):
                for k in range(sch):
                    gr, gc = 2 * tr0 - 1 + sr, 2 * tc0 - 1 + par + 2 * k
                    if not (0 <= gr < h // d and 0 <= gc < w // d):
                        continue
                    c = np.arange(KC * j, KC * j + KC)
                    vals = np.where(c < cin, x[b, d * gr + p0 + ph,
                                              d * gc + q,
                                              np.minimum(c, cin - 1)], 0.0)
                    off = (U_BYTES + par * X_HALF
                           + ((sr * P + ph) * sch + k) * 32) // 2
                    stage[off:off + KC] = vals
    for point in range(16):
        for k in range(KC):
            c = KC * j + _k_channel(k)
            for n in range(NB):
                co = co0 + n
                if c < cin and co < cout:
                    off = point * U_POINT + k * NB * 2 + 2 * n
                    stage[_swz128(off) // 2] = u[point, c, co]
    return stage


def _consume(stage, G, P, TC, acc):
    """Warpgroup G's chunk: every thread's slab reads at its byte offsets,
    V of the transform rows u = G .. G + 2 in bf16 arithmetic into its A
    registers, and the 12 wgmmas (m64n64k16, B read through the
    descriptor: MN-major, 8-row K groups 1024 B apart, 128-byte swizzle)
    added into ``acc[v]`` ([64 rows, 64]) with A^T[G][u] as the scale of
    A: ``acc[v]`` becomes P[G][v] = sum_u A^T[G][u] M[u][v]."""
    trp = 64 // (TC * P)
    rs = P * (TC + 1) * 32
    A = np.zeros((3, 4, 64, KC), np.float32)        # [u - G][v][row][k]
    for ct in range(128):
        wl, lane = ct >> 5, ct & 31
        t, lq = lane >> 2, lane & 3
        col, row0 = t & (TC - 1), (16 // TC) * wl + 2 * (t // TC)
        ph, trl = row0 // trp, row0 % trp
        xoff = U_BYTES + ((2 * trl * P + ph) * (TC + 1) + col) * 32 \
            + 8 * lq + G * rs
        tt = np.zeros((3, 2, 4, 4), np.float32)     # [u - G][s][jj][chan]
        for jj in range(4):
            src = xoff + (jj & 1) * X_HALF + (jj >> 1) * 32
            dd = [stage[(src + r * rs) // 2:(src + r * rs) // 2 + 4]
                  for r in range(5)]
            for ss in range(2):
                e = dd[2 * ss:2 * ss + 3]
                if G == 0:                          # u0, u1, u2
                    rows = (e[0] - e[2], e[1] + e[2], e[2] - e[1])
                else:                               # u1, u2, u3
                    rows = (e[0] + e[1], e[1] - e[0], e[0] - e[2])
                for k in range(3):
                    tt[k, ss, jj] = _bf16r(rows[k])
        for k in range(3):
            for ss in range(2):
                t0, t1, t2, t3 = tt[k, ss]
                vs = [_bf16r(t0 - t2), _bf16r(t1 + t2), _bf16r(t2 - t1),
                      _bf16r(t1 - t3)]
                m = 16 * wl + 8 * ss + t
                for v in range(4):
                    # channels 4lq..4lq+3 are A columns 2lq, 2lq+1, 2lq+8,
                    # 2lq+9
                    A[k, v, m, [2 * lq, 2 * lq + 1, 2 * lq + 8,
                                2 * lq + 9]] = vs[v]
    kk, nn = np.meshgrid(np.arange(KC), np.arange(NB), indexing="ij")
    for k in range(3):
        sign = -1.0 if G == 1 and k > 0 else 1.0    # A^T[G][G + k]
        for v in range(4):
            point = 4 * (G + k) + v
            byte = point * U_POINT + (kk // 8) * 1024 + (kk % 8) * 128 \
                + 2 * nn
            B = stage[_swz128(byte) // 2]
            acc[v] += sign * (A[k, v] @ B)


def _bf16_kernel_model(x, u, d, P, TC, path="tma"):
    """The bf16 kernel, block by block, chunk by chunk, as numpy: x
    [B, H, W, C_in] and U [16, C_in, C_out] float32 holding bf16 values
    (the kernel reads U with its rows padded to 8 channels, as the wrapper
    hands it over); returns y float32 holding bf16 values."""
    bsz, h, w, cin = x.shape
    cout = u.shape[2]
    u = twino._bf16_u(torch.from_numpy(u)).numpy()
    trp = 64 // (TC * P)
    th, tw = h // (2 * d), w // (2 * d)
    y = np.zeros((bsz, h, w, cout), np.float32)
    stage_of = _stage_tma if path == "tma" else _stage_plain
    for b in range(bsz):
        for p0 in range(0, d, P):
            for q in range(d):
                for tr0 in range(0, th, trp):
                    for tc0 in range(0, tw, TC):
                        for co0 in range(0, cout, NB):
                            blk = (b, p0, q, tr0, tc0, co0)
                            accs = [[np.zeros((64, NB), np.float32)
                                     for _ in range(4)] for _ in range(2)]
                            for j in range(-(-cin // KC)):
                                stage = stage_of(x, u, d, P, TC, blk, j)
                                for G in range(2):
                                    _consume(stage, G, P, TC, accs[G])
                            _epilogue(accs, y, d, P, TC, blk, th, tw)
    return y


def _epilogue(accs, y, d, P, TC, blk, th, tw):
    """Warpgroup G writes output row G of every tile: Y[G][j] = sum_v
    P[G][v] A^T[j][v], rounded to bf16 once, at the tile's interleaved
    pixels."""
    b, p0, q, tr0, tc0, co0 = blk
    trp = 64 // (TC * P)
    cout = y.shape[3]
    n = min(NB, cout - co0)
    for G in range(2):
        P_ = accs[G]
        out = (P_[0] + P_[1] + P_[2], P_[1] - P_[2] - P_[3])
        for m in range(64):
            wl, ss, t = m // 16, (m % 16) // 8, m % 8
            col, row = t & (TC - 1), (16 // TC) * wl + 2 * (t // TC) + ss
            ph, trl = row // trp, row % trp
            gtr, gtc = tr0 + trl, tc0 + col
            if gtr >= th or gtc >= tw:
                continue
            for jp in range(2):
                y[b, d * (2 * gtr + G) + p0 + ph, d * (2 * gtc + jp) + q,
                  co0:co0 + n] = _bf16r(out[jp][m, :n])


def _bf16_inputs(seed, shape, cout):
    x, k = _inputs(seed, shape, cout, (1.0 / (9 * shape[-1])) ** 0.5)
    xb = _bf16r(x)
    ub = _bf16r(twino.transform_weights(torch.from_numpy(k)).numpy())
    return x, k, xb, ub


@pytest.mark.parametrize("shape,cout,d", [((1, 16, 16, 16), 32, 1),
                                          ((1, 8, 20, 32), 40, 1),
                                          ((1, 16, 8, 16), 32, 2),
                                          ((1, 8, 24, 24), 16, 4),
                                          ((1, 16, 32, 32), 16, 8)])
def test_bf16_kernel_model_matches_pallas_interpret(shape, cout, d):
    """The kernel's decomposition (TMA boxes with element stride 2d, or
    above d = 4 over 2d-pixel groups, and zero fill, the parity-split
    slab, the permuted K order, the fold of
    A^T's rows over two warpgroups with A's sign as the wgmma scale, the
    epilogue's addressing), at the
    block shape the wrapper picks, against the JAX Pallas kernel in
    interpret mode on the same bf16 operands: one bf16 rounding of Y
    apart at most, and against the port's plain version within the card's
    bf16 tolerance."""
    x, k, xb, ub = _bf16_inputs(40 + d, shape, cout)
    h, w = shape[1:3]
    P, TC = twino._bf16_block(h // (2 * d), w // (2 * d), d)
    got = _bf16_kernel_model(xb, ub, d, P, TC)
    xj = jnp.asarray(xb).astype(jnp.bfloat16)
    if d == 1:
        pallas = jwino.winograd_conv2d(xj, jnp.asarray(k), True)
    else:
        pallas = jwino.dilated_winograd_conv2d(xj, jnp.asarray(k), d,
                                               interpret=True)
    pallas = np.asarray(pallas.astype(jnp.float32))
    scale = np.abs(pallas).max()
    # V is bitwise the Pallas kernel's; the f32 sums differ in order only
    assert np.abs(got - pallas).max() <= 2 ** -7 * scale
    assert np.abs(got - pallas).mean() <= 1e-3 * np.abs(pallas).mean()
    xt = torch.from_numpy(xb).bfloat16()
    plain = (twino.winograd_conv2d_reference(xt, torch.from_numpy(k))
             if d == 1 else twino.dilated_winograd_conv2d_reference(
                 xt, torch.from_numpy(k), d)).float().numpy()
    err = np.abs(got - plain)
    assert err.max() <= BF16_MAX_REL * np.abs(plain).max()
    assert err.mean() <= BF16_MEAN_REL * np.abs(plain).mean()


@pytest.mark.parametrize("d,P,TC", [(1, 1, 8), (2, 2, 8), (4, 4, 4),
                                    (2, 1, 4), (6, 2, 8), (8, 4, 4),
                                    (16, 1, 8)])
def test_bf16_plain_copy_lands_the_tma_layout(d, P, TC):
    """The plain-load producer (the thin classes) writes every stage
    exactly as the TMA loads land it: the slab with its zero halo, channels
    past C_in zero, U in the permuted K order with the 128-byte swizzle.
    Above d = 4 TMA takes C_in in whole chunks (:func:`bf16_path`)."""
    cin = 24 if d <= twino.BF16_STRIDED_MAX_DILATION else 32
    _, _, xb, ub = _bf16_inputs(50 + d, (2, 8 * d, 12 * d, cin), 72)
    th, tw = 4, 6
    trp = 64 // (TC * P)
    for blk in ((1, 0, d - 1, 0, 0, 0),
                (0, d - P, 0, (th - 1) // trp * trp, (tw - 1) // TC * TC,
                 64)):
        for j in range(2):
            np.testing.assert_array_equal(
                _stage_plain(xb, ub, d, P, TC, blk, j),
                _stage_tma(xb, ub, d, P, TC, blk, j))


@pytest.mark.parametrize("shape,cout,path", [((1, 8, 8, 1), 32, "plain"),
                                             ((1, 8, 8, 16), 1, "tma"),
                                             ((1, 8, 8, 5), 7, "plain"),
                                             ((1, 8, 8, 12), 24, "plain"),
                                             ((1, 8, 8, 16), 24, "tma")])
def test_bf16_thin_classes_take_the_plain_path(shape, cout, path):
    """When TMA cannot address x (C_in not a multiple of 8: begin_conv
    1->192) the producer of the same kernel brings x and U in with plain
    loads, in the same layout; a C_out that is not a multiple of 8 (end_conv
    192->1) stays on TMA, U's rows padded to 8. The model holds each path
    to the Pallas kernel."""
    x, k, xb, ub = _bf16_inputs(60, shape, cout)
    assert twino.bf16_path(torch.from_numpy(xb).bfloat16()) == path
    got = _bf16_kernel_model(xb, ub, 1, 1, 8, path)
    pallas = np.asarray(jwino.winograd_conv2d(
        jnp.asarray(xb).astype(jnp.bfloat16), jnp.asarray(k), True)
        .astype(jnp.float32))
    assert np.abs(got - pallas).max() <= 2 ** -7 * np.abs(pallas).max()


@pytest.mark.parametrize("cin,d,path", [(24, 4, "tma"), (24, 8, "plain"),
                                        (32, 8, "tma"), (5, 8, "plain"),
                                        (192, 16, "tma"), (24, 6, "plain")])
def test_bf16_path_takes_whole_chunks_above_dilation_4(cin, d, path):
    """Above d = 4 the x tensor map addresses groups of 2d pixels, where a
    chunk past C_in would read the next pixel's channels, not TMA's zero
    fill: TMA then needs C_in in whole 16-channel chunks, and any other
    C_in takes the plain loads."""
    x = torch.zeros(1, 2 * d, 2 * d, cin, dtype=torch.bfloat16)
    assert twino.bf16_path(x, d) == path


@pytest.mark.parametrize("h,w,d,shape,idle", [(48, 32, 1, (1, 8), 0.0),
                                              (48, 32, 2, (2, 8), 0.0),
                                              (48, 32, 4, (2, 4), 0.25),
                                              (96, 64, 1, (1, 8), 0.0)])
def test_bf16_block_fills_the_cascade_grids(h, w, d, shape, idle):
    """The bf16 kernel's 64-tile block for a phase grid, (P row phases, TC
    tile columns): the dense and d = 2 grids of the cascade's 48x32 convs
    and the 96x64 grid leave no tile slot idle, the d = 4 grid (6 x 4
    tiles) a quarter."""
    th, tw = h // (2 * d), w // (2 * d)
    assert twino._bf16_block(th, tw, d) == shape
    p, tc = shape
    rows = 64 // (tc * p)
    slots = -(-th // rows) * rows * -(-tw // tc) * tc
    assert 1 - th * tw / slots == pytest.approx(idle)


# ---------------------------------------------------------------------------
# the f32 kernel's thin paths (csrc/winograd_thin.cu), modelled in numpy
# ---------------------------------------------------------------------------
# A block owns a box of phase-grid images x tile rows x tile columns.
# thin_out: 2 G groups of 64 / G threads; thread (half hf, group, tile) owns
# rows 2 hf, 2 hf + 1 of V and CB output channels. A stage holds the x slab,
# [nimg][2 trb + 2 rows][2 tcb + 2 slots][PIXW floats], a row's even columns
# in its first tcb + 1 slots and its odd ones after, then U [KC][16][CO].
# thin_in: Wc channel warps x Wt tile warps, a lane an output channel with
# its U in registers; the slab [C_in][pixels] and V [tiles][C_in][16] in
# shared memory; tile warp w walks tiles w, w + Wt, ...

# the SMs of the H100 on which the thin geometry was fitted
H100_SMS = 132


def _thin_box_grid(x_shape, d, box):
    b, h, w, _ = x_shape
    nimg, trb, tcb = box
    ni, th, tw = b * d * d, h // (2 * d), w // (2 * d)
    return [(ib * nimg, tr0 * trb, tc0 * tcb)
            for ib in range(-(-ni // nimg))
            for tr0 in range(-(-th // trb))
            for tc0 in range(-(-tw // tcb))], (ni, th, tw)


def _thin_tiles(box):
    """Box-local (image, tile row, tile column) of each tile t (column
    fastest)."""
    nimg, trb, tcb = box
    t = np.arange(nimg * trb * tcb)
    return t // (tcb * trb), (t // tcb) % trb, t % tcb


def _thin_slab_pixels(x, d, box, origin):
    """x at each slab pixel of a box, [nimg][2 trb + 2][2 tcb + 2][C_in],
    zero outside the phase grid (the halo and the ragged edge)."""
    bsz, h, w, cin = x.shape
    nimg, trb, tcb = box
    ii0, tr0, tc0 = origin
    out = np.zeros((nimg, 2 * trb + 2, 2 * tcb + 2, cin), np.float32)
    for im in range(nimg):
        if ii0 + im >= bsz * d * d:
            continue
        b, ph = divmod(ii0 + im, d * d)
        pr, pc = divmod(ph, d)
        for r in range(2 * trb + 2):
            gr = 2 * tr0 - 1 + r
            for c in range(2 * tcb + 2):
                gc = 2 * tc0 - 1 + c
                if 0 <= gr < h // d and 0 <= gc < w // d:
                    out[im, r, c] = x[b, d * gr + pr, d * gc + pc]
    return out


def _thin_store(m, box, origin, grid, d, y, oc, written):
    """Y = A^T M A of each tile t in ``m`` ({t: M [16]}) into y[..., oc],
    skipping tiles outside the grid."""
    at = twino._AT.astype(np.float32)
    ni, th, tw = grid
    im, tr, tc = _thin_tiles(box)
    for t, mt in m.items():
        ii, otr, otc = origin[0] + im[t], origin[1] + tr[t], origin[2] + tc[t]
        if ii >= ni or otr >= th or otc >= tw:
            continue
        b, ph = divmod(ii, d * d)
        pr, pc = divmod(ph, d)
        yt = at @ mt.reshape(4, 4) @ at.T
        for i in range(2):
            for jj in range(2):
                pix = (b, d * (2 * otr + i) + pr, d * (2 * otc + jj) + pc, oc)
                y[pix] = yt[i, jj]
                written[pix] += 1


def _thin_out_model(x, u, d, y, written, sms):
    bsz, h, w, cin = x.shape
    cout = u.shape[2]
    cb, g, co, kc, pixw = twino._thin_out_channels(cin, cout)
    *box, n, warps = twino._thin_geometry(x.shape, cout, d, "thin_out", sms)
    box = tuple(box)
    assert warps == twino.THIN_NT // 32
    nimg, trb, tcb = box
    tpb, sr, sc, hh = nimg * trb * tcb, 2 * trb + 2, 2 * tcb + 2, tcb + 1
    assert tpb == twino.THIN_NT // (2 * g)
    nch = cin // kc
    im, tr, tc = _thin_tiles(box)
    bt = twino._BT.astype(np.float32)
    origins, grid = _thin_box_grid(x.shape, d, box)
    for origin in origins:
        pixels = _thin_slab_pixels(x, d, box, origin)
        # the slab as the copies land it: slot (row, parity half + column
        # / 2), PIXW floats a slot
        slab = np.zeros((nimg, sr, sc, pixw), np.float32)
        cols = np.arange(sc)
        ms = []
        for r in range(n):                    # cluster rank r
            acc = np.zeros((2, g, tpb, 8, cb), np.float32)
            for j in range(r * nch // n, (r + 1) * nch // n):
                slab[:, :, (cols & 1) * hh + (cols >> 1), :kc] = \
                    pixels[..., j * kc:(j + 1) * kc]
                flat = slab.reshape(-1)
                us = np.zeros((kc, 16, co), np.float32)
                us[:, :, :cout] = u[:, j * kc:(j + 1) * kc].transpose(1, 0, 2)
                for hf in range(2):
                    prow = (im * sr + 2 * tr + hf) * sc + tc
                    for hq in range(kc // 4):
                        jj = np.arange(4)
                        slot = (prow[:, None, None] + np.arange(3)[None, :, None]
                                * sc + ((jj & 1) * hh + (jj >> 1))[None, None])
                        # dd[t, 3 patch rows hf.., 4 columns, 4 channels]
                        dd = flat[(slot * pixw + 4 * hq)[..., None]
                                  + np.arange(4)]
                        rows = (np.stack([dd[:, 1] - dd[:, 0], dd[:, 0] - dd[:, 2]],
                                         1) if hf else
                                np.stack([dd[:, 0] - dd[:, 2], dd[:, 1] + dd[:, 2]],
                                         1))
                        v = np.einsum("tajk,vj->tavk", rows, bt).reshape(-1, 8, 4)
                        for k in range(4):
                            for grp in range(g):
                                acc[hf, grp] += v[:, :, k, None] * us[
                                    4 * hq + k, 8 * hf:8 * hf + 8, None,
                                    grp * cb:(grp + 1) * cb][:, 0]
            # M [tile][channel][16] in the rank's shared memory
            m = np.zeros((tpb, co, 16), np.float32)
            for hf in range(2):
                for grp in range(g):
                    m[:, grp * cb:(grp + 1) * cb, 8 * hf:8 * hf + 8] = \
                        acc[hf, grp].transpose(0, 2, 1)
            ms.append(m)
        for r in range(n):          # rank r's slice, summed in rank order
            for oc in range(cout):
                m = {}
                for t in range(r * tpb // n, (r + 1) * tpb // n):
                    total = np.zeros(16, np.float32)
                    for rk in range(n):
                        total = total + ms[rk][t, oc]
                    m[t] = total
                _thin_store(m, box, origin, grid, d, y, oc, written)


def _thin_in_model(x, u, d, y, written, sms):
    bsz, h, w, cin = x.shape
    cout = u.shape[2]
    *box, twarps, cwarps = twino._thin_geometry(x.shape, cout, d, "thin_in",
                                                sms)
    box = tuple(box)
    assert cwarps == twino._thin_in_channel_warps(cout)
    im, tr, tc = _thin_tiles(box)
    bt = twino._BT.astype(np.float32)
    origins, grid = _thin_box_grid(x.shape, d, box)
    for origin in origins:
        slab = _thin_slab_pixels(x, d, box, origin)
        # V of every (tile, input channel) once: [tiles][C_in][16]
        dd = np.stack([np.stack([slab[im, 2 * tr + i, 2 * tc + jj]
                                 for jj in range(4)], 1) for i in range(4)], 1)
        v = np.einsum("ui,tijc,vj->tcuv", bt, dd, bt).reshape(-1, cin, 16)
        for cob in range(-(-cout // (32 * cwarps))):
            for lane in range(32 * cwarps):      # a lane an output channel
                oc = 32 * cwarps * cob + lane
                if oc >= cout:
                    continue
                ur = u[:, :, oc].T               # [C_in][16], its registers
                for wp in range(twarps):         # tile warp wp's tiles
                    tiles = np.arange(wp, len(im), twarps)
                    m = np.zeros((len(tiles), 16), np.float32)
                    for c in range(cin):
                        m = m + v[tiles, c] * ur[c]
                    _thin_store(dict(zip(tiles, m)), box, origin, grid, d, y,
                                oc, written)


def _thin_kernel_model(x, u, d, path, sms=H100_SMS):
    """The thin kernel, block by block, as numpy, in the geometry the
    wrapper picks on a card of ``sms`` SMs; returns y and how often each
    output was written."""
    y = np.zeros((*x.shape[:3], u.shape[2]), np.float32)
    written = np.zeros(y.shape, np.int64)
    (_thin_out_model if path == "thin_out" else _thin_in_model)(
        x, u, d, y, written, sms)
    return y, written


@pytest.mark.parametrize("shape,cout,d,path", [
    ((2, 8, 8, 64), 4, 1, "thin_out"),       # a cluster of 2 ranks
    ((1, 8, 8, 256), 8, 1, "thin_out"),      # 8 ranks, 2 groups
    ((2, 8, 8, 64), 16, 1, "thin_out"),      # 4 groups of 32 tiles
    ((2, 16, 8, 64), 1, 1, "thin_out"),      # one channel a thread
    ((1, 12, 8, 36), 5, 1, "thin_out"),      # chunks of 4, C_out padded
    ((2, 16, 16, 32), 8, 2, "thin_out"),     # phase grids in place
    ((2, 8, 8, 2), 16, 1, "thin_in"),
    ((2, 12, 8, 3), 32, 1, "thin_in"),
    ((2, 8, 8, 1), 8, 1, "thin_in"),
    ((1, 8, 8, 4), 40, 1, "thin_in"),        # C_out past a block
    ((2, 16, 8, 3), 16, 2, "thin_in"),
    ((8, 4, 4, 64), 16, 1, "thin_out"),      # a box 2 tiles wide
    ((2, 48, 24, 2), 16, 1, "thin_in")])     # 576 tiles: the wrapper's
def test_thin_kernel_model_matches_pallas_interpret(shape, cout, d, path):
    """Each thin path's decomposition (the box the wrapper picks, the
    slab with its zero halo; thin_out's parity-split slots, two rows of V a
    thread for 4 channels from 3 patch rows, U's layout, the split of C_in
    over the cluster, the partial M in each rank's shared memory and the
    slice reduction in rank order; thin_in's one stage, V of each tile and
    channel once, a lane's U and its register epilogue, at the box of 8
    tiles that small grids take and at the box of 32; the epilogue's
    addressing, each output written once) against the JAX Pallas kernel in
    interpret mode, to 1e-5 of max|y| (f32, summation order only), and
    against the port's plain version within the card's f32 tolerance
    (1e-4). The wrapper sends thin_in grids of at most THIN_IN_MIN_TILES
    tiles to the wide design; the kernel takes them when forced."""
    x, k = _inputs(70 + d + shape[-1], shape, cout, (1.0 / (9 * shape[-1]))
                   ** 0.5)
    tiles = shape[0] * shape[1] * shape[2] // 4
    assert twino._thin_eligible(shape, cout, path)
    assert twino.f32_path(shape, cout, d) == (
        "wide" if path == "thin_in" and tiles <= twino.THIN_IN_MIN_TILES
        else path)
    u = twino.transform_weights(torch.from_numpy(k)).numpy()
    # thin_in: as on the H100, and with no floor on the warps a launch
    # has (0 SMs), the box of 32 tiles
    models = [_thin_kernel_model(x, u, d, path, sms)
              for sms in ((H100_SMS, 0) if path == "thin_in" else
                          (H100_SMS,))]
    for _, written in models:
        assert (written == 1).all()
    if d == 1:
        pallas = jwino.winograd_conv2d(jnp.asarray(x), jnp.asarray(k), True)
        plain = twino.winograd_conv2d_reference(torch.from_numpy(x),
                                                torch.from_numpy(k))
    else:
        pallas = jwino.dilated_winograd_conv2d(jnp.asarray(x), jnp.asarray(k),
                                               d, interpret=True)
        plain = twino.dilated_winograd_conv2d_reference(
            torch.from_numpy(x), torch.from_numpy(k), d)
    pallas, plain = np.asarray(pallas), plain.numpy()
    for got, _ in models:
        assert np.abs(got - pallas).max() <= 1e-5 * np.abs(pallas).max()
        assert np.abs(got - plain).max() <= 1e-4 * np.abs(plain).max()


def _ncsn_conv_classes():
    """(C_in, C_out, dilation) of each 3x3 conv of the v1 NCSN forward (192
    filters): 74 of its 75 convs, the other one 1x1."""
    from audiosourcesep_tpu_torch import nn as tnn
    from audiosourcesep_tpu_torch.models.ncsn import get_score_model
    m = get_score_model("v1", (96, 64, 1), 192, 10)
    convs = [c for c in m.modules() if isinstance(c, tnn.Conv2d)]
    assert len(convs) == 75
    return [(c.kernel.shape[1], c.kernel.shape[0], c.dilation)
            for c in convs if c.kernel.shape[2:] == (3, 3)]


def test_f32_path_picks_its_path_for_every_class():
    """The thin paths take five of Glow's six coupling classes (2/4 -> 512
    in, 512 -> 4/8/16 out), the NCSN's begin_conv and end_conv (both
    forwards: 1 -> 192, 192 -> 1) and Flow++'s 3 -> 96; every other class,
    dilated ones included, stays on the wide kernel, Glow's 8 -> 512 and
    Flow++'s 6/12 -> 32/96 too (the wide kernel was the faster there)."""
    import chip_smoke
    thin_in = {(2, 512), (4, 512), (1, 192), (3, 96)}
    thin_out = {(512, 4), (512, 8), (512, 16), (192, 1)}
    ncsn = [(30, 96, 64, cin, cout, d) for cin, cout, d in
            _ncsn_conv_classes()]
    assert len(ncsn) == 74
    got = {}
    for classes, batch in ((chip_smoke.GLOW_CLASSES, chip_smoke.BATCH),
                           (chip_smoke.IMAGE_CLASSES, chip_smoke.IMG_BATCH),
                           (chip_smoke.FLOWPP_CLASSES,
                            chip_smoke.FLOWPP_BATCH)):
        for h, w, cin, cout in classes:
            got[(batch, h, w, cin, cout, 1)] = twino.f32_path(
                (batch, h, w, cin), cout)
    for key in ncsn:
        got[key] = twino.f32_path(key[:4], key[4], key[5])
    for (_, _, _, cin, cout, _), path in got.items():
        want = ("thin_in" if (cin, cout) in thin_in else "thin_out"
                if (cin, cout) in thin_out else "wide")
        assert path == want, (cin, cout)
    paths = [twino.f32_path(key[:4], key[4], key[5]) for key in ncsn]
    assert (paths.count("thin_in"), paths.count("thin_out")) == (1, 1)
    # C_in past 4 and not a multiple of 4, or C_out past 16: wide; thin_in
    # takes grids of more than 512 tiles (the image Glow's 16x16 2->512 at
    # 8 images has 512: wide; Glow's 24x16 4->512 at 6 frames 576)
    assert twino.f32_path((8, 16, 16, 2), 512) == "wide"
    assert twino.f32_path((6, 24, 16, 4), 512) == "thin_in"
    assert twino.f32_path((2, 8, 8, 5), 4) == "wide"
    assert twino.f32_path((2, 8, 8, 8), 512) == "wide"
    assert twino.f32_path((2, 8, 8, 16), 17) == "wide"


@pytest.mark.parametrize("shape,cout,geometry,idle", [
    ((30, 48, 32, 2), 512, (1, 4, 8, 1, 4), 0),
    ((30, 48, 32, 512), 4, (1, 8, 8, 2, 4), 0),
    ((30, 24, 16, 4), 512, (1, 4, 8, 1, 4), 0),
    ((30, 24, 16, 512), 8, (1, 4, 8, 4, 4), 0),
    ((30, 12, 8, 512), 16, (2, 2, 4, 8, 4), 0),
    ((30, 96, 64, 1), 192, (1, 4, 8, 1, 3), 0),
    ((30, 96, 64, 192), 1, (1, 8, 8, 2, 4), 0),
    ((50, 32, 32, 192), 1, (1, 8, 8, 2, 4), 0),
    ((64, 32, 16, 3), 96, (1, 4, 8, 2, 3), 0)])
def test_thin_geometry_fills_the_classes(shape, cout, geometry, idle):
    """The box the wrapper picks leaves no tile slot idle at the Glow,
    NCSN and Flow++ thin classes; thin_out's cluster gives every Glow class
    more blocks than the 132 SMs (the 12x8 grid, 720 tiles: 45 boxes x 8)
    and its boxes fit three blocks' shared memory on an SM and their x
    pieces in a thread's 8; thin_in's blocks are 4 channel warps (512
    channels) or 3 (192, 96), and 2 tile warps where C_out has at most 3
    groups of 32 channels."""
    path = twino.f32_path(shape, cout)
    got = twino._thin_geometry(shape, cout, 1, path, H100_SMS)
    assert got == geometry
    nimg, trb, tcb, split, cwarps = got
    b, h, w, cin = shape
    tiles = nimg * trb * tcb
    slots = (-(-b // nimg) * nimg * -(-(h // 2) // trb) * trb
             * -(-(w // 2) // tcb) * tcb)
    assert slots - b * (h // 2) * (w // 2) == idle
    px = nimg * (2 * trb + 2) * (2 * tcb + 2)
    if path == "thin_in":
        assert cwarps == twino._thin_in_channel_warps(cout)
        assert tiles == twino.THIN_IN_TILES
        return
    cb, g, co, kc, pixw = twino._thin_out_channels(cin, cout)
    assert tiles * 2 * g == twino.THIN_NT
    assert cwarps == twino.THIN_NT // 32
    if cin == 512:
        assert slots // tiles * split > H100_SMS
    assert -(-px * kc // 4 // twino.THIN_NT) <= twino.THIN_MAXPIECE
    words = max(twino.THIN_STAGES * (px * pixw + kc * 16 * co),
                tiles * (16 * co + 4))
    assert 3 * 4 * words <= 228 * 1024


def test_thin_slab_reads_are_free_of_bank_conflicts():
    """A quarter warp (8 lanes, consecutive tiles) reads one 16-byte slot
    part each of 8 different 16-byte bank groups, for every box shape the
    wrapper picks above and every patch pixel: the slot pitch PIXW is an
    odd number of 16-byte units and a row's even and odd columns are
    apart."""
    for tcb, trb, pixw in ((4, 2, 12), (8, 4, 12), (16, 8, 12), (8, 4, 4),
                           (4, 8, 4), (32, 4, 12)):
        sc, hh = 2 * tcb + 2, tcb + 1
        t = np.arange(32)
        tr, tc = (t // tcb) % trb, t % tcb
        for i in range(4):
            for jj in range(4):
                slot = ((2 * tr + i) * sc + (jj & 1) * hh + tc + (jj >> 1))
                unit = slot * pixw // 4 % 8
                for q in range(4):
                    assert len(set(unit[8 * q:8 * q + 8])) == 8, (tcb, trb)


def _thin_slab_units(box, pixw, tpb):
    """The 16-byte bank group (of 8) that each lane of a warp reads at
    each of a patch's 16 pixels on thin_out's slab, [16][32]."""
    nimg, trb, tcb = box
    sr, sc, hh = 2 * trb + 2, 2 * tcb + 2, tcb + 1
    t = np.arange(32) % tpb
    im, tr, tc = t // (tcb * trb), (t // tcb) % trb, t % tcb
    return np.array([((im * sr + 2 * tr + i) * sc + (jj & 1) * hh + tc
                      + (jj >> 1)) * pixw // 4 % 8
                     for i in range(4) for jj in range(4)])


@pytest.mark.parametrize("batch,classes", [(8, "GLOW_CLASSES"),
                                           (6, "GLOW_CLASSES"),
                                           (8, "IMAGE_GLOW_CLASSES"),
                                           (2, "IMAGE_GLOW_CLASSES")])
def test_thin_geometry_at_the_glow_separations_chunks(batch, classes):
    """The Glow separations score in chunks of 8 frames (the last chunk of
    30 frames 6, of 50 images 2): at each thin class of such a chunk the
    box leaves no tile slot idle, unless the grid has fewer tiles than a
    box (the image Glow's 4x4 512->16 at 2 images: 8 tiles, a box of 16);
    a grid 2 tiles wide takes a box 2 tiles wide, whose slab reads meet at
    most two lanes of a quarter warp in one bank group; wider boxes read
    without bank conflicts. The box fits a thread's x pieces and three
    blocks' shared memory on an SM."""
    import chip_smoke
    for h, w, cin, cout in getattr(chip_smoke, classes):
        shape = (batch, h, w, cin)
        path = twino.f32_path(shape, cout)
        if path == "wide":
            assert (cin, cout) == (8, 512) or (
                cin <= 4 and batch * h * w // 4 <= twino.THIN_IN_MIN_TILES)
            continue
        nimg, trb, tcb, split, _ = twino._thin_geometry(shape, cout, 1, path,
                                                        H100_SMS)
        tiles, grid = nimg * trb * tcb, batch * (h // 2) * (w // 2)
        slots = (-(-batch // nimg) * nimg * -(-(h // 2) // trb) * trb
                 * -(-(w // 2) // tcb) * tcb)
        assert slots - grid == max(tiles - grid, 0), (shape, cout)
        if grid >= tiles:
            assert tcb == 2 if w // 2 == 2 else tcb >= 4
        if path == "thin_in":
            # 48x32: boxes of 32 tiles; 24x16 (576 or 768 tiles): of 8
            assert tiles == (32 if h == 48 else 8)
            continue
        cb, g, co, kc, pixw = twino._thin_out_channels(cin, cout)
        assert tiles * 2 * g == twino.THIN_NT and split <= cin // kc
        px = nimg * (2 * trb + 2) * (2 * tcb + 2)
        assert -(-px * kc // 4 // twino.THIN_NT) <= twino.THIN_MAXPIECE
        words = max(twino.THIN_STAGES * (px * pixw + kc * 16 * co),
                    tiles * (16 * co + 4))
        assert 4 * words <= twino.THIN_OUT_SMEM_MAX
        units = _thin_slab_units((nimg, trb, tcb), pixw, tiles)
        most = max(np.bincount(u[8 * q:8 * q + 8], minlength=8).max()
                   for u in units for q in range(4))
        assert most == (2 if tcb < 4 else 1), (shape, cout, tcb)


def test_thin_limits_are_the_cuda_sources():
    """The wrapper's copies of csrc/winograd_thin.cu's limits (the box and
    the ring it fits, the channels each path takes) are the source's."""
    import pathlib
    import re
    src = (pathlib.Path(twino.__file__).parent.parent / "csrc" /
           "winograd_thin.cu").read_text()
    limit = {m[0]: int(m[1]) for m in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (limit["NT"], limit["MAXPIECE"], limit["MAXSTAGE"]) == \
        (twino.THIN_NT, twino.THIN_MAXPIECE, twino.THIN_STAGES)
    assert (limit["MAXC"], limit["MAXCOUT"]) == \
        (twino.THIN_IN_MAX_CIN, twino.THIN_OUT_MAX_COUT)
    assert limit["MINB"] == twino.THIN_OUT_BLOCKS_PER_SM[4]
    assert twino.THIN_IN_TILES <= 64         # the C entry's thin_in limit


def test_thin_paths_refuse_what_they_do_not_take():
    assert twino._thin_eligible((2, 8, 8, 4), 512, "thin_in")
    assert not twino._thin_eligible((2, 8, 8, 5), 4, "thin_in")
    assert twino._thin_eligible((2, 8, 8, 512), 16, "thin_out")
    assert not twino._thin_eligible((2, 8, 8, 512), 17, "thin_out")
    assert not twino._thin_eligible((2, 8, 8, 510), 4, "thin_out")
    assert not twino._thin_eligible((2 ** 20, 64, 64, 4), 4, "thin_in")
    assert twino.f32_path((2 ** 20, 64, 64, 4), 4) == "wide"
