"""The port's CUDA kernels on a card (marker ``cuda``; they skip without
one). This file imports no JAX, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import contextlib

import pytest
import torch
import torch.nn.functional as F

from audiosourcesep_tpu_torch import nn
from audiosourcesep_tpu_torch.bijectors.mixlogcdf import (mixlog_inv_cdf,
                                                          mixlog_logcdf)
from audiosourcesep_tpu_torch.models import (build_flowpp, build_glow,
                                             build_realnvp)
from audiosourcesep_tpu_torch.models.ncsn import (dsm_loss, get_score_model,
                                                  get_sigmas)
from audiosourcesep_tpu_torch.ops import inversion
from audiosourcesep_tpu_torch.ops import winograd as W
from audiosourcesep_tpu_torch.ops.stft import istft, stft
from audiosourcesep_tpu_torch.training import (init_train_state,
                                               make_flow_train_step,
                                               make_ncsn_train_step,
                                               setup_optimizer)

pytestmark = pytest.mark.cuda

# kernel vs plain version: (max|err| / max|plain|, mean|err| / mean|plain|,
# max|err| vs F.conv2d / max|plain|). f32 differs only in summation order.
# The bf16 kernel rounds U and V to bf16 as the JAX Pallas kernel does, and
# that kernel needs this much itself: test_torch_winograd.py's
# test_bf16_pallas_kernel_within_card_tolerance pins it under (2e-2, 1e-2).
TOL = {torch.float32: (1e-4, 1e-4, 2e-4), torch.bfloat16: (2e-2, 1e-2, 3e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, cout, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    k = torch.randn(3, 3, shape[-1], cout, device="cuda", generator=g) * 0.1
    return x, k


# ragged shapes: tiles not a multiple of the blocks' 4 x 8 rectangle (W = 2,
# 6), C_in not a multiple of the chunks (1, 3, 5, 12, 17, 40), C_out not a
# multiple of 4, 8 or of the 64-channel block (1, 7, 33, 65, 100, 200), 33 x
# 1 and 7 x 5 tiles at batch 1 (the f32 block owns 32); then full widths
@pytest.mark.parametrize("shape,cout", [((3, 12, 10, 5), 7),
                                        ((1, 14, 10, 3), 65),
                                        ((1, 2, 66, 12), 100),
                                        ((1, 6, 34, 8), 4),
                                        ((2, 16, 8, 40), 33),
                                        ((1, 2, 2, 1), 1),
                                        ((2, 8, 6, 17), 64),
                                        ((2, 10, 2, 24), 200),
                                        ((2, 16, 12, 192), 192),
                                        ((1, 8, 8, 384), 384),
                                        ((2, 8, 8, 192), 384),
                                        # the image NCSN's classes at
                                        # 32x32 and 16x16 (192 filters)
                                        ((2, 32, 32, 1), 192),
                                        ((2, 32, 32, 192), 384),
                                        ((2, 16, 16, 384), 192),
                                        ((2, 32, 32, 192), 1),
                                        # Flow++'s at 32x16, 16x16, 16x8
                                        # (96 filters, CIFAR-10)
                                        ((2, 32, 16, 3), 96),
                                        ((2, 32, 16, 192), 96),
                                        ((2, 32, 16, 96), 294),
                                        ((2, 32, 16, 64), 64),
                                        ((2, 16, 16, 96), 588),
                                        ((2, 16, 8, 12), 96),
                                        ((2, 16, 8, 96), 1176)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda, shape, cout, dtype):
    x, k = _inputs(shape, cout, dtype)
    before = W.launch_count
    name = W.KERNELS[dtype]
    before_mine = W.launch_counts[name]
    got = W.winograd_conv2d(x, k)
    assert W.launch_count == before + 1
    assert W.launch_counts[name] == before_mine + 1
    assert got.dtype == dtype and got.shape == (*shape[:3], cout)
    tol_max, tol_mean, tol_conv = TOL[dtype]
    want = W.winograd_conv2d_reference(x, k).float()
    err = (got.float() - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()
    conv = F.conv2d(x.permute(0, 3, 1, 2).float(),
                    k.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    assert (got.float() - conv).abs().max().item() \
        <= tol_conv * conv.abs().max().item()


# one case per producer path of the bf16 kernel: x and U by TMA (C_in a
# multiple of 8; C_out any, U's rows padded to 8: end_conv's 1, 33), both
# by plain loads (C_in not a multiple of 8: begin_conv's 1, 12, ragged);
# each launch counted once, under its path
@pytest.mark.parametrize("shape,cout,path", [((2, 16, 16, 64), 64, "tma"),
                                             ((2, 16, 16, 192), 1, "tma"),
                                             ((2, 16, 8, 40), 33, "tma"),
                                             ((2, 16, 16, 1), 192, "plain"),
                                             ((2, 16, 16, 12), 40, "plain"),
                                             ((2, 12, 10, 5), 7, "plain")])
def test_bf16_kernel_paths_and_their_launch_counts(cuda, shape, cout, path):
    x, k = _inputs(shape, cout, torch.bfloat16)
    u = W.transform_weights(k).bfloat16()
    assert W.bf16_path(x) == path
    before, paths = dict(W.launch_counts), dict(W.bf16_path_counts)
    got = W._winograd_cuda(x, u).float()
    name = W.KERNELS[torch.bfloat16]
    assert W.launch_counts == {n: c + (n == name) for n, c in before.items()}
    assert W.bf16_path_counts == {n: c + (n == path)
                                  for n, c in paths.items()}
    want = W.winograd_conv2d_reference(x, k).float()
    tol_max, tol_mean, _ = TOL[torch.bfloat16]
    err = (got - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()


def _no_fallback(*args, **kwargs):
    raise AssertionError("the CUDA path fell back to cuDNN or the plain "
                         "version")


def test_bf16_kernel_refuses_and_does_not_fall_back(cuda, monkeypatch):
    # d = 8, past TMA's element stride of 8: the hand-written kernel
    # computes it in one launch on its TMA path, with no phase copy, no
    # cuDNN conv and no plain version in the way
    x, k = _inputs((1, 32, 32, 16), 16, torch.bfloat16)
    want = W.dilated_winograd_conv2d_reference(x, k, 8).float()
    name = W.KERNELS[torch.bfloat16]
    before, paths = dict(W.launch_counts), dict(W.bf16_path_counts)
    with monkeypatch.context() as mp:
        for fn in ("_to_phases", "_from_phases", "winograd_conv2d_reference",
                   "dilated_winograd_conv2d_reference"):
            mp.setattr(W, fn, _no_fallback)
        mp.setattr(F, "conv2d", _no_fallback)
        got = W.dilated_winograd_conv2d(x, k, 8).float()
    assert W.launch_counts == {n: c + (n == name) for n, c in before.items()}
    assert W.bf16_path_counts == {n: c + (n == "tma")
                                  for n, c in paths.items()}
    tol_max, tol_mean, _ = TOL[torch.bfloat16]
    err = (got - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()
    # a call that the JAX dilated_winograd_conv2d refuses too (H = 24 does
    # not divide by 2d = 16) raises, and nothing runs
    x, k = _inputs((1, 24, 32, 16), 16, torch.bfloat16)
    u = W.transform_weights(k).bfloat16()
    before = dict(W.launch_counts)
    with pytest.raises(ValueError, match="divisible by 2d"):
        W.dilated_winograd_conv2d(x, k, 8)
    with pytest.raises(ValueError, match="divisible by 2d"):
        W._winograd_cuda(x, u, 8)
    assert W.launch_counts == before
    # the kernel itself refuses a TMA load of x that TMA cannot address
    # (C_in 12; C_in 24 above d = 4, not whole 16-channel chunks): an error
    # code, and y is left as it was
    from audiosourcesep_tpu_torch.kernels.build import load_library
    for cin, d in ((12, 1), (24, 8)):
        x, k = _inputs((1, 16, 16, cin), 16, torch.bfloat16)
        u = W.transform_weights(k).bfloat16()
        y = torch.full((1, 16, 16, 16), 7.0, device=cuda,
                       dtype=torch.bfloat16)
        err = load_library().winograd_f23_fwd_bf16(
            x.data_ptr(), u.data_ptr(), y.data_ptr(), 1, 16, 16, cin, 16, 16,
            d, 1, 8, 1, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err != 0 and bool((y == 7.0).all()), (cin, d)


# the f32 kernel's paths at Glow's six coupling classes (batch 2; 8->512
# stays wide, and so does 24x16 4->512 at 192 tiles), NCSN's begin_conv
# 1->192 and end_conv 192->1 and Flow++'s 3->96 (batch 8), then the phase
# grids in place (d = 2) and ragged channels (C_out 5, C_in 3), then the
# image Glow's 4x4 512->16 (a box 2 tiles wide) at the separation's chunk
# of 8 and its last chunk of 2, Glow's 24x16 4->512 at a chunk of 8 (boxes
# of 8 tiles) and the image Glow's 16x16 2->512 at 8 (512 tiles: wide);
# each launch counted once under its path, with both plain versions and
# F.conv2d made to fail
@pytest.mark.parametrize("shape,cout,d,path", [
    ((2, 48, 32, 2), 512, 1, "thin_in"),
    ((2, 48, 32, 512), 4, 1, "thin_out"),
    ((2, 24, 16, 4), 512, 1, "wide"),
    ((2, 24, 16, 512), 8, 1, "thin_out"),
    ((2, 12, 8, 8), 512, 1, "wide"),
    ((2, 12, 8, 512), 16, 1, "thin_out"),
    ((2, 96, 64, 192), 1, 1, "thin_out"),
    ((2, 96, 64, 1), 192, 1, "thin_in"),
    ((8, 32, 16, 3), 96, 1, "thin_in"),
    ((2, 16, 24, 64), 8, 2, "thin_out"),
    ((6, 16, 24, 3), 16, 2, "thin_in"),
    ((1, 12, 8, 36), 5, 1, "thin_out"),
    ((8, 4, 4, 512), 16, 1, "thin_out"),
    ((2, 4, 4, 512), 16, 1, "thin_out"),
    ((8, 24, 16, 4), 512, 1, "thin_in"),
    ((8, 16, 16, 2), 512, 1, "wide")])
def test_f32_thin_paths_and_their_launch_counts(cuda, monkeypatch, shape,
                                                cout, d, path):
    x, k = _inputs(shape, cout, torch.float32, seed=d)
    k = k * (0.1 * shape[-1]) ** -0.5
    want = (W.winograd_conv2d_reference(x, k) if d == 1 else
            W.dilated_winograd_conv2d_reference(x, k, d))
    u = W.transform_weights(k)
    assert W.f32_path(x.shape, cout, d) == path
    name = W.KERNELS[torch.float32]
    before, paths = dict(W.launch_counts), dict(W.f32_path_counts)
    with monkeypatch.context() as mp:
        for fn in ("_to_phases", "_from_phases", "winograd_conv2d_reference",
                   "dilated_winograd_conv2d_reference"):
            mp.setattr(W, fn, _no_fallback)
        mp.setattr(F, "conv2d", _no_fallback)
        got = W._winograd_cuda(x, u, d)
    torch.cuda.synchronize()
    assert W.launch_counts == {n: c + (n == name) for n, c in before.items()}
    assert W.f32_path_counts == {n: c + (n == path)
                                 for n, c in paths.items()}
    assert got.shape == (*shape[:3], cout)
    tol_max, tol_mean, _ = TOL[torch.float32]
    err = (got - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()
    # the wide design, forced on the same conv, computes the same
    wide = W._winograd_cuda(x, u, d, path="wide")
    assert W.f32_path_counts["wide"] == paths["wide"] + 1 + (path == "wide")
    assert (wide - want).abs().max().item() \
        <= tol_max * want.abs().max().item()
    # where the wrapper keeps a thin conv wide (a small grid), the thin
    # design forced on it computes the same
    thin = [p for p in ("thin_in", "thin_out")
            if W._thin_eligible(x.shape, cout, p)]
    if path == "wide" and thin:
        forced = W._winograd_cuda(x, u, d, path=thin[0])
        assert (forced - want).abs().max().item() \
            <= tol_max * want.abs().max().item()


@pytest.mark.parametrize("shape,cout", [((30, 48, 32, 512), 4),
                                        ((8, 12, 8, 512), 16),
                                        ((30, 96, 64, 192), 1),
                                        ((4, 48, 32, 2), 512)])
def test_f32_thin_paths_are_the_same_from_run_to_run(cuda, shape, cout):
    """thin_out sums the cluster's partial Ms in rank order, so two runs
    (with other work on the card between them) are bitwise equal."""
    x, k = _inputs(shape, cout, torch.float32, seed=5)
    u = W.transform_weights(k)
    first = W._winograd_cuda(x, u)
    W._winograd_cuda(x.flip(0).contiguous(), u)
    second = W._winograd_cuda(x, u)
    assert torch.equal(first, second)


def test_f32_thin_path_refuses_and_does_not_fall_back(cuda):
    # a path forced on a conv it does not take raises before any launch
    x, k = _inputs((2, 8, 8, 64), 32, torch.float32)
    u = W.transform_weights(k)
    before, paths = dict(W.launch_counts), dict(W.f32_path_counts)
    for path in ("thin_in", "thin_out", "narrow"):
        with pytest.raises(ValueError, match="path"):
            W._winograd_cuda(x, u, path=path)
    with pytest.raises(ValueError, match="f32 kernel"):
        W._winograd_cuda(x.bfloat16(), u.bfloat16(), path="wide")
    assert W.launch_counts == before and W.f32_path_counts == paths
    # the C entry refuses it too (C_in 64 on thin_in, C_out 32 on
    # thin_out, a box of the wrong size, a cluster past C_in's chunks):
    # an error code, and y is left as it was
    from audiosourcesep_tpu_torch.kernels.build import load_library
    stream = torch.cuda.current_stream().cuda_stream
    # (and C_in 8 on thin_in, and a thin_in block of more than 512 threads)
    for cin, cout, path, geometry in ((64, 4, 0, (1, 4, 8, 1, 4)),
                                      (64, 32, 1, (1, 8, 8, 1, 4)),
                                      (64, 4, 1, (1, 4, 8, 1, 4)),
                                      (64, 4, 1, (1, 8, 8, 16, 4)),
                                      (8, 64, 0, (1, 4, 8, 1, 4)),
                                      (4, 64, 0, (1, 4, 8, 5, 4))):
        x, k = _inputs((2, 8, 8, cin), cout, torch.float32)
        u = W.transform_weights(k)
        y = torch.full((2, 8, 8, cout), 7.0, device=cuda)
        err = load_library().winograd_f23_fwd_f32_thin(
            x.data_ptr(), u.data_ptr(), y.data_ptr(), 2, 8, 8, cin, cout, 1,
            path, *geometry, stream)
        torch.cuda.synchronize()
        assert err != 0 and bool((y == 7.0).all()), (cin, cout, path)


def test_f32_thin_out_copies_x_that_is_not_16_byte_aligned(cuda):
    # the wrapper hands thin_out an aligned copy of x; the C entry refuses
    # x that is not aligned (an error code, y left as it was)
    x, k = _inputs((2, 12, 8, 64), 4, torch.float32)
    u = W.transform_weights(k)
    buf = torch.empty(x.numel() + 1, device=cuda)
    xm = buf[1:].view(x.shape)
    xm.copy_(x)
    assert xm.data_ptr() % 16 and W.f32_path(xm.shape, 4) == "thin_out"
    paths = dict(W.f32_path_counts)
    got = W._winograd_cuda(xm, u)
    assert W.f32_path_counts["thin_out"] == paths["thin_out"] + 1
    want = W.winograd_conv2d_reference(x, k)
    assert (got - want).abs().max().item() \
        <= TOL[torch.float32][0] * want.abs().max().item()
    from audiosourcesep_tpu_torch.kernels.build import load_library
    y = torch.full((2, 12, 8, 4), 7.0, device=cuda)
    geometry = W._thin_geometry(tuple(x.shape), 4, 1, "thin_out",
                                W._sm_count(x.device.index))
    err = load_library().winograd_f23_fwd_f32_thin(
        xm.data_ptr(), u.data_ptr(), y.data_ptr(), 2, 12, 8, 64, 4, 1, 1,
        *geometry, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0 and bool((y == 7.0).all())


def test_bf16_kernel_takes_bf16_weights_only(cuda):
    x, k = _inputs((1, 4, 4, 8), 8, torch.bfloat16)
    with pytest.raises(TypeError):
        W._winograd_cuda(x, W.transform_weights(k))          # f32 U
    y = W._winograd_cuda(x, W.transform_weights(k).bfloat16())
    torch.testing.assert_close(y, W.winograd_conv2d(x, k), atol=0, rtol=0)


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, k = _inputs((1, 4, 4, 3), 2, torch.float32)
    u = W.transform_weights(k)
    with pytest.raises(ValueError):
        W._winograd_cuda(x[:, :3, :3].contiguous(), u)      # odd H, W
    with pytest.raises(ValueError):
        W._winograd_cuda(x.permute(0, 2, 1, 3), u)           # not contiguous
    with pytest.raises(TypeError):
        W._winograd_cuda(x.half(), u)
    with pytest.raises(ValueError):
        W._winograd_cuda(x, u[:, :2])                        # C_in mismatch


def test_gradient_through_the_kernel(cuda):
    x, k = _inputs((2, 6, 8, 4), 5, torch.float32)
    xa, ka = x.clone().requires_grad_(), k.clone().requires_grad_()
    (W.winograd_conv2d(xa, ka) ** 2).sum().backward()
    xb = x.permute(0, 3, 1, 2).clone().requires_grad_()
    kb = k.permute(3, 2, 0, 1).clone().requires_grad_()
    (F.conv2d(xb, kb, padding=1) ** 2).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad.permute(0, 2, 3, 1),
                               atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(ka.grad, kb.grad.permute(2, 3, 1, 0),
                               atol=1e-3, rtol=1e-3)


def test_routed_forward_matches_cudnn(cuda):
    m = get_score_model("v1", (32, 16, 1), 8, 3).reset_parameters(
        torch.Generator().manual_seed(0)).to(cuda).eval()
    x = torch.rand(2, 32, 16, 1, device=cuda)
    idx = torch.tensor([0, 2], device=cuda)
    with torch.no_grad():
        off = m(x, idx)
        try:
            nn.set_winograd(True)
            before = W.launch_count
            on = m(x, idx)
            assert W.launch_count - before == 64
        finally:
            nn.set_winograd(False)
    torch.testing.assert_close(on, off, atol=2e-4, rtol=1e-4)


def test_routed_conv_follows_in_place_weight_updates(cuda):
    conv = nn.Conv2d(16, 24).to(cuda)
    conv.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.randn(2, 16, 8, 12, device=cuda).bfloat16()
    try:
        nn.set_winograd(True)
        with torch.no_grad():
            before = W.launch_count
            first = conv(x)
            conv.kernel.mul_(-1.0)                   # U must be rebuilt
            second = conv(x)
        assert W.launch_count == before + 2
    finally:
        nn.set_winograd(False)
    torch.testing.assert_close(second - conv.bias.bfloat16()[:, None, None],
                               -(first - conv.bias.bfloat16()[:, None, None]),
                               atol=2e-2, rtol=2e-2)


def _no_phase_copy(*args):
    raise AssertionError("the CUDA path copied the phases")


# ragged channels; the cascade's dilated convs (48x32 384->384: phase grids
# of 12 x 8 tiles at d = 2, 6 x 4 at d = 4); phase grids smaller than one
# block (2 x 2 tiles at d = 2, 1 x 1 at d = 4)
@pytest.mark.parametrize("shape,cout", [((2, 16, 24, 40), 33),
                                        ((2, 48, 32, 384), 384),
                                        ((1, 8, 8, 16), 24)])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dilated_route_matches_plain_version(cuda, monkeypatch, d, dtype,
                                             shape, cout):
    x, k = _inputs(shape, cout, dtype, seed=d)
    want = W.dilated_winograd_conv2d_reference(x, k, d).float()
    name = W.KERNELS[dtype]
    before = dict(W.launch_counts)
    with monkeypatch.context() as mp:
        mp.setattr(W, "_to_phases", _no_phase_copy)
        mp.setattr(W, "_from_phases", _no_phase_copy)
        got = W.dilated_winograd_conv2d(x, k, d)
    # all d*d phases in one launch of this dtype's kernel, counted where
    # _winograd_cuda launches it
    assert W.launch_counts == {n: c + (n == name) for n, c in before.items()}
    assert got.dtype == dtype and got.shape == (*shape[:3], cout)
    tol_max, tol_mean, tol_conv = TOL[dtype]
    err = (got.float() - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()
    conv = F.conv2d(x.permute(0, 3, 1, 2).float(), k.permute(3, 2, 0, 1),
                    padding=d, dilation=d).permute(0, 2, 3, 1)
    assert (got.float() - conv).abs().max().item() \
        <= tol_conv * conv.abs().max().item()


# dilations above 4, which the bf16 kernel's x tensor map reaches through
# 2d-pixel groups: C_in in whole chunks by TMA (odd d = 5, d = 6, 8, 16 and
# 32, whose phase grids are one tile, at the smoke's 96x64 192->192 class),
# other C_in by plain loads
@pytest.mark.parametrize("shape,cout,d,path", [
    ((2, 20, 30, 16), 33, 5, "tma"),
    ((1, 12, 36, 48), 64, 6, "tma"),
    ((2, 16, 32, 32), 40, 8, "tma"),
    ((1, 96, 64, 192), 192, 8, "tma"),
    ((1, 96, 64, 192), 192, 16, "tma"),
    ((1, 64, 64, 16), 16, 32, "tma"),
    ((2, 16, 16, 24), 16, 8, "plain"),
    ((1, 12, 24, 5), 7, 6, "plain")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dilated_route_above_dilation_4_matches_plain_version(
        cuda, monkeypatch, dtype, shape, cout, d, path):
    x, k = _inputs(shape, cout, dtype, seed=d)
    want = W.dilated_winograd_conv2d_reference(x, k, d).float()
    name = W.KERNELS[dtype]
    before, paths = dict(W.launch_counts), dict(W.bf16_path_counts)
    with monkeypatch.context() as mp:
        mp.setattr(W, "_to_phases", _no_phase_copy)
        mp.setattr(W, "_from_phases", _no_phase_copy)
        got = W.dilated_winograd_conv2d(x, k, d)
    assert W.launch_counts == {n: c + (n == name) for n, c in before.items()}
    bf16 = dtype == torch.bfloat16
    assert W.bf16_path_counts == {n: c + (bf16 and n == path)
                                  for n, c in paths.items()}
    assert got.dtype == dtype and got.shape == (*shape[:3], cout)
    tol_max, tol_mean, tol_conv = TOL[dtype]
    err = (got.float() - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()
    conv = F.conv2d(x.permute(0, 3, 1, 2).float(), k.permute(3, 2, 0, 1),
                    padding=d, dilation=d).permute(0, 2, 3, 1)
    assert (got.float() - conv).abs().max().item() \
        <= tol_conv * conv.abs().max().item()


def test_inversion_ops_on_the_card_match_the_cpu(cuda, monkeypatch):
    g = torch.Generator().manual_seed(5)
    mel = 10.0 ** (7.3 * torch.rand(2, 3, 96, 16, generator=g) - 6.0)
    ref = inversion.mel_to_stft(mel.double(), power=1.0)

    def max_rel(got):
        return ((got - ref).abs().max() / ref.abs().max()).item()

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = inversion.mel_to_stft(mel.to(cuda), power=1.0).cpu()
        assert torch.backends.cuda.matmul.allow_tf32
        # the same solve with the f32 scope taken away runs in TF32
        with monkeypatch.context() as mp:
            mp.setattr(inversion, "_full_f32_matmul", contextlib.nullcontext)
            tf32 = inversion.mel_to_stft(mel.to(cuda), power=1.0).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    # full f32 passes the tolerance, TF32 does not: it shows the scoping
    assert max_rel(got) < 1e-3 < max_rel(tf32), (max_rel(got), max_rel(tf32))
    x = torch.randn(3, 512 * 40, generator=g)
    spec = stft(x)
    y = istft(spec.to(cuda), length=x.shape[-1]).cpu()
    torch.testing.assert_close(y, istft(spec, length=x.shape[-1]),
                               atol=1e-5, rtol=1e-5)
    angles = torch.rand(spec.shape, generator=g)
    mag = spec.abs()
    torch.testing.assert_close(
        inversion.griffin_lim(mag.to(cuda), n_iter=4,
                              angles=angles.to(cuda)).cpu(),
        inversion.griffin_lim(mag, n_iter=4, angles=angles),
        atol=1e-4 * mag.max().item(), rtol=1e-3)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16, 24, 16), (2, 384, 12, 8)])
def test_avg_pool_same_gradient_on_the_card(cuda, shape):
    """The CRP's 5x5 pool, channels_last on the card: its gradient against
    float64 on the CPU. (PyTorch 2.11's own CUDA backward of
    ``avg_pool2d(count_include_pad=False)`` lands 1.1 away, relative, on
    channels_last input; ``nn.avg_pool_same`` does not use it.)"""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(*shape, generator=g, dtype=torch.float64)
    w = torch.randn(*shape, generator=g, dtype=torch.float64)
    ref = x.clone().requires_grad_()
    (F.avg_pool2d(ref, 5, 1, 2, count_include_pad=False) * w).sum().backward()
    xc = x.float().to(cuda).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = nn.avg_pool_same(xc, 5)
    (y * w.float().to(cuda)).sum().backward()
    torch.testing.assert_close(y.double().cpu(), F.avg_pool2d(
        x, 5, 1, 2, count_include_pad=False), atol=1e-5, rtol=1e-5)
    err = (xc.grad.double().cpu() - ref.grad).norm() / ref.grad.norm()
    assert err < 1e-6, err

SIGMAS = get_sigmas(1.0, 0.01, 10, "logarithmic")


def _train(device, shape, ngf, batch, steps=1, routed=False, lr=1e-3,
           seed=0):
    """``steps`` Adam steps of a v1 model (same init and draws on any
    device); returns (losses, state)."""
    m = get_score_model("v1", shape, ngf, 10, device=device)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    state = init_train_state(m, setup_optimizer("adam", lr), ema=True)
    step, _ = make_ncsn_train_step(SIGMAS, ema_decay=0.999)
    g = torch.Generator().manual_seed(seed + 1)
    losses = []
    try:
        nn.set_winograd(routed)
        for _ in range(steps):
            x = torch.rand(batch, *shape, generator=g)
            idx = torch.randint(10, (batch,), generator=g)
            noise = torch.randn(batch, *shape, generator=g)
            _, loss = step(state, x.to(device), sigma_idx=idx.to(device),
                           noise=noise.to(device))
            losses.append(float(loss))
    finally:
        nn.set_winograd(False)
    return losses, state


def test_train_step_on_the_card_matches_the_cpu(cuda):
    # f32 with TF32 off: the loss to 1e-5; params to 2e-4 absolute (lr
    # 1e-3: an element whose gradient sits at the f32 noise floor can
    # move by a fraction of lr differently, as against the JAX package)
    l_cpu, cpu = _train("cpu", (32, 16, 1), 8, 4)
    l_gpu, gpu = _train(cuda, (32, 16, 1), 8, 4)
    assert abs(l_gpu[0] - l_cpu[0]) <= 1e-5 * abs(l_cpu[0])
    for name, p in cpu.params.items():
        torch.testing.assert_close(gpu.params[name].detach().cpu(),
                                   p.detach(), atol=2e-4, rtol=0)


def test_routed_full_width_step_matches_cudnn(cuda):
    """One full-width step (192 filters, [96, 64, 1]) with routing on and
    off: the loss and every routed conv kernel's gradient, and 64 launches
    of the f32 kernel per forward."""
    grads = []
    for routed in (False, True):
        m = get_score_model("v1", (96, 64, 1), 192, 10, device=cuda)
        m.reset_parameters(torch.Generator().manual_seed(0))
        g = torch.Generator().manual_seed(1)
        x = torch.rand(4, 96, 64, 1, generator=g).to(cuda)
        idx = torch.randint(10, (4,), generator=g).to(cuda)
        noise = torch.randn(4, 96, 64, 1, generator=g).to(cuda)
        try:
            nn.set_winograd(routed)
            before = dict(W.launch_counts)
            loss = dsm_loss(m, x, torch.as_tensor(SIGMAS, device=cuda),
                            sigma_idx=idx, noise=noise)
            loss.backward()
            launched = {k: W.launch_counts[k] - before[k] for k in before}
        finally:
            nn.set_winograd(False)
        assert launched == {W.KERNELS[torch.float32]: 64 if routed else 0,
                            W.KERNELS[torch.bfloat16]: 0}
        grads.append((loss.item(), {
            n: mod.kernel.grad.clone() for n, mod in m.named_modules()
            if isinstance(mod, nn.Conv2d) and mod.dilation == 1
            and mod.kernel.shape[-1] == 3}))
        del m
    (l_off, g_off), (l_on, g_on) = grads
    # routed vs cuDNN forward: 1e-3 mean-rel (chip_smoke.MODEL_TOL); the
    # loss and each kernel's gradient (L2) to the same
    assert abs(l_on - l_off) <= 1e-3 * abs(l_off)
    assert len(g_on) == 64
    for n, g in g_off.items():
        assert (g_on[n] - g).norm() <= 1e-3 * g.norm(), n


def test_cached_u_follows_the_optimizer_step(cuda, monkeypatch):
    """nn.Conv2d keys its cached U on the kernel's version: after an Adam
    step (foreach on the card) the routed forward of the updated weights
    agrees with cuDNN's; with U kept from before the step it does not."""
    def routed_vs_cudnn():
        _, state = _train(cuda, (32, 16, 1), 8, 4, routed=True, lr=1e-2)
        x = torch.rand(4, 32, 16, 1, device=cuda)
        idx = torch.arange(4, device=cuda)
        with torch.no_grad():
            try:
                nn.set_winograd(True)
                on = state.model(x, idx)
            finally:
                nn.set_winograd(False)
            off = state.model(x, idx)
        return ((on - off).abs().mean() / off.abs().mean()).item()

    assert routed_vs_cudnn() < 1e-5
    real = nn._winograd_weights

    def stale(cache, kernel, hwio, dtype):     # a cache that never refreshes
        return cache["u"] if "u" in cache else real(cache, kernel, hwio,
                                                    dtype)
    monkeypatch.setattr(nn, "_winograd_weights", stale)
    assert routed_vs_cudnn() > 1e-3


def _glow_pair(cuda, n_filters=64):
    """A Glow (L=3, K=4) initialised on the CPU, each coupling's last conv
    drawn small so the couplings do work, and its copy on the card."""
    g = torch.Generator().manual_seed(0)
    mb = torch.rand(4, 96, 64, 1, generator=g) * 120.0 - 100.0
    cfg = dict(L=3, K=4, n_filters=n_filters, learntop=True,
               data_type="melspec")
    cpu = build_glow((96, 64, 1), minibatch=mb, generator=g, **cfg)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "conv3.kernel" in name:
                p.copy_(1e-3 * torch.randn(p.shape, generator=g))
    gpu = build_glow((96, 64, 1), device=cuda, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


def test_glow_score_on_the_card_matches_the_cpu_routed_or_not(cuda):
    """log p and the score of 2 frames (f32, TF32 off) to 1e-4 (L2
    relative), with routing off and on; routed, each forward launches the
    f32 kernel once per coupling 3x3 conv (2 per step)."""
    cpu, gpu = _glow_pair(cuda)
    x = torch.rand(2, 96, 64, 1, generator=torch.Generator().manual_seed(1)
                   ) * 120.0 - 100.0
    lp, score = cpu.log_prob(x).detach(), cpu.score(x)
    for routed in (False, True):
        try:
            nn.set_winograd(routed)
            before = dict(W.launch_counts)
            lp_g, score_g = gpu.log_prob(x.to(cuda)), gpu.score(x.to(cuda))
            launched = {k: W.launch_counts[k] - before[k] for k in before}
        finally:
            nn.set_winograd(False)
        assert launched[W.KERNELS[torch.float32]] == (2 * 2 * 3 * 4
                                                      if routed else 0)
        assert (lp_g.detach().cpu() - lp).norm() <= 1e-4 * lp.norm()
        assert (score_g.cpu() - score).norm() <= 1e-4 * score.norm()


def test_glow_train_step_on_the_card_matches_the_cpu(cuda):
    """One Adamax step at batch 2: the loss to 1e-5, the gradients and the
    params after the step to 1e-3 (L2 over all tensors, relative, as
    chip_smoke.TRAIN_TOL: Adamax's first step moves each weight by about
    lr in the sign of its gradient, so an element whose gradient sits at
    the f32 noise floor can move differently by up to 2 lr)."""
    cpu, gpu = _glow_pair(cuda, 16)
    step, _ = make_flow_train_step()
    g = torch.Generator().manual_seed(2)
    x = torch.rand(2, 96, 64, 1, generator=g) * 120.0 - 100.0
    dq = torch.rand(2, 96, 64, 1, generator=g)
    losses, states = [], []
    for model in (cpu, gpu):
        dev = next(model.parameters()).device
        state = init_train_state(model, setup_optimizer("adamax", 1e-3))
        _, loss = step(state, x.to(dev), dequant=dq.to(dev))
        losses.append(float(loss))
        states.append(state)
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])

    def rel(get):
        cpu, gpu = (torch.cat([get(p).detach().cpu().reshape(-1)
                               for p in st.params.values()])
                    for st in states)
        return float((gpu - cpu).norm() / cpu.norm())

    assert rel(lambda p: p.grad) <= 1e-3
    assert rel(lambda p: p) <= 1e-3


def _to_card(cpu, build, cuda):
    gpu = build(device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    return gpu


def test_realnvp_log_prob_on_the_card_matches_the_cpu(cuda):
    """RealNVP (32 filters, 4 blocks, [32, 32, 1]; its convs stay on
    cuDNN): log p and the inverse of its latent to 1e-4 (L2 relative)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (4, 32, 32, 1), generator=g).float()
    u = torch.rand(x.shape, generator=g)
    cpu = build_realnvp((32, 32, 1), minibatch=x, generator=g)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "conv_out.v" in name:
                p.copy_(1e-2 * torch.randn(p.shape, generator=g))
    gpu = _to_card(cpu, lambda device: build_realnvp((32, 32, 1),
                                                     device=device), cuda)
    with torch.no_grad():
        lp, lp_g = cpu.log_prob(x, u), gpu.log_prob(x.to(cuda), u.to(cuda))
        z = cpu.bijector(x + u)[0]
        back = gpu.sample(z.to(cuda)).cpu()
    assert (lp_g.cpu() - lp).norm() <= 1e-4 * lp.norm()
    assert (back - (x + u)).norm() <= 1e-4 * (x + u).norm()


def test_flowpp_on_the_card_matches_the_cpu_routed_or_not(cuda):
    """A narrow Flow++ on [8, 8, 1] (8 filters, 2 components, one block a
    net, the output convs at 0.1 of their init, where f32 log p is 4.5e-7
    from float64 on the CPU; at this narrow width the unscaled init
    saturates more of the mixture CDFs, where f32 loses accuracy, as the
    next test bounds): log p with the same eps
    to 1e-4 (L2 relative), routing off and on; routed, each log p launches
    the f32 kernel once per 3x3 conv of the flow."""
    cfg = dict(n_components=2, n_blocks_flow=1, n_blocks_dequant=1,
               filters=8, heads=2)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (4, 8, 8, 1), generator=g).float()
    eps = torch.randn(x.shape, generator=g)
    cpu = build_flowpp((8, 8, 1), minibatch=x, generator=g, **cfg)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "conv_out" in name:
                p.mul_(0.1)
    gpu = _to_card(cpu, lambda device: build_flowpp((8, 8, 1),
                                                    device=device, **cfg),
                   cuda)
    n_convs = sum(1 for m in gpu.modules() if isinstance(m, nn.Conv2d))
    with torch.no_grad():
        lp = cpu.log_prob(x, eps)
        for routed in (False, True):
            try:
                nn.set_winograd(routed)
                before = W.launch_counts[W.KERNELS[torch.float32]]
                lp_g = gpu.log_prob(x.to(cuda), eps.to(cuda))
                launched = W.launch_counts[W.KERNELS[torch.float32]] - before
            finally:
                nn.set_winograd(False)
            assert launched == (n_convs if routed else 0)
            assert (lp_g.cpu() - lp).norm() <= 1e-4 * lp.norm()


def test_flowpp_in_float64_on_the_card_matches_the_cpu_at_its_own_init(cuda):
    """The narrow Flow++ above at build_flowpp's own init (output convs
    unscaled, where training starts), routing off: in float64 card and
    CPU agree to 1e-10 (L2 relative), and each device's f32 log p stays
    within 1e-3 of its float64 one, so what f32 loses
    at the mixture CDFs' clip is rounding, not the card's path."""
    cfg = dict(n_components=2, n_blocks_flow=1, n_blocks_dequant=1,
               filters=8, heads=2)
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (4, 8, 8, 1), generator=g).float()
    eps = torch.randn(x.shape, generator=g)
    cpu = build_flowpp((8, 8, 1), minibatch=x, generator=g, **cfg)
    gpu = _to_card(cpu, lambda device: build_flowpp((8, 8, 1),
                                                    device=device, **cfg),
                   cuda)
    lps = {}
    with torch.no_grad():
        for dev, m in (("card", gpu), ("cpu", cpu)):
            where = torch.device(cuda if dev == "card" else "cpu")
            for dtype in (torch.float32, torch.float64):
                m.to(dtype)
                lps[dev, dtype] = m.log_prob(
                    x.to(where, dtype), eps.to(where, dtype)).cpu().double()

    def rel(a, b):
        return float((lps[a] - lps[b]).norm() / lps[b].norm())

    assert rel(("card", torch.float64), ("cpu", torch.float64)) <= 1e-10
    for dev in ("card", "cpu"):
        assert rel((dev, torch.float32), (dev, torch.float64)) <= 1e-3


def test_mixlog_inv_cdf_round_trip_on_the_card(cuda):
    """The 64-step bisection on the card: x back from its CDF to 1e-3."""
    g = torch.Generator().manual_seed(2)
    logits, means = torch.randn(4096, 32, generator=g), \
        2 * torch.randn(4096, 32, generator=g)
    log_scales = -torch.rand(4096, 32, generator=g) - 0.2
    x = torch.linspace(-3, 3, 4096)
    y = torch.exp(mixlog_logcdf(x, logits, means, log_scales))
    got = mixlog_inv_cdf(*(t.to(cuda) for t in (y, logits, means,
                                                log_scales)))
    assert (got.cpu() - x).abs().max() <= 1e-3


# ---------------------------------------------------------------------------
# multi-process runs on the card (torch.distributed)
# ---------------------------------------------------------------------------

def _flat_params(model):
    from audiosourcesep_tpu_torch.training.checkpoint import (_flatten,
                                                              params_to_jax)
    return _flatten(params_to_jax(model.state_dict()))


def _bilinear_matrix(n_out: int, n_in: int, device) -> torch.Tensor:
    """``[n_out, n_in]`` weights of PyTorch's bilinear resize along one
    axis (``align_corners=False``: half-pixel centres, the source index
    clamped at 0)."""
    src = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * n_in / n_out
           - 0.5).clamp(min=0.0)
    i0 = src.floor().long().clamp(max=n_in - 1)
    lam = src - i0
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    m[rows, i0] += 1.0 - lam
    m[rows, (i0 + 1).clamp(max=n_in - 1)] += lam
    return m.float().to(device)


def _resize_bilinear_by_matmuls(x: torch.Tensor, size) -> torch.Tensor:
    """``nn.resize_bilinear`` as two products with the interpolation
    matrices, whose backward is a product too: deterministic on the card,
    where ``F.interpolate``'s bilinear backward adds with atomics and has
    no deterministic kernel."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    mh = _bilinear_matrix(size[0], x.shape[2], x.device).to(x.dtype)
    mw = _bilinear_matrix(size[1], x.shape[3], x.device).to(x.dtype)
    return torch.einsum("oh,pw,nchw->ncop", mh, mw, x)


def test_nccl_world_size_one_train_step_equals_the_plain_step(
        cuda, tmp_path, monkeypatch):
    """A process group of one rank over NCCL: the step with its gradients
    all-reduced through NCCL (a sum over one rank, divided by one) against
    the step without a group, from the same init on the same draws. The
    asserts: the NCCL backend on the card, the group left afterwards, the
    two losses within 1e-6 of each other (relative), and every parameter
    after Adam's first step within 1e-5 (absolute; 1% of the lr).

    Both steps run deterministic algorithms (cuDNN's deterministic convs,
    the deterministic index_put behind the embeddings' gradient,
    ``CUBLAS_WORKSPACE_CONFIG``), so they agree bit for bit: without that,
    cuDNN's weight gradients and the scatters change their order of
    summation from run to run, and Adam's first step, which divides each
    gradient by its own size, moves a weight whose gradient sits at the
    f32 noise floor by up to the whole lr. The MSF blocks' bilinear resize
    runs as two matrix products here (``_resize_bilinear_by_matmuls``,
    checked against ``F.interpolate`` first): ``F.interpolate``'s bilinear
    backward has no deterministic kernel. Every setting is restored
    afterwards."""
    import copy

    import torch.distributed as dist

    from audiosourcesep_tpu_torch.parallel import (Layout, init_distributed,
                                                   shutdown)
    h = torch.randn(2, 3, 4, 8, device=cuda)
    torch.testing.assert_close(_resize_bilinear_by_matmuls(h, (8, 16)),
                               nn.resize_bilinear(h, (8, 16)), atol=1e-6,
                               rtol=1e-6)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    monkeypatch.setattr(nn, "resize_bilinear", _resize_bilinear_by_matmuls)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        sigmas = get_sigmas(1.0, 0.01, 4)
        model = get_score_model("v1", (16, 16, 1), 8, 4, device=cuda)
        model.reset_parameters(torch.Generator().manual_seed(0))
        other = copy.deepcopy(model)
        x = torch.rand((4, 16, 16, 1), device=cuda)
        dev = init_distributed(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                               device="cuda")
        try:
            assert dist.get_backend() == "nccl" and dev.type == "cuda"
            losses, states = [], []
            for m, layout in ((model, Layout()), (other, None)):
                state = init_train_state(m, setup_optimizer("adam", 1e-3))
                step, _ = make_ncsn_train_step(sigmas, layout=layout)
                gen = torch.Generator(device=cuda).manual_seed(1)
                state, loss = step(state, x, gen)
                losses.append(float(loss))
                states.append(state)
        finally:
            shutdown()
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
        torch.backends.cudnn.benchmark = saved[3]
    assert not dist.is_initialized()
    assert abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[1])
    for name, p in states[0].params.items():
        q = states[1].params[name]
        assert float((p - q).abs().max()) <= 1e-5, name


def test_two_rank_source_sharded_anneal_on_one_card_equals_one_process(
        cuda):
    """Two gloo ranks sharing cuda:0, one NCSN prior each (the mixing
    gathered over the pair each step), against one process with both
    priors, on the same draws, TF32 off in both: each model sees the
    same frames, so the result agrees to 1e-6 (bitwise expected)."""
    from audiosourcesep_tpu_torch.parallel.workers import run_ranks
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     ncsn_score_fn)
    L, T, N, shape = 2, 2, 3, (16, 16, 1)
    models = []
    for seed in (1, 2):
        m = get_score_model("v1", shape, 8, L, device=cuda)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        models.append(m.eval())
    g = torch.Generator().manual_seed(3)
    mixed, x0 = torch.rand((N, *shape), generator=g), \
        torch.rand((2, N, *shape), generator=g)
    noise = torch.randn((L, T, 2, N, *shape), generator=g)
    cfg = dict(T=T, delta=2e-3, data_type="melspec", scale="dB")
    sigmas = get_sigmas(1.0, 0.1, L)
    want, want_traj = basis_separate_per_level(
        ncsn_score_fn(models), mixed.to(cuda), x0.to(cuda), sigmas,
        config=BasisConfig(**cfg),
        noise_fn=lambda level, step: noise[level, step])
    out = run_ranks(dict(task="basis", kind="ncsn", n_sources=2,
                         shape=shape, n_filters=8, num_classes=L,
                         params=[_flat_params(m) for m in models],
                         sigmas=sigmas, mixed=mixed.numpy(),
                         x0=x0.numpy(), cfg=cfg, noise=noise.numpy()),
                    2, "cuda", timeout=300)
    assert out[1] is None
    scale = float(want.abs().max())
    assert abs(out[0]["x"] - want.cpu().numpy()).max() <= 1e-6 * scale
    assert abs(out[0]["traj"] - want_traj.cpu().numpy()).max() \
        <= 1e-6 * scale


def test_song_front_end_on_the_card_matches_the_cpu(cuda, tmp_path):
    """get_song_extract on the card (its default) against the CPU on the
    same wavs: the mixture STFT within 1e-5 of its largest magnitude (f32
    FFTs in another order), the dB mels within 1e-3 dB (the tolerance the
    CPU front end meets against the JAX package), the raw audio equal."""
    import numpy as np
    from audiosourcesep_tpu_torch.data import get_song_extract, write_wav
    sr = 16000
    t = np.arange(14 * sr) / sr          # 6 windows, the first 2 skipped
    piano = 0.4 * np.sin(2 * np.pi * 220.0 * t)
    violin = 0.4 * np.sin(2 * np.pi * 554.4 * t + 3 * np.sin(
        2 * np.pi * 5.0 * t))
    noise = 0.01 * np.random.default_rng(0).standard_normal(t.shape)
    for name, a in (("mix", 0.5 * (piano + violin) + noise),
                    ("piano", piano), ("violin", violin)):
        write_wav(str(tmp_path / f"{name}.wav"), a.astype(np.float32), sr)
    paths = [str(tmp_path / f"{n}.wav") for n in ("mix", "piano", "violin")]
    card = get_song_extract(*paths, duration=3 * 2.04)
    cpu = get_song_extract(*paths, duration=3 * 2.04, device="cpu")
    for a, b in zip(card[1], cpu[1]):
        np.testing.assert_array_equal(a, b)
    assert card[2].shape == cpu[2].shape == (3, 1025, 64)
    assert np.abs(card[2] - cpu[2]).max() <= 1e-5 * np.abs(cpu[2]).max()
    for a, b in zip(card[0], cpu[0]):
        assert a.shape == b.shape == (3, 96, 64, 1)
        assert np.abs(a - b).max() <= 1e-3
