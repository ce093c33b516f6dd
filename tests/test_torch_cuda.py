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
from audiosourcesep_tpu_torch.kernels import build
from audiosourcesep_tpu_torch.ops import counting, inversion
from audiosourcesep_tpu_torch.ops import winograd as W
from audiosourcesep_tpu_torch.ops.stft import istft, stft
from audiosourcesep_tpu_torch.training import (init_train_state,
                                               make_flow_train_step,
                                               make_ncsn_train_step,
                                               setup_optimizer)

pytestmark = pytest.mark.cuda

# the kernels' launch counters, read in place (ops.counting): the Winograd
# launches by kernel and by path
COUNTS = counting.COUNTS
LAUNCHES, BF16_PATHS, F32_PATHS = (COUNTS["launch_counts"],
                                   COUNTS["bf16_path_counts"],
                                   COUNTS["f32_path_counts"])

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
    before = COUNTS["launch_count"]
    name = W.KERNELS[dtype]
    before_mine = LAUNCHES[name]
    got = W.winograd_conv2d(x, k)
    assert COUNTS["launch_count"] == before + 1
    assert LAUNCHES[name] == before_mine + 1
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
    before, paths = dict(LAUNCHES), dict(BF16_PATHS)
    got = W._winograd_cuda(x, u).float()
    name = W.KERNELS[torch.bfloat16]
    assert LAUNCHES == {n: c + (n == name) for n, c in before.items()}
    assert BF16_PATHS == {n: c + (n == path)
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
    before, paths = dict(LAUNCHES), dict(BF16_PATHS)
    with monkeypatch.context() as mp:
        for fn in ("_to_phases", "_from_phases", "winograd_conv2d_reference",
                   "dilated_winograd_conv2d_reference"):
            mp.setattr(W, fn, _no_fallback)
        mp.setattr(F, "conv2d", _no_fallback)
        got = W.dilated_winograd_conv2d(x, k, 8).float()
    assert LAUNCHES == {n: c + (n == name) for n, c in before.items()}
    assert BF16_PATHS == {n: c + (n == "tma")
                          for n, c in paths.items()}
    tol_max, tol_mean, _ = TOL[torch.bfloat16]
    err = (got - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()
    # a call that the JAX dilated_winograd_conv2d refuses too (H = 24 does
    # not divide by 2d = 16) raises, and nothing runs
    x, k = _inputs((1, 24, 32, 16), 16, torch.bfloat16)
    u = W.transform_weights(k).bfloat16()
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="divisible by 2d"):
        W.dilated_winograd_conv2d(x, k, 8)
    with pytest.raises(ValueError, match="divisible by 2d"):
        W._winograd_cuda(x, u, 8)
    assert LAUNCHES == before
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
    before, paths = dict(LAUNCHES), dict(F32_PATHS)
    with monkeypatch.context() as mp:
        for fn in ("_to_phases", "_from_phases", "winograd_conv2d_reference",
                   "dilated_winograd_conv2d_reference"):
            mp.setattr(W, fn, _no_fallback)
        mp.setattr(F, "conv2d", _no_fallback)
        got = W._winograd_cuda(x, u, d)
    torch.cuda.synchronize()
    assert LAUNCHES == {n: c + (n == name) for n, c in before.items()}
    assert F32_PATHS == {n: c + (n == path)
                         for n, c in paths.items()}
    assert got.shape == (*shape[:3], cout)
    tol_max, tol_mean, _ = TOL[torch.float32]
    err = (got - want).abs()
    assert err.max().item() <= tol_max * want.abs().max().item()
    assert err.mean().item() <= tol_mean * want.abs().mean().item()
    # the wide design, forced on the same conv, computes the same
    wide = W._winograd_cuda(x, u, d, path="wide")
    assert F32_PATHS["wide"] == paths["wide"] + 1 + (path == "wide")
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
    before, paths = dict(LAUNCHES), dict(F32_PATHS)
    for path in ("thin_in", "thin_out", "narrow"):
        with pytest.raises(ValueError, match="path"):
            W._winograd_cuda(x, u, path=path)
    with pytest.raises(ValueError, match="f32 kernel"):
        W._winograd_cuda(x.bfloat16(), u.bfloat16(), path="wide")
    assert LAUNCHES == before and F32_PATHS == paths
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
    paths = dict(F32_PATHS)
    got = W._winograd_cuda(xm, u)
    assert F32_PATHS["thin_out"] == paths["thin_out"] + 1
    want = W.winograd_conv2d_reference(x, k)
    assert (got - want).abs().max().item() \
        <= TOL[torch.float32][0] * want.abs().max().item()
    from audiosourcesep_tpu_torch.kernels.build import load_library
    y = torch.full((2, 12, 8, 4), 7.0, device=cuda)
    geometry = W._thin_geometry(tuple(x.shape), 4, 1, "thin_out",
                                build.sm_count(x.device.index))
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
            before = COUNTS["launch_count"]
            on = m(x, idx)
            assert COUNTS["launch_count"] - before == 64
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
            before = COUNTS["launch_count"]
            first = conv(x)
            conv.kernel.mul_(-1.0)                   # U must be rebuilt
            second = conv(x)
        assert COUNTS["launch_count"] == before + 2
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
    before = dict(LAUNCHES)
    with monkeypatch.context() as mp:
        mp.setattr(W, "_to_phases", _no_phase_copy)
        mp.setattr(W, "_from_phases", _no_phase_copy)
        got = W.dilated_winograd_conv2d(x, k, d)
    # all d*d phases in one launch of this dtype's kernel, counted where
    # _winograd_cuda launches it
    assert LAUNCHES == {n: c + (n == name) for n, c in before.items()}
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
    before, paths = dict(LAUNCHES), dict(BF16_PATHS)
    with monkeypatch.context() as mp:
        mp.setattr(W, "_to_phases", _no_phase_copy)
        mp.setattr(W, "_from_phases", _no_phase_copy)
        got = W.dilated_winograd_conv2d(x, k, d)
    assert LAUNCHES == {n: c + (n == name) for n, c in before.items()}
    bf16 = dtype == torch.bfloat16
    assert BF16_PATHS == {n: c + (bf16 and n == path)
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
            before = dict(LAUNCHES)
            loss = dsm_loss(m, x, torch.as_tensor(SIGMAS, device=cuda),
                            sigma_idx=idx, noise=noise)
            loss.backward()
            launched = {k: LAUNCHES[k] - before[k] for k in before}
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
            before = dict(LAUNCHES)
            lp_g, score_g = gpu.log_prob(x.to(cuda)), gpu.score(x.to(cuda))
            launched = {k: LAUNCHES[k] - before[k] for k in before}
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
                before = LAUNCHES[W.KERNELS[torch.float32]]
                lp_g = gpu.log_prob(x.to(cuda), eps.to(cuda))
                launched = LAUNCHES[W.KERNELS[torch.float32]] - before
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


# ---------------------------------------------------------------------------
# the anneal as CUDA graphs of one step a level (separation.graphs)
# ---------------------------------------------------------------------------

def _scaled(counts, times):
    """``ops.counting.since``' layout, every count x ``times``."""
    return {k: v * times if isinstance(v, int) else _scaled(v, times)
            for k, v in counts.items()}


def _graphed_and_eager(cuda, run, T):
    """``run(graphed)`` graphed and eager, routing on, with the launch
    counts of each; the graphed run's counts hold one eager warm-up step
    a level besides its T replays, so ``T x graphed == (T + 1) x eager``.
    Returns the two results."""
    out, launched = {}, {}
    try:
        nn.set_winograd(True)
        for graphed in (True, False):
            before = counting.snapshot()
            out[graphed] = run(graphed)
            torch.cuda.synchronize()
            launched[graphed] = counting.since(before)
    finally:
        nn.set_winograd(False)
    assert launched[False]["launch_count"] > 0
    assert _scaled(launched[True], T) == _scaled(launched[False], T + 1)
    return out[True], out[False]


def test_graphed_ncsn_anneal_equals_eager_on_the_card(cuda):
    """A small NCSN (v1, 16 filters, 32x32, bf16 compute) routed to the
    bf16 kernel on both its producer paths: BASIS and the Langevin sampler
    graphed (one graph a level) equal the eager loops bit for bit, on
    injected noise and on a generator's draws from one seed; the kernel
    runs inside the graphs (launches by path per replay those of an eager
    step)."""
    from audiosourcesep_tpu_torch.models.ncsn import anneal_langevin_dynamics
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     ncsn_score_fn)
    L, T, N, shape = 2, 3, 4, (32, 32, 1)
    models = []
    for seed in (1, 2):
        m = get_score_model("v1", shape, 16, L, compute_dtype=torch.bfloat16,
                            device=cuda)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        models.append(m.eval().requires_grad_(False))
    g = torch.Generator().manual_seed(3)
    mixed = torch.rand((N, *shape), generator=g).to(cuda)
    x0 = torch.rand((2, N, *shape), generator=g).to(cuda)
    noise = torch.randn((L, T, 2, N, *shape), generator=g).to(cuda)
    cfg = BasisConfig(T=T, delta=2e-3, data_type="melspec", scale="dB")
    sigmas = get_sigmas(1.0, 0.1, L)

    def separate(noise_fn=None, seed=None):
        def run(graphed):
            gen = None if seed is None else \
                torch.Generator(device=cuda).manual_seed(seed)
            return basis_separate_per_level(
                ncsn_score_fn(models), mixed, x0, sigmas, gen, cfg,
                noise_fn=noise_fn, graphed=graphed)
        return run

    for run in (separate(lambda level, step: noise[level, step]),
                separate(seed=5)):
        (x, traj), (x_e, traj_e) = _graphed_and_eager(cuda, run, T)
        assert torch.isfinite(x).all() and (x - x0).abs().max() > 1e-2
        assert torch.equal(x, x_e) and torch.equal(traj, traj_e)

    def sample(graphed):
        return anneal_langevin_dynamics(
            models[0], x0[0], sigmas,
            torch.Generator(device=cuda).manual_seed(7), n_steps_each=T,
            return_arr=True, graphed=graphed)

    got, eager = _graphed_and_eager(cuda, sample, T)
    assert torch.equal(got, eager) and torch.equal(got[0], x0[0])


def test_graphed_anneals_in_one_process_reuse_the_cached_memory(cuda):
    """Two graphed BASIS anneals back to back at full width (v1, 192
    filters, 30 frames of 96x64, bf16, routed; 2 levels x T=3): the second
    leaves no more memory reserved than the first. Each anneal warms up
    and captures on the process's one side stream of the device, so the
    second reuses the blocks the first cached there. Blocks cached on a
    stream are reused by no other stream, and where a live tensor holds
    part of their segment ``empty_cache`` cannot free them either: with a
    new side stream an anneal, the second anneal left 222 MiB more
    reserved than the first (2,738 against 2,516 MiB on an H100), with one
    side stream 68 MiB less. ``empty_cache`` before each anneal frees
    what it can, as the allocator does before it runs out; the margin is
    one small-pool segment (2 MiB)."""
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     ncsn_score_fn)
    L, T, N, shape = 2, 3, 30, (96, 64, 1)
    models = []
    for seed in (1, 2):
        m = get_score_model("v1", shape, 192, L,
                            compute_dtype=torch.bfloat16, device=cuda)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        models.append(m.eval().requires_grad_(False))
    g = torch.Generator().manual_seed(3)
    mixed = torch.rand((N, *shape), generator=g).to(cuda)
    x0 = torch.rand((2, N, *shape), generator=g).to(cuda)
    cfg = BasisConfig(T=T, delta=2e-3, data_type="melspec", scale="dB")
    reserved = []
    try:
        nn.set_winograd(True)
        for _ in range(2):
            torch.cuda.empty_cache()
            x, _ = basis_separate_per_level(
                ncsn_score_fn(models), mixed, x0, get_sigmas(1.0, 0.1, L),
                torch.Generator(device=cuda).manual_seed(5), cfg,
                graphed=True)
            torch.cuda.synchronize()
            assert torch.isfinite(x).all()
            del x, _
            reserved.append(torch.cuda.memory_reserved(cuda))
    finally:
        nn.set_winograd(False)
    assert reserved[1] - reserved[0] <= 2 * 2 ** 20, reserved


@pytest.mark.parametrize("chunk", [2, None])
def test_graphed_glow_anneal_equals_eager_on_the_card(cuda, monkeypatch,
                                                      chunk):
    """Small Glows (L=3, K=2, 32 filters, f32, routed: the coupling convs on
    the f32 kernel's wide, thin_in and thin_out paths), a pair a level:
    BASIS graphed, its score (a forward and autograd's input gradient, in
    frame chunks of 2 or whole) captured in each level's graph, equals the
    eager loop bit for bit on injected noise, with deterministic algorithms
    in both (without them the eager Glow score itself differs from run to
    run in its last bits: chip_smoke.py phase 11)."""
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     glow_score_fn)
    L, T, N = 2, 2, 4
    g = torch.Generator().manual_seed(0)
    mb = torch.rand(4, 96, 64, 1, generator=g) * 120.0 - 100.0
    chains = []
    for _ in range(L):
        row = []
        for _ in range(2):
            m = build_glow((96, 64, 1), minibatch=mb, generator=g, L=3, K=2,
                           n_filters=32, learntop=True, data_type="melspec")
            with torch.no_grad():
                for name, p in m.named_parameters():
                    if "conv3.kernel" in name:
                        p.copy_(1e-3 * torch.randn(p.shape, generator=g))
            row.append(m.to(cuda).eval().requires_grad_(False))
        chains.append(row)
    mixed = (torch.rand(N, 96, 64, 1, generator=g) * 80.0 - 80.0).to(cuda)
    x0 = (torch.rand(2, N, 96, 64, 1, generator=g) * 120.0 - 100.0).to(cuda)
    noise = torch.randn((L, T, 2, N, 96, 64, 1), generator=g).to(cuda)
    cfg = BasisConfig(T=T, delta=2e-3, data_type="melspec", scale="dB",
                      score_clip=1.0)

    def run(graphed):
        return basis_separate_per_level(
            glow_score_fn(chains, frame_chunk=chunk), mixed, x0,
            [1.0, 0.5], config=cfg, graphed=graphed,
            noise_fn=lambda level, step: noise[level, step])

    before = counting.snapshot()
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        (x, traj), (x_e, traj_e) = _graphed_and_eager(cuda, run, T)
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]
    paths = counting.since(before)["f32_path_counts"]
    assert all(paths[p] > 0 for p in ("wide", "thin_in", "thin_out"))
    assert torch.isfinite(x).all() and (x - x0).abs().max() > 1e-3
    assert torch.equal(x, x_e) and torch.equal(traj, traj_e)


def test_graphed_anneal_raises_on_a_host_sync_and_does_not_run_eagerly(
        cuda):
    """A score that reads a value on the host (``.item()``) cannot be
    captured: the graphed anneal raises, after its warm-up step and the
    failed capture, and runs no eager step in its place."""
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level)
    calls = []

    def score(x, sigma_idx, level):
        calls.append(level)
        return -x * x.abs().max().item()

    x0 = torch.rand(2, 3, 8, 8, 1, device=cuda)
    with pytest.raises(RuntimeError):
        basis_separate_per_level(score, x0[0], x0, [1.0, 0.5],
                                 config=BasisConfig(T=2))
    assert calls == [0, 0]
    torch.cuda.synchronize()


def _traced_basis(cuda, traced, L=2, T=3):
    """A routed bf16 NCSN BASIS (v1, 64 filters, 8 frames of 96x64),
    graphed, in a recording; ``traced``: under a profiler of the card's
    rows alone, as the benchmark's traced run starts one. Returns the
    result, the record and the device ms of each replay (an event pair
    around each)."""
    from torch.profiler import ProfilerActivity, profile

    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     graphs, ncsn_score_fn)
    shape, N = (96, 64, 1), 8
    models = []
    for seed in (1, 2):
        m = get_score_model("v1", shape, 64, L, compute_dtype=torch.bfloat16,
                            device=cuda)
        m.reset_parameters(torch.Generator().manual_seed(seed))
        models.append(m.eval().requires_grad_(False))
    g = torch.Generator().manual_seed(3)
    mixed = torch.rand((N, *shape), generator=g).to(cuda)
    x0 = torch.rand((2, N, *shape), generator=g).to(cuda)
    prof = profile(activities=[ProfilerActivity.CUDA]) if traced else None
    replays, original = [], torch.cuda.CUDAGraph.replay

    def replay(graph):
        pair = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        pair[0].record()
        original(graph)
        pair[1].record()
        replays.append(pair)

    try:
        nn.set_winograd(True)
        torch.cuda.CUDAGraph.replay = replay
        if prof is not None:
            prof.start()
        with graphs.recording() as record:
            x, _ = basis_separate_per_level(
                ncsn_score_fn(models), mixed, x0, get_sigmas(1.0, 0.1, L),
                torch.Generator(device=cuda).manual_seed(5),
                BasisConfig(T=T, delta=2e-3), graphed=True)
        torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = original
        if prof is not None:
            prof.stop()
        nn.set_winograd(False)
    return x, record, [a.elapsed_time(b) for a, b in replays]


@pytest.mark.parametrize("every_leaf", [False, True])
def test_device_spans_read_inside_a_graphed_level(cuda, every_leaf):
    """Under a profiler of the card's rows each level records the module
    spans of its capture, and the event pairs captured into the graph
    read the last replay's milliseconds: the outer spans' and a RefineNet
    forward's convs', and no other leaf; the warm-up step records none.
    Inside ``every_leaf`` the warm-up (eager events) and the capture span
    and time every leaf."""
    from audiosourcesep_tpu_torch.utils import profiling
    with profiling.every_leaf() if every_leaf else contextlib.nullcontext():
        _, record, _ = _traced_basis(cuda, True)
    assert record.traced == [0, 1]
    outer = {"anneal.noise", "score", "score.forward", "conv",
             "basis.update"}
    leaves = {"norm", "act", "pool", "resize"} if every_leaf else set()
    for level in (0, 1):
        spans = {phase: [s for s in record.spans if s.level == level
                         and s.phase == phase and not (
                             s.name.startswith("anneal.")
                             and s.name != "anneal.noise")]
                 for phase in ("warmup", "capture")}
        assert all(s.device_ms is not None and s.device_ms >= 0
                   for p in spans.values() for s in p)
        assert {s.name for s in spans["capture"]} == outer | leaves
        # (the warm-up draws no noise; level 0's transforms the weights)
        assert {s.name for s in spans["warmup"]} - {"conv.weights"} == (
            outer - {"anneal.noise"} | leaves if every_leaf else set())
        assert all(s.events is None for s in record.spans)
        forwards = [s for s in spans["capture"] if s.name == "score.forward"]
        assert len(forwards) == 2 and all(f.device_ms > 0 for f in forwards)


def test_top_device_spans_add_up_to_the_replay(cuda):
    """A level's outermost captured spans (the draw, the two scores, the
    update) add up to within 3% of the replay they timed, the level's
    last."""
    T = 3
    _, record, replays = _traced_basis(cuda, True, T=T)
    for steps in record.levels:
        top = [s for s in record.spans if s.level == steps.level
               and s.phase == "capture" and s.device_ms is not None
               and record.spans[s.parent].device_ms is None]
        assert sorted(s.name for s in top) == [
            "anneal.noise", "basis.update", "score", "score"]
        last = replays[(steps.level + 1) * T - 1]
        assert abs(sum(s.device_ms for s in top) - last) <= 0.03 * last


def test_graphed_basis_is_the_same_with_tracing_on_and_off(cuda):
    off, record_off, _ = _traced_basis(cuda, False)
    on, record_on, _ = _traced_basis(cuda, True)
    assert record_off.traced == [] and record_on.traced == [0, 1]
    assert torch.isfinite(on).all()
    assert torch.equal(on, off)


# ---------------------------------------------------------------------------
# the InstanceNorm++ kernel (ops.instnorm, csrc/instnorm_plus.cu)
# ---------------------------------------------------------------------------

def _norm_inputs(shape, dtype, labels=True, seed=0, classes=10):
    """x (channels_last) with each channel's own mean and spread, as a
    score net's activations have; N(0, 0.5^2) embedding tables, the inner
    norm's rows near (1, 0); labels or None (v2)."""
    n, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*s):
        return torch.randn(s, device="cuda", generator=g)

    spread = 0.5 + 1.5 * torch.rand(c, device="cuda", generator=g)
    x = randn(n, c, h, w) * spread[:, None, None] + randn(c)[:, None, None]
    k = classes if labels else 1
    tables = [0.5 * randn(k, c) for _ in range(3)]
    if not labels:
        tables = [t[0] for t in tables]
    rows = (*tables, 1.0 + 0.1 * randn(c), 0.1 * randn(c))
    y = (torch.randint(classes, (n,), device="cuda", generator=g)
         if labels else None)
    return (x.to(dtype).contiguous(memory_format=torch.channels_last), y,
            rows)


def _norm_composite(x, y, rows, act=None):
    """The PyTorch composite the norm modules run off the card, in f32 on
    x's values: the embedding rows gathered and folded, norm2dplus, act."""
    from audiosourcesep_tpu_torch.ops import instnorm as IN
    return IN.composite(x.float(), y, *rows, act=act)


def _bf16_ulps(got, want, atol=2e-5):
    """|got - want| less ``atol`` (the f32 kernel's own agreement with the
    composite, which bounds the f32 result that bf16 rounds once) in bf16
    ulps of ``want`` (8 bits of mantissa). Near 0 an f32 result's error,
    not its rounding, sets the difference."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - 7)
    return ((got.float() - want).abs().sub(atol).clamp_min(0) / ulp).max() \
        .item()


# the separation cell's three classes (v1, 192 filters, 30 frames), the
# image NCSN's 32x32 at 192 filters (batch 50), v2's 12x8 at 128 filters
# (256 channels); C not a multiple of 8 (element loads)
NORM_SHAPES = [(30, 192, 96, 64), (30, 384, 48, 32), (30, 192, 48, 32),
               (50, 192, 32, 32), (8, 256, 12, 8), (3, 20, 10, 6),
               (2, 3, 5, 7)]


@pytest.mark.parametrize("shape", NORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("elu", [False, True])
def test_instnorm_kernel_matches_the_composite(cuda, shape, dtype, labels,
                                               elu):
    """The kernel against the composite in f32 on the same values: f32
    within the atol TestNorm2dPlus.test_matches_jax holds the composite to
    against the JAX package; bf16 within one bf16 ulp of the f32 composite
    (beyond that atol), and bit for bit the f32 kernel's result on the
    same values rounded once to bf16."""
    from audiosourcesep_tpu_torch.ops import instnorm as IN
    x, y, rows = _norm_inputs(shape, dtype, labels)
    before = counting.snapshot()
    got = IN.instnorm_plus(x, y, *rows, elu=elu)
    assert counting.since(before)["instnorm"] == {
        "launch_count": 1, "layout_copies": 0}
    assert got.dtype == dtype and got.shape == x.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = _norm_composite(x, y, rows, F.elu if elu else None)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    else:
        assert _bf16_ulps(got, want) <= 1.0
        once = IN.instnorm_plus(x.float(), y, *rows, elu=elu).bfloat16()
        assert torch.equal(got, once)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instnorm_kernel_large_means_and_constant_channels(cuda, dtype):
    """Channels of large mean and ~0 variance stay finite (the statistics
    sum x less a shift); a channel of constants hits the clamp at 0 and
    comes out constant, as in the composite."""
    from audiosourcesep_tpu_torch.ops import instnorm as IN
    g = torch.Generator(device="cuda").manual_seed(0)
    means = torch.tensor([1e4, -1e4, 3e4, 1.0, 3.0, 0.0, -2.0, 5.0],
                         device="cuda")
    x = means[None, :, None, None] + 1e-2 * torch.randn(
        (2, 8, 8, 8), device="cuda", generator=g)
    x[:, 4] = 3.0                                       # constant
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    ones, zeros = torch.ones(8, device="cuda"), torch.zeros(8, device="cuda")
    rows = (ones, 0.5 * ones, zeros, ones, zeros)
    out = IN.instnorm_plus(x, None, *rows)
    assert torch.isfinite(out).all()
    const = out[:, 4].float()
    assert (const == const[:, :1, :1]).all()
    want = _norm_composite(x, None, rows)[:, 4]
    if dtype == torch.float32:
        torch.testing.assert_close(const, want, atol=2e-5, rtol=0)
    else:
        assert _bf16_ulps(const, want) <= 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_instnorm_kernel_in_a_graph_equals_eager_and_counts_replays(
        cuda, dtype):
    """Captured and replayed, the kernel pair gives the eager call's output
    bit for bit (its tickets, zeroed in the graph, start clean at every
    replay), and each replay adds the capture's count to the kernel's
    counters."""
    from audiosourcesep_tpu_torch.ops import instnorm as IN
    from audiosourcesep_tpu_torch.separation import graphs
    x, y, rows = _norm_inputs((30, 384, 48, 32), dtype)
    eager = IN.instnorm_plus(x, y, *rows, elu=True)
    out = torch.empty_like(eager)

    def step():
        out.copy_(IN.instnorm_plus(x, y, *rows, elu=True))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph):
            step()

    before = counting.snapshot()
    sg = graphs.StepGraph(graph, capture)
    assert counting.snapshot() == before
    assert sg.launches["instnorm"]["launch_count"] == 1
    for _ in range(3):
        out.zero_()
        sg.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert counting.since(before)["instnorm"]["launch_count"] == 3


def test_instnorm_kernel_refuses_and_does_not_fall_back(cuda, monkeypatch):
    """A dtype or layout the kernel does not take raises; through the norm
    module a CUDA tensor's forward never reaches the composite, with grad
    mode on or off."""
    from audiosourcesep_tpu_torch.models.ncsn import layers
    from audiosourcesep_tpu_torch.ops import instnorm as IN
    x, y, rows = _norm_inputs((2, 16, 8, 8), torch.float32)
    with pytest.raises(TypeError):
        IN._instnorm_cuda(x.half(), y, *rows)
    with pytest.raises(ValueError, match="channels_last"):
        IN._instnorm_cuda(x.contiguous(), y, *rows)
    with pytest.raises(ValueError):
        IN._instnorm_cuda(x, y, *(t.double() for t in rows))
    # the public call copies another layout into channels_last, counted
    before = counting.snapshot()
    got = IN.instnorm_plus(x.contiguous(), y, *rows)
    assert counting.since(before)["instnorm"]["layout_copies"] == 1
    assert torch.equal(got, IN.instnorm_plus(x, y, *rows))
    norm = layers.ConditionalInstanceNorm2dPlus(16, 10, device="cuda")
    norm.reset_parameters(torch.Generator().manual_seed(0))
    monkeypatch.setattr(IN, "norm2dplus", _no_fallback)
    with torch.no_grad():
        with pytest.raises(TypeError):
            norm(x.half(), y)
        norm(x, y, act=nn.elu)
    assert norm(x, y, act=nn.elu).requires_grad


def test_ncsn_forward_takes_the_kernel_under_autograd_too(cuda):
    """A v1 forward on the card runs its 71 norms on the kernel (17 with
    the ELU fused), with grad mode on or off, and agrees with the CPU's
    composite forward; under autograd its gradients are the CPU's."""
    m = get_score_model("v1", (32, 16, 1), 16, 4, device=cuda)
    m.reset_parameters(torch.Generator().manual_seed(0))
    ref = get_score_model("v1", (32, 16, 1), 16, 4)
    ref.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    x = torch.rand(3, 32, 16, 1, generator=g)
    idx = torch.tensor([0, 3, 1])
    for grad in (False, True):
        before = counting.snapshot()
        with torch.set_grad_enabled(grad):
            out = m(x.to(cuda), idx.to(cuda))
        assert counting.since(before)["instnorm"] == {
            "launch_count": 71, "layout_copies": 0}
    want = ref(x, idx)
    torch.testing.assert_close(out.detach().cpu(), want.detach(),
                               rtol=1e-4, atol=1e-4)
    (out * out).mean().backward()
    (want * want).mean().backward()
    got = {k: p.grad.cpu() for k, p in m.named_parameters()}
    for k, p in ref.named_parameters():
        scale = p.grad.abs().max().item()
        assert (got[k] - p.grad).abs().max().item() <= 1e-3 * scale + 1e-7, k


@pytest.mark.parametrize("labels", [True, False])
@pytest.mark.parametrize("elu", [False, True])
def test_instnorm_kernel_backward_is_the_composites_vjp(cuda, labels, elu):
    """Gradients through the kernel (forward) are the composite's VJP: in
    x and in every table, against autograd through the composite itself."""
    from audiosourcesep_tpu_torch.ops import instnorm as IN
    x, y, rows = _norm_inputs((4, 24, 12, 8), torch.float32, labels)
    gy = torch.randn(x.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(5))
    leaves = [[t.clone().requires_grad_(True) for t in (x, *rows)]
              for _ in range(2)]
    IN.instnorm_plus(leaves[0][0], y, *leaves[0][1:], elu=elu).backward(gy)
    IN.composite(leaves[1][0], y, *leaves[1][1:],
                 act=F.elu if elu else None).backward(gy)
    for got, want in zip(*leaves):
        torch.testing.assert_close(got.grad, want.grad)


# ---------------------------------------------------------------------------
# NCSN v2 at the published widths (configs/melspec_ncsnv2.yml: 128
# filters, 96x64, 200 levels from sigma 30, T=8), bf16, routed
# ---------------------------------------------------------------------------

V2_SHAPE = (96, 64, 1)


def _v2_models(cuda, sigmas, seed=1, sources=2):
    models = []
    for k in range(sources):
        m = get_score_model("v2", V2_SHAPE, 128, len(sigmas), sigmas=sigmas,
                            compute_dtype=torch.bfloat16, device=cuda)
        m.reset_parameters(torch.Generator().manual_seed(seed + k))
        models.append(m.eval().requires_grad_(False))
    return models


def test_graphed_v2_level_equals_eager_at_the_cells_widths(cuda):
    """Two v2 priors at 128 filters on 30 frames, bf16, routed: BASIS
    graphed (one graph a level, the levels' first at sigma 30 with its
    step of eta 63) equals the eager loop bit for bit, on a generator's
    draws from one seed, with an eager step's launches a replay."""
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     ncsn_score_fn)
    T, N = 2, 30
    sigmas = get_sigmas(30.0, 0.01, 2, "logarithmic")
    models = _v2_models(cuda, sigmas)
    g = torch.Generator().manual_seed(3)
    mixed = (0.5 + 0.2 * torch.randn((N, *V2_SHAPE), generator=g)).to(cuda)
    x0 = torch.rand((2, N, *V2_SHAPE), generator=g).to(cuda)
    cfg = BasisConfig(T=T, delta=7e-6, data_type="melspec", scale="dB")

    def run(graphed):
        return basis_separate_per_level(
            ncsn_score_fn(models), mixed, x0, sigmas,
            torch.Generator(device=cuda).manual_seed(5), cfg,
            graphed=graphed)

    (x, traj), (x_e, traj_e) = _graphed_and_eager(cuda, run, T)
    assert torch.isfinite(traj).all() and (x - x0).abs().max() > 1.0
    assert torch.equal(x, x_e) and torch.equal(traj, traj_e)


def test_v2_forward_on_the_card_is_within_bf16_of_the_plain_reference(cuda):
    """A v2 forward at the published widths on the card (bf16, routed; its
    17 norms on the kernel, counted) against the benchmark's plain float32
    reference on the same weights, at three levels: within the bf16
    tolerance TestRefineNet.test_bf16_compute_close_to_f32 holds the CPU's
    bf16 forward to (mean |error| under 5% of mean |score|)."""
    from portbench import weights
    from portbench.reference import ncsn_v2
    from portbench.reference.precision import stack
    sigmas = get_sigmas(30.0, 0.01, 200, "logarithmic")
    cfg = {"n_filters": 128, "data_shape": list(V2_SHAPE),
           "init": {"norm_mean": 0.0}}
    w = weights.make(ncsn_v2.param_specs(cfg), 7, cuda)
    m = get_score_model("v2", V2_SHAPE, 128, 200, sigmas=sigmas,
                        compute_dtype=torch.bfloat16, device="meta")
    m = m.to_empty(device=cuda)
    m.load_state_dict(w)
    m.sigmas.copy_(torch.as_tensor(sigmas))
    g = torch.Generator().manual_seed(8)
    x = torch.rand((4, *V2_SHAPE), generator=g).to(cuda)
    idx = torch.tensor([0, 60, 130, 199], device=cuda)
    before = counting.snapshot()
    try:
        nn.set_winograd(True)
        with torch.no_grad():
            got = m(x, idx)
    finally:
        nn.set_winograd(False)
    assert counting.since(before)["instnorm"] == {
        "launch_count": 17, "layout_copies": 0}
    with torch.no_grad():
        want = ncsn_v2.score(stack([w]), x[None], idx, cfg,
                             sigmas=torch.as_tensor(sigmas, device=cuda))[0]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = (got - want).abs().mean() / want.abs().mean()
    assert err < 0.05, err.item()


def test_200_level_graphed_v2_anneal_holds_memory_flat(cuda):
    """The published schedule's 200 levels graphed at T=1 on 2 frames (the
    cell's widths, bf16, routed), one capture a level: every level
    finite, and the memory allocated and the memory reserved between
    levels the same from level 10 to level 199 (each capture reuses the
    last one's pool, each warm-up the blocks the last one cached on the
    side stream; no cache is emptied)."""
    from audiosourcesep_tpu_torch.separation import (BasisConfig,
                                                     basis_separate_per_level,
                                                     graphs, ncsn_score_fn)
    sigmas = get_sigmas(30.0, 0.01, 200, "logarithmic")
    models = _v2_models(cuda, sigmas)
    g = torch.Generator().manual_seed(3)
    mixed = torch.rand((2, *V2_SHAPE), generator=g).to(cuda)
    x0 = torch.rand((2, 2, *V2_SHAPE), generator=g).to(cuda)
    allocated, reserved, finite = [], [], []

    def after(level, x):
        finite.append(bool(torch.isfinite(x).all()))
        allocated.append(torch.cuda.memory_allocated(cuda))
        reserved.append(torch.cuda.memory_reserved(cuda))

    try:
        nn.set_winograd(True)
        with graphs.recording() as record:
            basis_separate_per_level(
                ncsn_score_fn(models), mixed, x0, sigmas,
                torch.Generator(device=cuda).manual_seed(5),
                BasisConfig(T=1, delta=7e-6, collect_trajectory=False),
                callback=after)
    finally:
        nn.set_winograd(False)
    assert len(record.captures) == 200 and all(finite)
    for held in (allocated, reserved):
        assert len(set(held[10:])) == 1, (min(held[10:]), max(held[10:]))


# ---------------------------------------------------------------------------
# the pool kernels (ops.pool, csrc/pool.cu)
# ---------------------------------------------------------------------------

# NCHW shapes: v1's CRP classes (192 filters, 30 frames), v2's (128), both
# downsampling blocks' 2x2 inputs; edges: N = 1 and H, W below 5, C = 3 and
# odd W, C = 12, a 1x1 map, a map wider than a block's tile
POOL_SHAPES = [(30, 384, 48, 32), (30, 192, 48, 32), (30, 192, 96, 64),
               (30, 256, 48, 32), (30, 128, 96, 64), (30, 384, 96, 64),
               (30, 256, 96, 64), (1, 8, 3, 4), (2, 3, 7, 5), (1, 12, 4, 9),
               (3, 16, 1, 1), (2, 24, 5, 300)]


def _pooled(x, kind):
    """PyTorch's pool of ``kind`` on x, which the port ran before the
    kernels."""
    if kind == "avg5":
        return F.avg_pool2d(x, 5, 1, 2, count_include_pad=False)
    if kind == "max5":
        return F.max_pool2d(x, 5, 1, 2)
    return F.avg_pool2d(x, 2, 2)


def _pool_ulps(got, want, x):
    """|got - want| beyond the f32 sums' reordering (48 f32 ulps of max|x|:
    twice 24 additions' bound, over the count) in ulps of x's dtype at
    want."""
    atol = 48 * 2.0 ** -24 * x.float().abs().max()
    bits = 7 if x.dtype == torch.bfloat16 else 23
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                     - bits)
    return ((got.float() - want).abs().sub(atol).clamp_min(0) / ulp).max() \
        .item()


def _pool_input(shape, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, device="cuda", generator=g) * 2 - 0.5).to(
        dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("shape", POOL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["avg5", "max5", "avg2"])
def test_pool_kernel_matches_pytorch(cuda, shape, dtype, kind):
    """Each kernel against PyTorch's pool on the same x: the max and the
    2x2 average bit for bit (the 2x2 sums in PyTorch's order), the 5x5
    average within one ulp of x's dtype beyond its f32 sums' other order;
    counted by kind, channels_last out."""
    if kind == "avg2" and min(shape[2:]) < 2:
        shape = (*shape[:2], 2 * shape[2] + 2, 2 * shape[3] + 2)
    x = _pool_input(shape, dtype)
    before = counting.snapshot()
    got = {"avg5": lambda: nn.avg_pool_same(x, 5),
           "max5": lambda: nn.max_pool_same(x, 5),
           "avg2": lambda: nn.avg_pool2(x)}[kind]()
    launched = counting.since(before)["pool"]
    assert launched["launch_count"] == launched["launch_counts"][kind] == 1
    assert launched["layout_copies"] == 0
    want = _pooled(x, kind)
    assert got.dtype == dtype and got.shape == want.shape
    assert got.is_contiguous(memory_format=torch.channels_last)
    if kind == "avg5":
        assert _pool_ulps(got, want, x) <= 1.0
    else:
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["avg5", "max5", "avg2"])
def test_pool_kernel_propagates_nan_and_inf(cuda, dtype, kind):
    """NaN and +-inf in x: NaN where PyTorch's pool gives NaN, the same
    infinities, and the finite rest as in the test above."""
    x = _pool_input((4, 24, 13, 10), dtype, seed=3).float()
    u = torch.rand(x.shape, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(4))
    x[u < 0.004] = float("nan")
    x[(u > 0.5) & (u < 0.504)] = float("inf")
    x[(u > 0.7) & (u < 0.704)] = -float("inf")
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    from audiosourcesep_tpu_torch.ops import pool as PL
    got = PL._pool_cuda(x, kind)
    want = _pooled(x, kind)
    assert torch.equal(got.isnan(), want.isnan()) and want.isnan().any()
    assert torch.equal(got.isinf(), want.isinf()) and want.isinf().any()
    inf = want.isinf()
    assert torch.equal(got[inf], want[inf])
    fin = want.isfinite()
    if kind == "avg5":
        assert _pool_ulps(got[fin], want[fin], x[x.isfinite()]) <= 1.0
    else:
        assert torch.equal(got[fin], want[fin])


def test_pool_kernels_in_a_graph_equal_eager_and_count_replays(cuda):
    """Captured and replayed, the three kernels give the eager calls'
    outputs bit for bit, and each replay adds the capture's launches, by
    kind, to the counters."""
    from audiosourcesep_tpu_torch.separation import graphs
    a = _pool_input((30, 384, 48, 32), torch.bfloat16, seed=1)
    b = _pool_input((30, 256, 96, 64), torch.bfloat16, seed=2)

    def pools():
        return (nn.avg_pool_same(a, 5), nn.max_pool_same(a, 5),
                nn.avg_pool2(b))

    eager = pools()
    outs = [torch.empty_like(t) for t in eager]

    def step():
        for o, t in zip(outs, pools()):
            o.copy_(t)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph):
            step()

    before = counting.snapshot()
    sg = graphs.StepGraph(graph, capture)
    assert counting.snapshot() == before
    assert sg.launches["pool"] == {"launch_count": 3, "layout_copies": 0,
                                   "launch_counts": {"avg5": 1, "max5": 1,
                                                     "avg2": 1}}
    for _ in range(3):
        for o in outs:
            o.zero_()
        sg.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, t) for o, t in zip(outs, eager))
    assert counting.since(before)["pool"]["launch_counts"] == {
        "avg5": 3, "max5": 3, "avg2": 3}


def test_pool_kernel_refuses_and_does_not_fall_back(cuda, monkeypatch):
    """A dtype, window or layout the kernels do not take raises; a CUDA
    tensor's pool never reaches PyTorch's pools in the forward, with grad
    mode on or off; the public call copies another layout into
    channels_last, counted."""
    from audiosourcesep_tpu_torch.ops import pool as PL
    x = _pool_input((2, 16, 8, 8), torch.float32)
    for kind in ("avg5", "max5", "avg2"):
        with pytest.raises(TypeError):
            PL._pool_cuda(x.half(), kind)
        with pytest.raises(TypeError):
            PL._pool_cuda(x.double(), kind)
        with pytest.raises(ValueError, match="channels_last"):
            PL._pool_cuda(x.contiguous(), kind)
    for fn in (nn.avg_pool_same, nn.max_pool_same):
        with pytest.raises(ValueError, match="5x5"):
            fn(x, 3)
    before = counting.snapshot()
    got = nn.max_pool_same(x.contiguous(), 5)
    assert counting.since(before)["pool"]["layout_copies"] == 1
    assert torch.equal(got, nn.max_pool_same(x, 5))
    monkeypatch.setattr(F, "avg_pool2d", _no_fallback)
    monkeypatch.setattr(F, "max_pool2d", _no_fallback)
    for grad in (False, True):
        xg = x.clone().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            outs = (nn.avg_pool_same(xg, 5), nn.max_pool_same(xg, 5),
                    nn.avg_pool2(xg))
        assert all(o.requires_grad == grad for o in outs)


@pytest.mark.parametrize("kind", ["avg5", "max5", "avg2"])
def test_pool_gradients_on_the_card(cuda, kind):
    """Gradients through the kernels' forward: the max and the 2x2 average
    equal autograd through PyTorch's pool on the card bit for bit (their
    backward is its VJP); the 5x5 average's, written through the forward,
    matches float64 on the CPU (test_avg_pool_same_gradient_on_the_card)."""
    x = _pool_input((4, 24, 12, 10), torch.float32, seed=5)
    gy = _pool_input((4, 24, 12, 10) if kind != "avg2" else (4, 24, 6, 5),
                     torch.float32, seed=6)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    fn = {"avg5": lambda t: nn.avg_pool_same(t, 5),
          "max5": lambda t: nn.max_pool_same(t, 5),
          "avg2": nn.avg_pool2}[kind]
    fn(xs[0]).backward(gy)
    if kind == "avg5":
        ref = x.double().cpu().requires_grad_()
        _pooled(ref, kind).backward(gy.double().cpu())
        err = (xs[0].grad.double().cpu() - ref.grad).norm() / ref.grad.norm()
        assert err < 1e-6, err
    else:
        _pooled(xs[1], kind).backward(gy)
        assert torch.equal(xs[0].grad, xs[1].grad)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_ncsn_forwards_take_the_pool_kernels(cuda, version):
    """A v1 forward on the card runs its 8 5x5 averages and 2 2x2 averages
    on the kernels, a v2 forward its 8 5x5 maxes and 2 2x2 averages, none
    copied, with grad mode on or off; and agrees with the CPU's forward."""
    kw = ({} if version == "v1" else
          {"sigmas": get_sigmas(1.0, 0.1, 4)})
    m = get_score_model(version, (32, 16, 1), 16, 4, device=cuda, **kw)
    m.reset_parameters(torch.Generator().manual_seed(0))
    ref = get_score_model(version, (32, 16, 1), 16, 4, **kw)
    ref.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    g = torch.Generator().manual_seed(1)
    x = torch.rand(3, 32, 16, 1, generator=g)
    idx = torch.tensor([0, 3, 1])
    want = {"avg5": 8 if version == "v1" else 0,
            "max5": 0 if version == "v1" else 8, "avg2": 2}
    for grad in (False, True):
        before = counting.snapshot()
        with torch.set_grad_enabled(grad):
            out = m(x.to(cuda), idx.to(cuda))
        assert counting.since(before)["pool"] == {
            "launch_count": 10, "layout_copies": 0, "launch_counts": want}
    with torch.no_grad():
        torch.testing.assert_close(out.detach().cpu(), ref(x, idx),
                                   rtol=1e-4, atol=1e-4)


# the fused bias -> ReLU -> frozen BN of the Glow coupling nets
# (ops.bias_relu_bn, csrc/bias_relu_bn.cu): Glow's three level sizes at 512
# channels (30 frames), an odd channel count, one not a multiple of 8, and
# more channel groups than a block's threads
BRB_SHAPES = [(30, 512, 48, 32), (30, 512, 24, 16), (30, 512, 12, 8),
              (3, 13, 5, 7), (2, 100, 6, 10), (1, 4100, 3, 2)]


def _brb_inputs(shape, dtype, seed=0):
    """h (``channels_last``) in ``dtype`` with NaN, infinities and a -0
    whose channel's bias is -0; float32 bias, gamma, beta; drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    h = torch.randn(shape, generator=g)
    bias, gamma, beta = (s * torch.randn(c, generator=g)
                         for s in (0.5, 1.0, 0.5))
    h[0, 0, 0, 0] = float("nan")
    h[0, 1, 0, 1] = float("inf")
    h[0, 1, 1, 0] = -float("inf")
    h[-1, 2, -1, -1] = -0.0
    bias[2] = -0.0
    h = h.to(dtype).cuda().contiguous(memory_format=torch.channels_last)
    return h, bias.cuda(), gamma.cuda(), beta.cuda()


def _same_bits(a, b):
    """``a`` and ``b`` bit for bit, NaN against NaN whatever its payload."""
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a.contiguous().view(bits)[~nan.contiguous()],
                            b.contiguous().view(bits)[~nan.contiguous()]))


@pytest.mark.parametrize("shape", BRB_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_bias_relu_bn_kernels_equal_the_composite_bit_for_bit(
        cuda, shape, dtype, layout):
    """The forward kernel against the PyTorch ops the coupling nets ran on
    the card, and the input gradient kernel against autograd's ops (``gy *
    g``, threshold_backward) with gy in NHWC or NCHW memory: bit for bit
    (NaN for NaN, the sign of zero kept), one launch each, counted by the
    gradient's layout, no copy, gh ``channels_last``."""
    from audiosourcesep_tpu_torch.ops import bias_relu_bn as BRB
    h, bias, gamma, beta = _brb_inputs(shape, dtype)
    p = BRB.params(bias, gamma, beta, dtype)
    gy = torch.randn(shape, generator=torch.Generator().manual_seed(1)
                     ).to(dtype).cuda()
    gy = gy.contiguous(memory_format=torch.channels_last) \
        if layout == "nhwc" else gy.contiguous()
    before = counting.snapshot()
    y = BRB._forward_cuda(h, p)
    gh = BRB._input_grad_cuda(gy, h, p)
    torch.cuda.synchronize()
    kind = "bwd_" + layout
    assert counting.since(before)["bias_relu_bn"] == {
        "launch_count": 2, "layout_copies": 0,
        "launch_counts": {"fwd": 1, "bwd_nhwc": int(kind == "bwd_nhwc"),
                          "bwd_nchw": int(kind == "bwd_nchw")}}
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert gh.is_contiguous(memory_format=torch.channels_last)
    assert _same_bits(y, BRB.composite(h, p))
    assert _same_bits(gh, BRB.composite_input_grad(gy, h, p))
    # the op end to end against the nets' old chain under autograd
    xs = [h.clone().requires_grad_(True) for _ in range(2)]
    outs = [nn.bias_relu_frozen_batchnorm(xs[0], bias, gamma, beta),
            nn.frozen_batchnorm(nn.relu(xs[1] + bias.to(dtype)[:, None,
                                                                None]),
                                gamma, beta)]
    assert _same_bits(outs[0], outs[1])
    grads = [torch.autograd.grad(o, x, gy)[0] for o, x in zip(outs, xs)]
    assert _same_bits(grads[0], grads[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_relu_bn_in_a_graph_equals_eager_and_counts_replays(cuda,
                                                                 dtype):
    """Captured and replayed, the forward and both gradient kernels give
    the eager calls' outputs bit for bit, and each replay adds the
    capture's counts to the counters."""
    from audiosourcesep_tpu_torch.ops import bias_relu_bn as BRB
    from audiosourcesep_tpu_torch.separation import graphs
    h, bias, gamma, beta = _brb_inputs((30, 512, 24, 16), dtype)
    gy = torch.randn(h.shape, generator=torch.Generator().manual_seed(2)
                     ).to(dtype).cuda()
    cache = {}

    def run():
        p = BRB.params(bias, gamma, beta, dtype, cache=cache)
        y = BRB._forward_cuda(h, p)
        return torch.stack([y, BRB._input_grad_cuda(gy, h, p),
                            BRB._input_grad_cuda(gy.contiguous(
                                memory_format=torch.channels_last), h, p)])

    eager = run()
    out = torch.empty_like(eager)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out.copy_(run())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()

    def capture():
        with torch.cuda.graph(graph):
            out.copy_(run())

    before = counting.snapshot()
    sg = graphs.StepGraph(graph, capture)
    assert counting.snapshot() == before
    assert sg.launches["bias_relu_bn"] == {
        "launch_count": 3, "layout_copies": 0,
        "launch_counts": {"fwd": 1, "bwd_nhwc": 1, "bwd_nchw": 1}}
    for _ in range(3):
        out.zero_()
        sg.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, eager)
    assert counting.since(before)["bias_relu_bn"]["launch_count"] == 9


def test_bias_relu_bn_refuses_and_does_not_fall_back(cuda):
    """A dtype, layout or rows the kernels do not take raise; the op
    copies h of another layout into channels_last, and the gradient kernel
    gy in neither NHWC nor NCHW memory, counted."""
    from audiosourcesep_tpu_torch.ops import bias_relu_bn as BRB
    h, bias, gamma, beta = _brb_inputs((2, 16, 4, 6), torch.float32)
    p = BRB.params(bias, gamma, beta, torch.float32)
    with pytest.raises(TypeError):
        BRB._forward_cuda(h.double(), p.double())
    with pytest.raises(TypeError):
        nn.bias_relu_frozen_batchnorm(h.half(), bias, gamma, beta)
    with pytest.raises(ValueError, match="channels_last"):
        BRB._forward_cuda(h.contiguous(), p)
    with pytest.raises(ValueError, match="rows"):
        BRB._forward_cuda(h, p[:, :8].contiguous())
    before = counting.snapshot()
    got = nn.bias_relu_frozen_batchnorm(h.contiguous(), bias, gamma, beta)
    assert counting.since(before)["bias_relu_bn"]["layout_copies"] == 1
    assert _same_bits(got, BRB._forward_cuda(h, p))
    gy = torch.randn(2, 6, 16, 4, device=cuda).permute(0, 2, 3, 1)
    assert not gy.is_contiguous() and not gy.is_contiguous(
        memory_format=torch.channels_last)
    before = counting.snapshot()
    gh = BRB._input_grad_cuda(gy, h, p)
    assert counting.since(before)["bias_relu_bn"] == {
        "launch_count": 1, "layout_copies": 1,
        "launch_counts": {"fwd": 0, "bwd_nhwc": 1, "bwd_nchw": 0}}
    assert _same_bits(gh, BRB.composite_input_grad(gy, h, p))


def test_bias_relu_bn_parameter_gradients_on_the_card(cuda):
    """Training's gradients of h, bias, gamma and beta on the card: h's
    bit for bit the old chain's on the card, the parameters' within the
    order of their f32 sums, and all within 1e-5 of the CPU's."""
    shape = (4, 64, 12, 8)
    g = torch.Generator().manual_seed(4)
    cpu = [torch.randn(shape, generator=g).contiguous(
        memory_format=torch.channels_last)] + [
        torch.randn(64, generator=g) for _ in range(3)]
    gy = torch.randn(shape, generator=g)
    got = {}
    for where in ("cuda", "cpu"):
        for name, fn in (("fused", nn.bias_relu_frozen_batchnorm),
                         ("old", lambda x, b, ga, be: nn.frozen_batchnorm(
                             nn.relu(x + b[:, None, None]), ga, be))):
            ps = [t.to(where).requires_grad_(True) for t in cpu]
            got[where, name] = [t.cpu() for t in torch.autograd.grad(
                fn(*ps), ps, gy.to(where))]
    assert _same_bits(got["cuda", "fused"][0], got["cuda", "old"][0])
    for a, b, c in zip(got["cuda", "fused"], got["cuda", "old"],
                       got["cpu", "fused"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)


def test_tiny_glow_score_replay_counts_four_launches_a_coupling(
        cuda, monkeypatch):
    """A small Glow's score (L=2, K=2, 32 filters, f32, routed) captured
    and replayed: each coupling's net runs the fused forward twice and its
    input gradient twice (4 launches a coupling), the replay adds them to
    the counters, the score equals eager bit for bit, and no relu or
    frozen_batchnorm of the old chain runs on the card."""
    from audiosourcesep_tpu_torch.separation import graphs
    g = torch.Generator().manual_seed(0)
    mb = torch.rand(4, 96, 64, 1, generator=g) * 120.0 - 100.0
    m = build_glow((96, 64, 1), minibatch=mb, generator=g, L=2, K=2,
                   n_filters=32, learntop=True, data_type="melspec")
    m = m.to(cuda).eval().requires_grad_(False)
    x = (torch.rand(6, 96, 64, 1, generator=g) * 120.0 - 100.0).to(cuda)
    couplings = 2 * 2
    monkeypatch.setattr(nn, "relu", _no_fallback)
    monkeypatch.setattr(nn, "frozen_batchnorm", _no_fallback)
    try:
        nn.set_winograd(True)
        before = counting.snapshot()
        eager = m.score(x)
        launched = counting.since(before)["bias_relu_bn"]
        out = torch.empty_like(eager)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out.copy_(m.score(x))
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph):
                out.copy_(m.score(x))

        sg = graphs.StepGraph(graph, capture)
    finally:
        nn.set_winograd(False)
    assert sg.launches["bias_relu_bn"] == launched
    assert launched["launch_count"] == 4 * couplings
    assert launched["launch_counts"]["fwd"] == 2 * couplings
    assert launched["layout_copies"] == 0
    print(f"a Glow coupling's input gradients by layout: "
          f"{launched['launch_counts']}")
    before = counting.snapshot()
    out.zero_()
    sg.replay()
    torch.cuda.synchronize()
    assert counting.since(before)["bias_relu_bn"] == launched
    assert torch.equal(out, eager)
