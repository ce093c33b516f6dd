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
from audiosourcesep_tpu_torch.models.ncsn import get_score_model
from audiosourcesep_tpu_torch.ops import inversion
from audiosourcesep_tpu_torch.ops import winograd as W
from audiosourcesep_tpu_torch.ops.stft import istft, stft

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
                                        ((2, 8, 8, 192), 384)])
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
