"""The fused bias -> ReLU -> frozen BN of the Glow coupling nets
(``audiosourcesep_tpu_torch/ops/bias_relu_bn.py``) on the CPU: the op
against the PyTorch ops the nets ran before it, and its wrapper. The
kernels themselves (``csrc/bias_relu_bn.cu``) run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py --brbn``; the nets are
held to the JAX package in ``tests/test_torch_flows.py`` and
``tests/test_torch_glow.py``."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from audiosourcesep_tpu_torch import nn
from audiosourcesep_tpu_torch.bijectors import ShiftAndLogScaleConvNet
from audiosourcesep_tpu_torch.kernels import build
from audiosourcesep_tpu_torch.ops import bias_relu_bn as BRB
from audiosourcesep_tpu_torch.ops import counting

SRC = pathlib.Path(BRB.__file__).parent.parent / "csrc" / "bias_relu_bn.cu"
DTYPES = [torch.float32, torch.bfloat16]
# NCHW shapes: a few channels, an odd count, Glow's 512 at a small map
SHAPES = [(2, 16, 6, 4), (3, 13, 5, 7), (1, 512, 4, 2)]


def _bits(t):
    """``t``'s bits, NCHW order (NaN payloads and signs of zero too)."""
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int16)


def _inputs(shape, dtype, seed=0, specials=True):
    """h (NCHW, ``channels_last``) in ``dtype`` and float32 bias, gamma,
    beta; with ``specials`` h holds a NaN, infinities and a -0 whose
    channel's bias is -0 (so h + b is -0)."""
    g = torch.Generator().manual_seed(seed)
    n, c, hh, w = shape
    h = torch.randn(shape, generator=g).to(dtype)
    bias = 0.5 * torch.randn(c, generator=g)
    gamma = torch.randn(c, generator=g)
    beta = 0.5 * torch.randn(c, generator=g)
    if specials:
        h[0, 0, 0, 0] = float("nan")
        h[0, 1, 0, 1] = float("inf")
        h[0, 1, 1, 0] = -float("inf")
        h[-1, 2, -1, -1] = -0.0
        bias[2] = -0.0
    return (h.contiguous(memory_format=torch.channels_last), bias, gamma,
            beta)


def _old_chain(h, bias, gamma, beta):
    """The PyTorch ops the coupling nets ran: ``nn.conv2d``'s (or
    ``nn.conv1x1``'s) bias add, ``nn.relu``, ``nn.frozen_batchnorm``."""
    return nn.frozen_batchnorm(nn.relu(h + bias.to(h.dtype)[:, None, None]),
                               gamma, beta)


def test_imports_and_runs_on_the_cpu_with_no_nvcc_and_no_card():
    """Importing the op (and the nets that call it) builds and loads
    nothing: a process with no CUDA toolkit on its PATH and no card runs a
    coupling net forward and backward and counts no launch."""
    code = ("import torch\n"
            "from audiosourcesep_tpu_torch.bijectors import "
            "ShiftAndLogScaleConvNet\n"
            "from audiosourcesep_tpu_torch.kernels import build\n"
            "from audiosourcesep_tpu_torch.ops import counting\n"
            "net = ShiftAndLogScaleConvNet(2, 8)\n"
            "net.reset_parameters(torch.Generator().manual_seed(0))\n"
            "x = torch.randn(1, 4, 6, 2, requires_grad=True)\n"
            "s, t = net(x)\n"
            "(s.sum() + t.sum()).backward()\n"
            "assert build._lib is None\n"
            "assert counting.COUNTS['bias_relu_bn']['launch_count'] == 0\n")
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": str(pathlib.Path(__file__).parent.parent),
           "JAX_PLATFORMS": "cpu"}
    got = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr


def test_signatures_list_the_entries():
    """``kernels.build.SIGNATURES`` binds each C entry of
    csrc/bias_relu_bn.cu with as many arguments as the source declares."""
    src = SRC.read_text()
    for name in (*BRB.ENTRIES.values(), "bias_relu_bn_blocks_per_sm"):
        assert name in build.SIGNATURES, name
        decl = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert decl, name
        assert len(build.SIGNATURES[name][0]) == len(decl.group(1)
                                                     .split(",")), name


def test_kernel_constants_are_the_cuda_sources():
    """The wrapper's copies of csrc/bias_relu_bn.cu's limits and kinds."""
    src = SRC.read_text()
    for name, value in (("BYTES", BRB.BYTES), ("THREADS", BRB.THREADS),
                        ("MAX_N", BRB.MAX_N)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "enum { FWD = %d, BWD = %d };" % (BRB.KINDS["fwd"],
                                             BRB.KINDS["bwd"]) in src


@pytest.mark.parametrize("c,bf16,want", [
    # Glow's 512 channels: 128 groups of 4 f32 by 2 rows, 64 of 8 bf16 by
    # 4; an odd count; one channel; more groups than a block's threads
    (512, False, (128, 2)), (512, True, (64, 4)), (13, False, (4, 64)),
    (13, True, (2, 128)), (1, False, (1, 256)), (4096, False, (256, 1))])
def test_block_shape(c, bf16, want):
    g, r = BRB.block_shape(c, bf16)
    assert (g, r) == want and g * r <= BRB.THREADS


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_equals_the_old_chain_bit_for_bit(shape, dtype):
    """Each op rounds to h's dtype in turn, as the old chain's did: the
    same bits, NaN, infinities and the sign of zero included, in
    ``channels_last`` memory."""
    h, bias, gamma, beta = _inputs(shape, dtype)
    got = nn.bias_relu_frozen_batchnorm(h, bias, gamma, beta)
    want = _old_chain(h, bias, gamma, beta)
    assert got.dtype == dtype and got.shape == h.shape
    assert torch.equal(_bits(got), _bits(want))
    assert torch.isnan(got).any() and got.is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_input_gradient_equals_the_old_chains_bit_for_bit(shape, dtype,
                                                          layout):
    """The input gradient is autograd's for the old chain (``gy * g``, then
    zero where h + b <= 0, NaN passing), with gy in NHWC or NCHW memory."""
    h, bias, gamma, beta = _inputs(shape, dtype, specials=False)
    h[0, 0, 0, 0] = float("nan")
    g = torch.Generator().manual_seed(1)
    gy = torch.randn(shape, generator=g).to(dtype)
    gy = gy.contiguous(memory_format=torch.channels_last) \
        if layout == "nhwc" else gy.contiguous()
    grads = []
    for fn in (nn.bias_relu_frozen_batchnorm, _old_chain):
        x = h.detach().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x, bias, gamma, beta), x,
                                         gy)[0])
    assert torch.equal(_bits(grads[0]), _bits(grads[1]))
    assert (grads[0] == 0).any() and (grads[0] != 0).any()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_parameter_gradients_match_the_old_chains(shape, dtype):
    """Training's gradients of bias, gamma and beta are sums over N, H and
    W: the old chain's within the order of the f32 sums (one bf16 ulp in
    bf16)."""
    h, bias, gamma, beta = _inputs(shape, dtype, specials=False)
    gy = torch.randn(shape, generator=torch.Generator().manual_seed(2)
                     ).to(dtype)
    got = []
    for fn in (nn.bias_relu_frozen_batchnorm, _old_chain):
        ps = [t.detach().requires_grad_(True) for t in (h, bias, gamma,
                                                        beta)]
        got.append(torch.autograd.grad(fn(*ps), ps, gy))
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for name, a, b in zip(("h", "bias", "gamma", "beta"), *got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= rtol * scale, name


def test_rows_are_cached_until_a_parameter_changes(monkeypatch):
    """The rows (b, g, beta) in h's dtype are formed once a parameter
    version: a hit returns the cached tensor; an in-place write, another
    tensor or another dtype forms them again; a miss while a CUDA graph
    captures raises, a hit does not."""
    _, bias, gamma, beta = _inputs((1, 6, 2, 2), torch.float32)
    cache = {}
    p = BRB.params(bias, gamma, beta, torch.float32, cache=cache)
    assert torch.equal(p[1], nn.frozen_batchnorm(
        torch.ones(1, 6, 1, 1), gamma, torch.zeros(6))[0, :, 0, 0])
    assert torch.equal(p[0], bias) and torch.equal(p[2], beta)
    assert BRB.params(bias, gamma, beta, torch.float32, cache=cache) is p
    with torch.no_grad():
        gamma.mul_(2.0)
    p2 = BRB.params(bias, gamma, beta, torch.float32, cache=cache)
    assert p2 is not p and torch.equal(p2[1], 2.0 * p[1])
    p3 = BRB.params(bias.clone(), gamma, beta, torch.float32, cache=cache)
    assert p3 is not p2
    p4 = BRB.params(bias, gamma, beta, torch.bfloat16, cache=cache)
    assert p4.dtype == torch.bfloat16
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert BRB.params(bias, gamma, beta, torch.bfloat16, cache=cache) is p4
    with pytest.raises(RuntimeError, match="captures"):
        BRB.params(bias, gamma, beta, torch.float32, cache=cache)
    # no cache: nothing to miss
    assert torch.equal(BRB.params(bias, gamma, beta, torch.float32), p3)


@pytest.mark.parametrize("call", ["forward", "input_grad"])
def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing(call):
    """The kernel's wrappers take only CUDA tensors (the op takes the
    PyTorch ops on a CPU tensor before reaching them), and on the CPU the
    counters do not move."""
    h, bias, gamma, beta = _inputs((1, 8, 2, 2), torch.float32)
    p = BRB.params(bias, gamma, beta, torch.float32)
    before = counting.snapshot()
    with pytest.raises(ValueError, match="CUDA"):
        if call == "forward":
            BRB._forward_cuda(h, p)
        else:
            BRB._input_grad_cuda(h, h, p)
    x = h.detach().requires_grad_(True)
    nn.bias_relu_frozen_batchnorm(x, bias, gamma, beta).sum().backward()
    assert counting.since(before)["bias_relu_bn"] == {
        "launch_count": 0, "layout_copies": 0,
        "launch_counts": {"fwd": 0, "bwd_nhwc": 0, "bwd_nchw": 0}}


def _net_before(net, x):
    """``ShiftAndLogScaleConvNet.forward`` as it was: each conv with its
    bias, then ``nn.relu`` and the norm module."""
    h = nn.relu(net.conv1(x.permute(0, 3, 1, 2)))
    h = net.bn1(h)
    h = nn.relu(nn.conv1x1(h, net.conv2.kernel, net.conv2.bias))
    h = net.bn2(h)
    log_s, t = net.conv3(h).permute(0, 2, 3, 1).chunk(2, dim=-1)
    return torch.tanh(log_s), t


@pytest.mark.parametrize("train", [False, True])
def test_coupling_net_fuses_both_sites(monkeypatch, train):
    """The coupling net calls the op twice (after its 3x3 and its 1x1
    conv, with each conv's bias) and, routed as on the card, gives the
    old forward's output and input gradient bit for bit; with its
    parameters trained, their gradients within the f32 sums' order."""
    g = torch.Generator().manual_seed(3)
    net = ShiftAndLogScaleConvNet(2, 16)
    net.reset_parameters(g)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=g))
    net.requires_grad_(train)
    calls = []
    real = BRB.bias_relu_bn

    def counted(h, bias, *args, **kwargs):
        calls.append(bias)
        return real(h, bias, *args, **kwargs)

    monkeypatch.setattr(BRB, "bias_relu_bn", counted)
    x = torch.randn(2, 6, 4, 2, generator=g)
    out = {}
    try:
        nn.set_winograd(True)
        for name, fn in (("fused", net), ("before", lambda x:
                                          _net_before(net, x))):
            xi = x.clone().requires_grad_(True)
            log_s, t = fn(xi)
            loss = (log_s * 1.5 + t).sum()
            wrt = [xi, *net.parameters()] if train else [xi]
            out[name] = (log_s, t, *torch.autograd.grad(loss, wrt))
    finally:
        nn.set_winograd(False)
    assert calls[0] is net.conv1.bias and calls[1] is net.conv2.bias
    assert len(calls) == 2
    for a, b in zip(out["fused"][:3], out["before"][:3]):
        assert torch.equal(a, b)
    for a, b in zip(out["fused"][3:], out["before"][3:]):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-6)
