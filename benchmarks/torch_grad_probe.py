#!/usr/bin/env python3
"""Gradients of the ops the NCSN v1 score network uses, on a CUDA card and
on the CPU, against float64 on the CPU.

    python3 benchmarks/torch_grad_probe.py

For each op (the CRP's 5x5 SAME average pool that counts valid cells, the
2x2 pool, the bilinear upsampling, ELU, the 3x3 convs at d = 1, 2, 4 and
with one input channel, InstanceNorm2d+, the embedding gather) it prints
||grad - grad_f64|| / ||grad_f64|| in float32 with channels_last (``cl``)
and contiguous (``cf``) input on each device, TF32 off. ``F.avg_pool2d``
is the library op; ``nn.avg_pool_same`` is the port's (whose backward
goes through the pool's forward). Then one small v1 model's gradients on
each device against float64, worst tensors first. A backward kernel that
is wrong on one device and layout shows as an error near 1 where the
others sit near 1e-7.
"""

import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from audiosourcesep_tpu_torch import nn  # noqa: E402
from audiosourcesep_tpu_torch.models.ncsn import (dsm_loss,  # noqa: E402
                                                  get_score_model,
                                                  get_sigmas)
from audiosourcesep_tpu_torch.models.ncsn.layers import \
    _norm2dplus  # noqa: E402

DEVICES = ("cuda", "cpu")
LAYOUTS = (("cl", torch.channels_last), ("cf", torch.contiguous_format))


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


def input_grads(name, fn, shape, g):
    x = torch.randn(*shape, generator=g, dtype=torch.float64)
    w = torch.randn(fn(x).shape, generator=g, dtype=torch.float64)

    def grad(dev, dtype, layout):
        xi = x.to(dev, dtype).contiguous(
            memory_format=layout).detach().requires_grad_()
        (fn(xi) * w.to(dev, dtype)).sum().backward()
        return xi.grad

    ref = grad("cpu", torch.float64, torch.contiguous_format)
    print(f"{name:42s}", " ".join(
        f"{d}/{n} {rel(grad(d, torch.float32, lay), ref):.1e}"
        for d in DEVICES for n, lay in LAYOUTS))


def kernel_grads(name, cin, cout, d, g):
    x = torch.randn(4, cin, 24, 16, generator=g, dtype=torch.float64)
    k = torch.randn(cout, cin, 3, 3, generator=g, dtype=torch.float64)
    w = torch.randn(4, cout, 24, 16, generator=g, dtype=torch.float64)

    def grad(dev, dtype, layout):
        ki = k.to(dev, dtype).detach().requires_grad_()
        xi = x.to(dev, dtype).contiguous(memory_format=layout)
        (F.conv2d(xi, ki, padding=d, dilation=d)
         * w.to(dev, dtype)).sum().backward()
        return ki.grad

    ref = grad("cpu", torch.float64, torch.contiguous_format)
    print(f"{name:42s}", " ".join(
        f"{dv}/{n} {rel(grad(dv, torch.float32, lay), ref):.1e}"
        for dv in DEVICES for n, lay in LAYOUTS))


def model_grads(dev, dtype, x, idx, z, sigmas):
    m = get_score_model("v1", (32, 16, 1), 8, 10)
    m.reset_parameters(torch.Generator().manual_seed(0))
    m = m.to(dev, dtype)
    loss = dsm_loss(m, x.to(dev, dtype),
                    torch.as_tensor(sigmas, device=dev, dtype=dtype),
                    sigma_idx=idx.to(dev), noise=z.to(dev, dtype))
    loss.backward()
    return loss.item(), {n: p.grad for n, p in m.named_parameters()}


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.__version__, torch.cuda.get_device_name(0))
    g = torch.Generator().manual_seed(0)
    shape = (4, 16, 24, 16)
    input_grads("F.avg_pool2d 5x5 SAME, valid cells", lambda x: F.avg_pool2d(
        x, 5, 1, 2, count_include_pad=False), shape, g)
    input_grads("nn.avg_pool_same 5x5", lambda x: nn.avg_pool_same(x, 5),
                shape, g)
    input_grads("avg_pool2d 2x2", lambda x: F.avg_pool2d(x, 2, 2), shape, g)
    input_grads("bilinear 12x8 -> 24x16", lambda x: F.interpolate(
        x, size=(24, 16), mode="bilinear", align_corners=False),
        (4, 16, 12, 8), g)
    input_grads("elu", F.elu, shape, g)
    for d in (1, 2, 4):
        k = torch.randn(16, 16, 3, 3, generator=g, dtype=torch.float64)
        input_grads(f"conv3x3 d={d}, x", lambda x, k=k, d=d: F.conv2d(
            x, k.to(x.device, x.dtype), padding=d, dilation=d), shape, g)
    k1 = torch.randn(16, 1, 3, 3, generator=g, dtype=torch.float64)
    input_grads("conv3x3 C_in 1, x", lambda x: F.conv2d(
        x, k1.to(x.device, x.dtype), padding=1), (4, 1, 24, 16), g)
    rows = [torch.randn(4, 16, generator=g, dtype=torch.float64)
            for _ in range(3)]
    input_grads("InstanceNorm2d+", lambda x: _norm2dplus(
        x, *[r.to(x.device, x.dtype) for r in rows]), shape, g)
    kernel_grads("conv3x3 C_in 1, kernel", 1, 16, 1, g)
    kernel_grads("conv3x3 d=1, kernel", 16, 16, 1, g)
    kernel_grads("conv3x3 d=2, kernel", 16, 16, 2, g)
    emb = torch.randn(10, 16, generator=g, dtype=torch.float64)
    y = torch.tensor([3, 3, 7, 0])
    ref = emb.clone().requires_grad_()
    (ref[y] * torch.arange(64.0, dtype=torch.float64).reshape(4, 16)
     ).sum().backward()
    for dev in DEVICES:
        e = emb.to(dev, torch.float32).requires_grad_()
        (e[y.to(dev)] * torch.arange(64.0, device=dev).reshape(4, 16)
         ).sum().backward()
        print(f"{'embedding gather, ' + dev:42s} {rel(e.grad, ref.grad):.1e}")

    sigmas = get_sigmas(1.0, 0.01, 10, "logarithmic")
    gg = torch.Generator().manual_seed(1)
    x = torch.rand(4, 32, 16, 1, generator=gg)
    idx = torch.randint(10, (4,), generator=gg)
    z = torch.randn(4, 32, 16, 1, generator=gg)
    l64, ref = model_grads("cpu", torch.float64, x, idx, z, sigmas)
    for dev in DEVICES:
        loss, grads = model_grads(dev, torch.float32, x, idx, z, sigmas)
        worst = sorted(((rel(grads[n], ref[n]), n) for n in ref),
                       reverse=True)[:5]
        print(f"v1 8 filters [4, 32, 16, 1] on {dev}: loss {loss:.6f} "
              f"(float64 {l64:.6f}); worst gradients "
              + ", ".join(f"{n} {e:.1e}" for e, n in worst))


if __name__ == "__main__":
    main()
