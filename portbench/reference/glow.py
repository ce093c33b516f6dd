"""Glow (Kingma & Dhariwal 2018) on mel-spectrogram patches in dB, as the
reference repository trains it (``configs/melspec_glow.yml``), in plain
PyTorch: its log-density and its score ``grad_x log p(x)``, for K
sources' flows at once (inputs ``[K, N, H, W, C]``, parameters stacked on
a leading source axis).

The flow, from its description, on NHWC ``x`` in data scale (dB):

* rescale ``u = (x - min) / (max - min) - 0.5`` (no logit);
* L blocks: a squeeze (2x2 space to depth: ``[N, H/2, 2, W/2, 2, C]``
  taken as ``[N, H/2, W/2, C, 2, 2]``), then K steps of ActNorm
  (``x exp(s) + b``), an invertible 1x1 conv ``x W`` with
  ``W = P (L + I) (U + diag(sign_s exp(log_s)))``, and an affine coupling:
  of the channels' halves ``xa | xb``, ``ya = exp(tanh(log_s)) xa + t``
  where ``log_s | t`` (channel halves) = conv3x3(bn(relu(conv1x1(bn(relu(
  conv3x3(xb))))))), bn the frozen ``gamma x / sqrt(1 + 1e-3) + beta``;
* after each block but the last, half the channels are factored out and
  reshaped (plain NHWC reshape) to the last block's resolution; the
  latent is their concatenation with the last block's output;
* the prior is a diagonal normal with a learnt mean and log-scale over the
  latent.

The log-determinants of the rescaling, ActNorm and the 1x1 conv do not
depend on ``x`` and are left out of :func:`log_prob`: the score, the only
thing the separation takes from the flow, does not see them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision

Spec = Tuple[str, Tuple[int, ...], tuple]

_LOG_2PI = math.log(2.0 * math.pi)
_ROOT = "bijector.glow_multiscale_1"


def _levels(cfg: dict):
    """(block name, channels inside the block, H, W) for each block."""
    h, w, c = cfg["data_shape"]
    out = []
    for level in range(cfg["L"]):
        h, w, c = h // 2, w // 2, 4 * c
        out.append((f"block{level + 1}", c, h, w))
        c //= 2
    return out


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter's name, shape and draw (see ``portbench.weights``):
    ``("plu", C)`` marks the five factors of one invertible 1x1 conv,
    drawn together from a random rotation."""
    f = cfg["n_filters"]
    specs: List[Spec] = []
    for block, c, _, _ in _levels(cfg):
        for k in range(1, cfg["K"] + 1):
            s = f"{_ROOT}.{block}.glow_step_{k}"
            specs += [(f"{s}.actnorm_0.log_scale", (c,), ("zeros",)),
                      (f"{s}.actnorm_0.shift", (c,), ("zeros",))]
            specs += [(f"{s}.inv1x1_1.{n}", shape, ("plu", c))
                      for n, shape in (("P", (c, c)), ("L", (c, c)),
                                       ("U", (c, c)), ("sign_s", (c,)),
                                       ("log_s", (c,)))]
            net = f"{s}.coupling_split_2.net"
            specs += [(f"{net}.conv1.kernel", (f, c // 2, 3, 3),
                       ("glorot",)),
                      (f"{net}.conv1.bias", (f,), ("zeros",)),
                      (f"{net}.bn1.gamma", (f,), ("ones",)),
                      (f"{net}.bn1.beta", (f,), ("zeros",)),
                      (f"{net}.conv2.kernel", (f, f, 1, 1), ("glorot",)),
                      (f"{net}.conv2.bias", (f,), ("zeros",)),
                      (f"{net}.bn2.gamma", (f,), ("ones",)),
                      (f"{net}.bn2.beta", (f,), ("zeros",)),
                      (f"{net}.conv3.kernel", (c, f, 3, 3),
                       ("normal", 0.0, cfg["init"]["coupling_conv3_std"])),
                      (f"{net}.conv3.bias", (c,), ("zeros",))]
    _, c, h, w = _levels(cfg)[-1]
    c_base = c * 2 ** (cfg["L"] - 1)
    specs += [("prior.loc", (h, w, c_base), ("zeros",)),
              ("prior.log_scale", (h, w, c_base), ("zeros",))]
    return specs


def _squeeze(x):
    src, n, h, w, c = x.shape
    return x.reshape(src, n, h // 2, 2, w // 2, 2, c).permute(
        0, 1, 2, 4, 6, 3, 5).reshape(src, n, h // 2, w // 2, 4 * c)


def _channels(t):                 # [K, C] -> [K, 1, C, 1, 1]
    return t[:, None, :, None, None]


def _frozen_bn(h, gamma, beta):
    return _channels(gamma) * h / math.sqrt(1.0 + 1e-3) + _channels(beta)


def _coupling_net(p, net, xb, prec: Precision):
    h = xb.permute(0, 1, 4, 2, 3)
    h = F.relu(prec.conv2d(h, p[f"{net}.conv1.kernel"],
                           p[f"{net}.conv1.bias"]))
    h = _frozen_bn(h, p[f"{net}.bn1.gamma"], p[f"{net}.bn1.beta"])
    w2 = p[f"{net}.conv2.kernel"][..., 0, 0].transpose(1, 2)
    h = prec.matmul(h.permute(0, 1, 3, 4, 2), w2) \
        + p[f"{net}.conv2.bias"][:, None, None, None, :]
    h = F.relu(h).permute(0, 1, 4, 2, 3)
    h = _frozen_bn(h, p[f"{net}.bn2.gamma"], p[f"{net}.bn2.beta"])
    out = prec.conv2d(h, p[f"{net}.conv3.kernel"], p[f"{net}.conv3.bias"])
    log_s, t = out.permute(0, 1, 3, 4, 2).chunk(2, dim=-1)
    return torch.tanh(log_s), t


def weights_1x1(params: Dict[str, torch.Tensor], cfg: dict) -> dict:
    """Each invertible 1x1 conv's ``W [K, C, C]``, assembled once."""
    out = {}
    for block, c, _, _ in _levels(cfg):
        eye = torch.eye(c, device=params["prior.loc"].device)
        for k in range(1, cfg["K"] + 1):
            q = f"{_ROOT}.{block}.glow_step_{k}.inv1x1_1"
            lower = torch.tril(params[f"{q}.L"], -1) + eye
            upper = torch.triu(params[f"{q}.U"], 1) + torch.diag_embed(
                params[f"{q}.sign_s"] * torch.exp(params[f"{q}.log_s"]))
            out[q] = params[f"{q}.P"] @ (lower @ upper)
    return out


def _step(p, w1x1, s, x, prec: Precision):
    x = x * torch.exp(p[f"{s}.actnorm_0.log_scale"])[:, None, None, None] \
        + p[f"{s}.actnorm_0.shift"][:, None, None, None]
    x = prec.matmul(x, w1x1[f"{s}.inv1x1_1"])
    xa, xb = x.chunk(2, dim=-1)
    log_s, t = _coupling_net(p, f"{s}.coupling_split_2.net", xb, prec)
    ya = prec.act(torch.exp(log_s) * xa + t)
    return torch.cat([ya, xb], dim=-1), log_s.sum(dim=(2, 3, 4))


def log_prob(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
             prec: Precision = None, w1x1: dict = None) -> torch.Tensor:
    """``log p(x) [K, N]`` of NHWC ``x [K, N, H, W, C]`` in dB under the K
    sources' flows (parameters stacked on a leading axis), up to a
    constant in ``x``; ``w1x1`` the assembled 1x1 convs, if made
    already."""
    prec = prec or Precision()
    w1x1 = w1x1 if w1x1 is not None else weights_1x1(params, cfg)
    lo, hi = cfg["data_range"]
    h = (x - lo) / (hi - lo) - 0.5
    src, n = x.shape[:2]
    levels = _levels(cfg)
    _, _, bh, bw = levels[-1]
    zs, ldj = [], torch.zeros(src, n, dtype=x.dtype, device=x.device)
    for i, (block, _, _, _) in enumerate(levels):
        h = _squeeze(h)
        for k in range(1, cfg["K"] + 1):
            h, ld = _step(params, w1x1, f"{_ROOT}.{block}.glow_step_{k}", h,
                          prec)
            ldj = ldj + ld
        if i < len(levels) - 1:
            z, h = h.chunk(2, dim=-1)
            zs.append(z.reshape(src, n, bh, bw, -1))
        else:
            zs.append(h)
    z = torch.cat(zs, dim=-1)
    ls = params["prior.log_scale"][:, None]
    u = (z - params["prior.loc"][:, None]) * torch.exp(-ls)
    prior = (-0.5 * (u * u + _LOG_2PI) - ls).sum(dim=(2, 3, 4))
    return prior + ldj


def score(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
          prec: Precision = None, w1x1: dict = None) -> torch.Tensor:
    """``grad_x log p(x)`` of NHWC ``x [K, N, H, W, C]`` in dB, each
    source under its own flow."""
    with torch.enable_grad():
        v = x.detach().requires_grad_(True)
        return torch.autograd.grad(
            log_prob(params, v, cfg, prec, w1x1).sum(), v)[0]
