"""Flow++ (Ho, Chen, Srinivas, Duan & Abbeel 2019, "Flow++: Improving
Flow-Based Generative Models with Variational Dequantization and
Architecture Design", arXiv:1902.00275) over mel frames in dB, in plain
PyTorch: its log-density and its score ``grad_x log p(x)``, for K sources'
flows at once (inputs ``[K, N, H, W, C]``, parameters stacked on a leading
source axis).

The flow, from its description, on NHWC ``x`` in data scale (dB):

* rescale ``u = (x - min) / (max - min) - 0.5``;
* the CIFAR-10 topology: 4 checkerboard couplings at ``(H, W, C)``, a
  squeeze (2x2 space to depth: ``[N, H/2, 2, W/2, 2, C]`` taken as ``[N,
  H/2, W/2, C, 2, 2]``), 2 channel couplings and 3 checkerboard couplings
  at ``(H/2, W/2, 4C)``; coupling ``i`` of a stage swaps the roles of its
  halves when ``i`` is odd;
* a coupling layer: ActNorm per element (``x exp(s) + b``, ``s``, ``b`` of
  the event's shape), an invertible 1x1 conv ``x W`` with ``W = P (L + I)
  (U + diag(sign_s exp(log_s)))``, and the mixture-of-logistics coupling:
  of the halves ``x1 | x2`` (channel halves, or the even and odd columns
  for a checkerboard), ``y2 = logit(F(x2)) exp(a) + b`` with ``F`` the CDF
  of a mixture of K logistics ``sum_k pi_k sigmoid((x2 - mu_k)
  exp(-max(log s_k, -7)))``, F clipped to ``[1e-10, 1 - 1e-7]``; ``(a, b,
  pi, mu, log s) = net(x1)``, ``a`` through a tanh; its log-determinant is
  ``log f(x2) - log F - log(1 - F) + a`` with ``f`` the mixture density;
* the net: ``h = conv3x3(x1)`` (C -> F filters), then blocks of

      h <- LN(h + GLU(concat_elu(conv3x3(concat_elu(h)))))
      h <- LN(h + GLU(MHSA(h + pos)))

  with ``concat_elu(h) = elu([-h, h])``, ``GLU(h) = A | B -> A
  sigmoid(B)`` after a dense layer (2F -> 2F, F -> 2F), ``LN`` the layer
  norm over the channels (eps 1e-3 inside the root, a gain and a bias),
  ``pos`` a learnt embedding of every position, and MHSA ``softmax(q k^T
  / sqrt(d)) v`` over every position for each of the heads (q, k, v
  from one dense layer F -> 3F, ``d = F / heads``), written as two
  matmuls and a plain softmax (its ``[heads, T, T]`` weights recomputed
  for the backward rather than kept, so that every frame fits at once:
  kept, the first stage's would take ~7 GB a frame and a source); then
  ``conv3x3`` (F -> C (2 + 3K));
* the prior is a standard normal over the latent.

Departures from Ho et al.: no variational dequantisation, and no logit
(the frames are continuous dB, rescaled as the melspec Glow rescales
them); no dropout (the prior runs in evaluation). The log-determinants of
the rescaling, ActNorm and the 1x1 conv do not depend on ``x`` and are
left out of :func:`log_prob`, and so are the prior's constants.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Precision

Spec = Tuple[str, Tuple[int, ...], tuple]

_ROOT = "bijector.flowpp_cifar10_0"
_CLIP_LO, _CLIP_HI = 1e-10, 1.0 - 1e-7
_MIN_LOG_SCALE = -7.0


def _stages(cfg: dict):
    """(stage name, layers, split, event shape) of each coupling stage."""
    h, w, c = cfg["data_shape"]
    sq = (h // 2, w // 2, 4 * c)
    return [("block1", 4, "checkerboard", (h, w, c)),
            ("block2", 2, "channel", sq),
            ("block3", 3, "checkerboard", sq)]


def _net_shape(split: str, shape) -> tuple:
    h, w, c = shape
    return (h, w, c // 2) if split == "channel" else (h, w // 2, c)


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter's name, shape and draw (see ``portbench.weights``),
    named as the port's melspec Flow++ names them."""
    f, k, heads = cfg["n_filters"], cfg["n_components"], cfg["heads"]
    if f % heads:
        raise ValueError(f"{f} filters over {heads} heads")
    specs: List[Spec] = []
    for stage, layers, split, shape in _stages(cfg):
        c = shape[-1]
        nh, nw, nc = _net_shape(split, shape)
        for i in range(layers):
            p = f"{_ROOT}.{stage}.layer_{i}"
            specs += [(f"{p}.actnorm.log_scale", shape, ("zeros",)),
                      (f"{p}.actnorm.shift", shape, ("zeros",))]
            specs += [(f"{p}.inv1x1.{n}", s, ("plu", c))
                      for n, s in (("P", (c, c)), ("L", (c, c)),
                                   ("U", (c, c)), ("sign_s", (c,)),
                                   ("log_s", (c,)))]
            net = f"{p}.coupling.net"
            specs += [(f"{net}.pos_emb", (nh, nw, f), ("normal", 0.0, 1.0)),
                      (f"{net}.conv_in.kernel", (f, nc, 3, 3), ("glorot",)),
                      (f"{net}.conv_in.bias", (f,), ("zeros",)),
                      (f"{net}.conv_out.kernel", (nc * (2 + 3 * k), f, 3, 3),
                       ("normal", 0.0, cfg["init"]["conv_out_std"])),
                      (f"{net}.conv_out.bias", (nc * (2 + 3 * k),),
                       ("zeros",))]
            for b in range(cfg["n_blocks"]):
                q = f"{net}.block_{b}"
                specs += [(f"{q}.conv.conv1.kernel", (f, 2 * f, 3, 3),
                           ("glorot",)),
                          (f"{q}.conv.conv1.bias", (f,), ("zeros",)),
                          (f"{q}.conv.glu.layer.kernel", (2 * f, 2 * f),
                           ("glorot",)),
                          (f"{q}.conv.glu.layer.bias", (2 * f,), ("zeros",)),
                          (f"{q}.ln1.gamma", (f,), ("ones",)),
                          (f"{q}.ln1.beta", (f,), ("zeros",)),
                          (f"{q}.attn.qkv.kernel", (f, 3 * f), ("glorot",)),
                          (f"{q}.attn.qkv.bias", (3 * f,), ("zeros",)),
                          (f"{q}.attn.glu.layer.kernel", (f, 2 * f),
                           ("glorot",)),
                          (f"{q}.attn.glu.layer.bias", (2 * f,), ("zeros",)),
                          (f"{q}.ln2.gamma", (f,), ("ones",)),
                          (f"{q}.ln2.beta", (f,), ("zeros",))]
    return specs


def weights_1x1(params: Dict[str, torch.Tensor], cfg: dict) -> dict:
    """Each invertible 1x1 conv's ``W [K, C, C]``, assembled once."""
    out = {}
    for stage, layers, _, shape in _stages(cfg):
        eye = torch.eye(shape[-1],
                        device=params[f"{_ROOT}.{stage}.layer_0.inv1x1.P"]
                        .device)
        for i in range(layers):
            q = f"{_ROOT}.{stage}.layer_{i}.inv1x1"
            lower = torch.tril(params[f"{q}.L"], -1) + eye
            upper = torch.triu(params[f"{q}.U"], 1) + torch.diag_embed(
                params[f"{q}.sign_s"] * torch.exp(params[f"{q}.log_s"]))
            out[q] = params[f"{q}.P"] @ (lower @ upper)
    return out


def _bias(t):                  # [K, C] -> [K, 1, 1, 1, C]
    return t[:, None, None, None, :]


def _conv(p, name, h, prec: Precision):
    """SAME 3x3 conv of NHWC ``h [K, N, H, W, C]``, NHWC out."""
    y = prec.conv2d(h.permute(0, 1, 4, 2, 3), p[f"{name}.kernel"],
                    p[f"{name}.bias"])
    return y.permute(0, 1, 3, 4, 2)


def _dense(p, name, h, prec: Precision):
    return prec.act(prec.matmul(h, p[f"{name}.kernel"])
                    + _bias(p[f"{name}.bias"]))


def _concat_elu(h):
    return F.elu(torch.cat([-h, h], dim=-1))


def _glu(p, name, h, prec: Precision):
    # A | B -> A sigmoid(B)
    return F.glu(_dense(p, f"{name}.layer", h, prec), dim=-1)


def _layer_norm(p, name, h):
    # (h - mean) / sqrt(var + 1e-3) gamma + beta over the channels, var
    # the population's; gamma and beta a source each
    src, c = h.shape[0], h.shape[-1]
    return torch.stack([F.layer_norm(h[i], (c,), p[f"{name}.gamma"][i],
                                     p[f"{name}.beta"][i], eps=1e-3)
                        for i in range(src)])


def attention(q, k, v, prec: Precision):
    """``softmax(q k^T / sqrt(d)) v`` of ``[K, N, heads, T, d]`` q, k, v:
    two matmuls and a plain softmax. Counted (``prec.count``) as its two
    products, ``4 K N heads T^2 d`` FLOPs, each call's ``(N, heads, T, d)``
    kept a source in ``prec.attention``."""
    src, n, heads, t, d = q.shape
    if prec.count:
        prec.flops += 4 * src * n * heads * t * t * d
        calls = getattr(prec, "attention", [])
        prec.attention = calls + [(n, heads, t, d)] * src
    s = torch.matmul(prec.operand(q), prec.operand(k).transpose(-1, -2)) \
        / math.sqrt(d)
    w = torch.softmax(s, dim=-1)
    return prec.act(torch.matmul(prec.operand(w), prec.operand(v)))


def _gated_attn(p, name, h, pos, heads: int, prec: Precision):
    src, n, hh, ww, c = h.shape
    qkv = _dense(p, f"{name}.qkv", h + pos[:, None], prec)
    qkv = qkv.reshape(src, n, hh * ww, 3, heads, c // heads)
    q, k, v = qkv.permute(3, 0, 1, 4, 2, 5).unbind(dim=0)
    if torch.is_grad_enabled() and q.requires_grad:
        a = checkpoint(attention, q, k, v, prec, use_reentrant=False)
    else:
        a = attention(q, k, v, prec)
    a = a.transpose(2, 3).reshape(src, n, hh, ww, c)
    return h + _glu(p, f"{name}.glu", a, prec)


def _net(p, net, x1, cfg: dict, prec: Precision):
    k = cfg["n_components"]
    h = _conv(p, f"{net}.conv_in", x1, prec)
    pos = p[f"{net}.pos_emb"]
    for b in range(cfg["n_blocks"]):
        q = f"{net}.block_{b}"
        c = _conv(p, f"{q}.conv.conv1", _concat_elu(h), prec)
        h = h + _glu(p, f"{q}.conv.glu", _concat_elu(c), prec)
        h = _layer_norm(p, f"{q}.ln1", h)
        h = _layer_norm(p, f"{q}.ln2",
                        _gated_attn(p, f"{q}.attn", h, pos, cfg["heads"],
                                    prec))
    h = _conv(p, f"{net}.conv_out", h, prec)
    h = h.reshape(*h.shape[:-1], -1, 2 + 3 * k)
    logits, means, log_scales = h[..., 2:].chunk(3, dim=-1)
    return torch.tanh(h[..., 0]), h[..., 1], logits, means, log_scales


def _mixture(x, logits, means, log_scales):
    """(log F(x), log f(x)) of the mixture of logistics, x ``[...]``,
    parameters ``[..., K]``."""
    log_scales = torch.clamp(log_scales, min=_MIN_LOG_SCALE)
    log_pi = torch.log_softmax(logits, dim=-1)
    z = (x[..., None] - means) * torch.exp(-log_scales)
    log_cdf = torch.logsumexp(log_pi + F.logsigmoid(z), dim=-1)
    log_pdf = torch.logsumexp(log_pi + z - log_scales - 2.0 * F.softplus(z),
                              dim=-1)
    return log_cdf, log_pdf


def _split(x, split: str, swap: bool):
    if split == "channel":
        x1, x2 = x.chunk(2, dim=-1)
    else:
        src, n, h, w, c = x.shape
        r = x.reshape(src, n, h, w // 2, 2, c)
        x1, x2 = r[..., 0, :], r[..., 1, :]
    return (x2, x1) if swap else (x1, x2)


def _merge(y1, y2, split: str, swap: bool, shape):
    if swap:
        y1, y2 = y2, y1
    if split == "channel":
        return torch.cat([y1, y2], dim=-1)
    return torch.stack([y1, y2], dim=-2).reshape(shape)


def _coupling(p, w1x1, layer, x, split, swap, cfg, prec: Precision):
    x = x * torch.exp(p[f"{layer}.actnorm.log_scale"])[:, None] \
        + p[f"{layer}.actnorm.shift"][:, None]
    x = prec.matmul(x, w1x1[f"{layer}.inv1x1"])
    x1, x2 = _split(x, split, swap)
    log_s, t, logits, means, log_scales = _net(p, f"{layer}.coupling.net",
                                               x1, cfg, prec)
    log_cdf, log_pdf = _mixture(x2, logits, means, log_scales)
    u = torch.clamp(torch.exp(log_cdf), _CLIP_LO, _CLIP_HI)
    y2 = (torch.log(u) - torch.log1p(-u)) * torch.exp(log_s) + t
    ld = log_pdf - torch.log(u) - torch.log1p(-u) + log_s
    return _merge(x1, y2, split, swap, x.shape), ld.sum(dim=(2, 3, 4))


def _squeeze(x):
    src, n, h, w, c = x.shape
    return x.reshape(src, n, h // 2, 2, w // 2, 2, c).permute(
        0, 1, 2, 4, 6, 3, 5).reshape(src, n, h // 2, w // 2, 4 * c)


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
    ldj = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
    for stage, layers, split, _ in _stages(cfg):
        if stage == "block2":
            h = _squeeze(h)
        for i in range(layers):
            h, ld = _coupling(params, w1x1, f"{_ROOT}.{stage}.layer_{i}", h,
                              split, i % 2 == 1, cfg, prec)
            ldj = ldj + ld
    return -0.5 * (h * h).sum(dim=(2, 3, 4)) + ldj


def score(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: dict,
          prec: Precision = None, w1x1: dict = None) -> torch.Tensor:
    """``grad_x log p(x)`` of NHWC ``x [K, N, H, W, C]`` in dB, each
    source under its own flow."""
    with torch.enable_grad():
        v = x.detach().requires_grad_(True)
        return torch.autograd.grad(
            log_prob(params, v, cfg, prec, w1x1).sum(), v)[0]
