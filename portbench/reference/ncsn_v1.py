"""NCSN v1's score network, RefineNetDilated (Song & Ermon 2019, as the
reference repository's TensorFlow model and the JAX package build it), in
plain PyTorch.

``score(params, x, labels, prec)`` maps NHWC ``x`` in [0, 1] and one
noise-level index a sample to the score, NHWC, for K sources' networks at
once (``x [K, N, H, W, C]``, parameters stacked on a leading axis). v1: every norm is
InstanceNorm2d+ conditional on the noise level; the input is rescaled to
``2x - 1``; the output is not divided by sigma.

The model, from its description:

* ``begin_conv`` 3x3; four stacks of two residual blocks (``ngf``, then
  ``2 ngf`` halved by 2x2 average pooling, then dilation 2 and 4 at that
  resolution); four RefineNet blocks back up; norm, ELU, ``end_conv``.
* A residual block: norm, ELU, conv, norm, ELU, conv, plus its shortcut
  (identity, or a conv: 1x1 where it pools, else 3x3); pooled after both
  convs where it downsamples without dilation.
* A RefineNet block: per input two RCUs of two (norm, conv) stages each;
  where it fuses two inputs, MSF (norm, conv, bilinear resize with
  half-pixel centres, sum); CRP (ELU, then two stages of norm, 5x5 average
  pooling over the valid cells, conv, each added to the running sum); an
  output RCU of one, or at the last block three, blocks.
* InstanceNorm2d+: ``gamma_y * (g * (x - mu) / sqrt(var + 1e-3) + b)
  + alpha_y * (mu - mean_c mu) / sqrt(var_c mu + 1e-5) + beta_y``, with mu,
  var each channel's spatial mean and variance.

Where the bias of a conv is absent from the parameters, it has none.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .precision import Precision

Spec = Tuple[str, Tuple[int, ...], tuple]


def _blocks(ngf: int):
    """The residual blocks (name, C_in, C_out, resample, dilation) and the
    RefineNet blocks (name, input channels, features, end)."""
    res = [("res1_1", ngf, ngf, None, None), ("res1_2", ngf, ngf, None, None),
           ("res2_1", ngf, 2 * ngf, "down", None),
           ("res2_2", 2 * ngf, 2 * ngf, None, None),
           ("res3_1", 2 * ngf, 2 * ngf, "down", 2),
           ("res3_2", 2 * ngf, 2 * ngf, None, 2),
           ("res4_1", 2 * ngf, 2 * ngf, "down", 4),
           ("res4_2", 2 * ngf, 2 * ngf, None, 4)]
    refine = [("refine1", [2 * ngf], 2 * ngf, False),
              ("refine2", [2 * ngf, 2 * ngf], 2 * ngf, False),
              ("refine3", [2 * ngf, 2 * ngf], ngf, False),
              ("refine4", [ngf, ngf], ngf, True)]
    return res, refine


def _conv_spec(name, cin, cout, k, bias) -> List[Spec]:
    out = [(f"{name}.kernel", (cout, cin, k, k), ("glorot",))]
    if bias:
        out.append((f"{name}.bias", (cout,), ("zeros",)))
    return out


def _norm_spec(name, c, n_classes, embed_mean) -> List[Spec]:
    return [(f"{name}.in.gamma", (c,), ("ones",)),
            (f"{name}.in.beta", (c,), ("zeros",)),
            (f"{name}.embed_gamma", (n_classes, c),
             ("normal", embed_mean, 0.02)),
            (f"{name}.embed_alpha", (n_classes, c),
             ("normal", embed_mean, 0.02)),
            (f"{name}.embed_beta", (n_classes, c), ("zeros",))]


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter's name, shape and draw: ``("glorot",)`` (uniform,
    Glorot's limit from the OIHW shape), ``("zeros",)``, ``("ones",)`` or
    ``("normal", mean, std)``."""
    ngf, nc = cfg["n_filters"], cfg["num_classes"]
    c_data = cfg["data_shape"][-1]
    em = cfg["init"]["norm_embed_mean"]
    specs = _conv_spec("begin_conv", c_data, ngf, 3, True)
    res, refine = _blocks(ngf)
    for name, cin, cout, resample, d in res:
        mid = cin if resample == "down" else cout
        specs += _norm_spec(f"{name}.norm1", cin, nc, em)
        specs += _norm_spec(f"{name}.norm2", mid, nc, em)
        if d is not None:
            bias, sc = (True, True), (3, True)
        elif resample == "down":
            bias, sc = (False, True), (1, True)
        else:
            bias, sc = (False, False), (3, False)
        specs += _conv_spec(f"{name}.conv1", cin, mid, 3, bias[0])
        specs += _conv_spec(f"{name}.conv2", mid, cout, 3, bias[1])
        if not (cin == cout and resample is None):
            specs += _conv_spec(f"{name}.shortcut", cin, cout, *sc)
    for name, ins, feats, end in refine:
        for i, c in enumerate(ins):
            for k in range(4):
                specs += _norm_spec(f"{name}.adapt_{i}.norm_{k}", c, nc, em)
                specs += _conv_spec(f"{name}.adapt_{i}.conv_{k}", c, c, 3,
                                    False)
        for k in range(2 * (3 if end else 1)):
            specs += _norm_spec(f"{name}.output.norm_{k}", feats, nc, em)
            specs += _conv_spec(f"{name}.output.conv_{k}", feats, feats, 3,
                                False)
        if len(ins) > 1:
            for i, c in enumerate(ins):
                specs += _norm_spec(f"{name}.msf.norm_{i}", c, nc, em)
                specs += _conv_spec(f"{name}.msf.conv_{i}", c, feats, 3,
                                    True)
        for k in range(2):
            specs += _norm_spec(f"{name}.crp.norm_{k}", feats, nc, em)
            specs += _conv_spec(f"{name}.crp.conv_{k}", feats, feats, 3,
                                False)
    specs += _norm_spec("normalizer", ngf, nc, em)
    specs += _conv_spec("end_conv", ngf, c_data, 3, True)
    return specs


def _4d(fn, x, *args, **kw):
    """``fn`` of a 4-D (N, C, H, W) op over ``x [K, N, C, H, W]``."""
    src, n = x.shape[:2]
    y = fn(x.reshape(src * n, *x.shape[2:]), *args, **kw)
    return y.reshape(src, n, *y.shape[1:])


class _Net:
    """The K sources' networks side by side: activations ``[K, N, C, H,
    W]``, parameters with a leading source axis."""

    def __init__(self, p: Dict[str, torch.Tensor], y: torch.Tensor,
                 prec: Precision):
        self.p, self.y, self.prec = p, y, prec

    def conv(self, name, x, dilation=1):
        return self.prec.conv2d(x, self.p[f"{name}.kernel"],
                                self.p.get(f"{name}.bias"), dilation)

    def norm(self, name, x):
        p, y = self.p, self.y
        mu = x.mean(dim=(3, 4), keepdim=True)
        var = x.var(dim=(3, 4), keepdim=True, correction=0)
        xhat = (x - mu) / torch.sqrt(var + 1e-3)
        m = mu.mean(dim=2, keepdim=True)
        v = mu.var(dim=2, keepdim=True, correction=0)
        means = (mu - m) / torch.sqrt(v + 1e-5)

        def per_sample(t):          # [K, classes, C] -> [K, N, C, 1, 1]
            return t[:, y][..., None, None]

        def per_source(t):          # [K, C] -> [K, 1, C, 1, 1]
            return t[:, None, :, None, None]

        inner = per_source(p[f"{name}.in.gamma"]) * xhat \
            + per_source(p[f"{name}.in.beta"])
        out = per_sample(p[f"{name}.embed_gamma"]) * inner \
            + per_sample(p[f"{name}.embed_alpha"]) * means \
            + per_sample(p[f"{name}.embed_beta"])
        return self.prec.act(out)

    def residual(self, name, x, cin, cout, resample, d):
        dil = d or 1
        h = self.conv(f"{name}.conv1", F.elu(self.norm(f"{name}.norm1", x)),
                      dil)
        h = self.conv(f"{name}.conv2", F.elu(self.norm(f"{name}.norm2", h)),
                      dil)
        pool = resample == "down" and d is None
        if pool:
            h = _4d(F.avg_pool2d, h, 2, 2)
        if cin == cout and resample is None:
            sc = x
        else:
            sc = self.conv(f"{name}.shortcut", x, dil)
            if pool:
                sc = _4d(F.avg_pool2d, sc, 2, 2)
        return self.prec.act(sc + h)

    def rcu(self, name, x, n_blocks):
        for i in range(n_blocks):
            res = x
            for j in range(2):
                k = 2 * i + j
                x = self.conv(f"{name}.conv_{k}",
                              self.norm(f"{name}.norm_{k}", x))
            x = self.prec.act(x + res)
        return x

    def crp(self, name, x):
        x = F.elu(x)
        path = x
        for k in range(2):
            path = self.norm(f"{name}.norm_{k}", path)
            path = _4d(F.avg_pool2d, path, 5, 1, 2, count_include_pad=False)
            path = self.conv(f"{name}.conv_{k}", path)
            x = self.prec.act(x + path)
        return x

    def refine(self, name, xs, n_out_blocks, shape):
        hs = [self.rcu(f"{name}.adapt_{i}", x, 2) for i, x in enumerate(xs)]
        if len(hs) > 1:
            total = 0
            for i, h in enumerate(hs):
                h = self.conv(f"{name}.msf.conv_{i}",
                              self.norm(f"{name}.msf.norm_{i}", h))
                if tuple(h.shape[3:]) != tuple(shape):
                    h = _4d(F.interpolate, h, size=tuple(shape),
                            mode="bilinear", align_corners=False)
                total = total + h
            h = self.prec.act(total)
        else:
            h = hs[0]
        return self.rcu(f"{name}.output", self.crp(f"{name}.crp", h),
                        n_out_blocks)


def score(params: Dict[str, torch.Tensor], x: torch.Tensor,
          labels: torch.Tensor, cfg: dict,
          prec: Precision = None) -> torch.Tensor:
    """The K sources' scores of NHWC ``x [K, N, H, W, C]`` at noise levels
    ``labels [N]``, each source's network with its own parameters (the
    dict's tensors carry a leading source axis); float32 throughout unless
    ``prec`` is a control's."""
    prec = prec or Precision()
    net = _Net(params, labels, prec)
    h = prec.act((2.0 * x - 1.0).permute(0, 1, 4, 2, 3))
    h = net.conv("begin_conv", h)
    res, refine = _blocks(cfg["n_filters"])
    layers = []
    for i, (name, cin, cout, resample, d) in enumerate(res):
        h = net.residual(name, h, cin, cout, resample, d)
        if i % 2 == 1:
            layers.append(h)
    ref = None
    for i, (name, _, _, end) in enumerate(refine):
        skip = layers[-1 - i]
        xs = [skip] if ref is None else [skip, ref]
        ref = net.refine(name, xs, 3 if end else 1, skip.shape[3:])
    out = F.elu(net.norm("normalizer", ref))
    out = net.conv("end_conv", out)
    return out.permute(0, 1, 3, 4, 2)
