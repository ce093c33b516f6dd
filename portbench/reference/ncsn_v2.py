"""NCSN v2's score network, RefineNetDilated (Song & Ermon 2020,
"Improved Techniques for Training Score-Based Generative Models", as the
reference repository's ``score_network_v2.py`` builds it for the thesis),
in plain PyTorch.

``score(params, x, labels, cfg, prec, sigmas)`` maps NHWC ``x [K, N, H,
W, C]`` and one noise-level index a sample to the K sources' scores,
NHWC, each source's network with its own parameters (stacked on a leading
axis), float32 throughout unless ``prec`` is a control's.

The topology is v1's (``ncsn_v1``: the residual stacks, the four RefineNet
blocks, the resolutions and widths); v2 changes its layers:

* every norm is the unconditional InstanceNorm2d+, one row for every
  sample: ``gamma * (g * (x - mu) / sqrt(var + 1e-3) + b) + alpha * (mu -
  mean_c mu) / sqrt(var_c mu + 1e-5) + beta``, with mu, var each
  channel's spatial mean and variance, (g, b) the inner instance norm's
  affine. Only the residual blocks and the last layer have norms;
* an RCU block is two convs and the block's input added, with no norm and
  no activation; MSF is conv, bilinear resize (half-pixel centres), sum;
* CRP: ELU, then two stages of 5x5 SAME max pooling (the padding never
  wins) and a conv, each added to the running sum;
* the input is used as it is (no ``2x - 1``), and the output is divided by
  ``sigmas`` at each sample's level.

Departures from the published description (Song & Ermon's code), where the
thesis's TensorFlow code, and with it the port, differ: the RCU stages run
no ELU before their convs; the input is not rescaled to ``2x - 1``; the
instance norm has its own affine and epsilon 1e-3 (``tfa``'s), the means'
term is not scaled by gamma, and the variance of the means is the
population's; the resize uses half-pixel centres (``tf.image.resize``), not
aligned corners; gamma and alpha are drawn from N(``init.norm_mean``, 0.02)
where the published draw is N(1, 0.02) (the configuration says why).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from . import ncsn_v1
from .ncsn_v1 import Spec, _4d, _blocks, _conv_spec
from .precision import Precision


def _norm_spec(name, c, mean) -> List[Spec]:
    return [(f"{name}.in.gamma", (c,), ("ones",)),
            (f"{name}.in.beta", (c,), ("zeros",)),
            (f"{name}.alpha", (c,), ("normal", mean, 0.02)),
            (f"{name}.gamma", (c,), ("normal", mean, 0.02)),
            (f"{name}.beta", (c,), ("zeros",))]


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter's name, shape and draw, as ``ncsn_v1.param_specs``
    gives them."""
    ngf = cfg["n_filters"]
    c_data = cfg["data_shape"][-1]
    mean = cfg["init"]["norm_mean"]
    specs = _conv_spec("begin_conv", c_data, ngf, 3, True)
    res, refine = _blocks(ngf)
    for name, cin, cout, resample, d in res:
        mid = cin if resample == "down" else cout
        specs += _norm_spec(f"{name}.norm1", cin, mean)
        specs += _norm_spec(f"{name}.norm2", mid, mean)
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
                specs += _conv_spec(f"{name}.adapt_{i}.conv_{k}", c, c, 3,
                                    False)
        for k in range(2 * (3 if end else 1)):
            specs += _conv_spec(f"{name}.output.conv_{k}", feats, feats, 3,
                                False)
        if len(ins) > 1:
            for i, c in enumerate(ins):
                specs += _conv_spec(f"{name}.msf.conv_{i}", c, feats, 3,
                                    True)
        for k in range(2):
            specs += _conv_spec(f"{name}.crp.conv_{k}", feats, feats, 3,
                                False)
    specs += _norm_spec("normalizer", ngf, mean)
    specs += _conv_spec("end_conv", ngf, c_data, 3, True)
    return specs


class _Net(ncsn_v1._Net):
    """v1's network with v2's norm, RCU, CRP and MSF."""

    def norm(self, name, x):
        p = self.p
        mu = x.mean(dim=(3, 4), keepdim=True)
        var = x.var(dim=(3, 4), keepdim=True, correction=0)
        xhat = (x - mu) / torch.sqrt(var + 1e-3)
        m = mu.mean(dim=2, keepdim=True)
        v = mu.var(dim=2, keepdim=True, correction=0)
        means = (mu - m) / torch.sqrt(v + 1e-5)

        def row(t):                 # [K, C] -> [K, 1, C, 1, 1]
            return p[f"{name}.{t}"][:, None, :, None, None]

        out = row("gamma") * (row("in.gamma") * xhat + row("in.beta")) \
            + row("alpha") * means + row("beta")
        return self.prec.act(out)

    def rcu(self, name, x, n_blocks):
        for i in range(n_blocks):
            res = x
            for j in range(2):
                x = self.conv(f"{name}.conv_{2 * i + j}", x)
            x = self.prec.act(x + res)
        return x

    def crp(self, name, x):
        x = F.elu(x)
        path = x
        for k in range(2):
            path = _4d(F.max_pool2d, path, 5, 1, 2)
            path = self.conv(f"{name}.conv_{k}", path)
            x = self.prec.act(x + path)
        return x

    def refine(self, name, xs, n_out_blocks, shape):
        hs = [self.rcu(f"{name}.adapt_{i}", x, 2) for i, x in enumerate(xs)]
        h = hs[0]
        if len(hs) > 1:
            total = 0
            for i, h in enumerate(hs):
                h = self.conv(f"{name}.msf.conv_{i}", h)
                if tuple(h.shape[3:]) != tuple(shape):
                    h = _4d(F.interpolate, h, size=tuple(shape),
                            mode="bilinear", align_corners=False)
                total = total + h
            h = self.prec.act(total)
        return self.rcu(f"{name}.output", self.crp(f"{name}.crp", h),
                        n_out_blocks)


def score(params, x: torch.Tensor, labels: torch.Tensor, cfg: dict,
          prec: Precision = None, sigmas: torch.Tensor = None
          ) -> torch.Tensor:
    """The K sources' scores of NHWC ``x [K, N, H, W, C]`` at noise levels
    ``labels [N]``, divided by ``sigmas [L]`` (float32) at those levels."""
    prec = prec or Precision()
    net = _Net(params, labels, prec)
    h = prec.act(x.permute(0, 1, 4, 2, 3))
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
    out = out / sigmas[labels][None, :, None, None, None]
    return out.permute(0, 1, 3, 4, 2)
