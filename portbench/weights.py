"""Weights made from a seed on the device, in a few large draws, from a
reference's parameter specs (name, shape, draw):

* ``("glorot",)``: uniform on +-sqrt(6 / (fan_in + fan_out)) of an OIHW
  kernel (or an ``[out, in]`` matrix), all such parameters from one draw;
* ``("normal", mean, std)``: all from one draw;
* ``("zeros",)``, ``("ones",)``;
* ``("plu", C)``: the factors ``P``, ``L``, ``U``, ``sign_s``, ``log_s``
  of an invertible 1x1 conv, the LU factors (with pivoting) of a random
  rotation, one batched draw for all convs of C channels.

The same (specs, seed, device) give the same tensors, so the benchmark can
make them again for the reference once the program is gone.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def glorot_limit(shape) -> float:
    rf = math.prod(shape[2:])
    return math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))


def make(specs: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {}
    by_kind: Dict[str, list] = {}
    for name, shape, draw in specs:
        by_kind.setdefault(draw[0], []).append((name, tuple(shape), draw))

    def flat(kind, fn):
        items = by_kind.get(kind, [])
        total = sum(math.prod(s) for _, s, _ in items)
        buf = fn(total) if total else None
        off = 0
        for name, shape, draw in items:
            n = math.prod(shape)
            yield name, shape, draw, buf[off:off + n].view(shape)
            off += n

    for name, shape, _, u in flat("glorot", lambda n: torch.rand(
            n, generator=gen, device=device)):
        out[name] = (2.0 * u - 1.0) * glorot_limit(shape)
    for name, shape, draw, z in flat("normal", lambda n: torch.randn(
            n, generator=gen, device=device)):
        out[name] = draw[1] + draw[2] * z
    for kind, fill in (("zeros", 0.0), ("ones", 1.0)):
        for name, shape, _ in by_kind.get(kind, []):
            out[name] = torch.full(shape, fill, device=device)
    convs: Dict[int, list] = {}
    for name, _, draw in by_kind.get("plu", []):
        prefix = name.rsplit(".", 1)[0]
        if prefix not in convs.setdefault(draw[1], []):
            convs[draw[1]].append(prefix)
    for c, prefixes in sorted(convs.items()):
        a = torch.randn(len(prefixes), c, c, generator=gen, device=device)
        q = torch.linalg.qr(a).Q
        p, lower, upper = torch.linalg.lu(q)
        s = torch.diagonal(upper, dim1=-2, dim2=-1)
        for i, prefix in enumerate(prefixes):
            out[f"{prefix}.P"] = p[i].contiguous()
            out[f"{prefix}.L"] = torch.tril(lower[i], -1)
            out[f"{prefix}.U"] = torch.triu(upper[i], 1)
            out[f"{prefix}.sign_s"] = torch.sign(s[i])
            out[f"{prefix}.log_s"] = torch.log(torch.abs(s[i]))
    missing = [n for n, _, _ in specs if n not in out]
    if missing:
        raise ValueError(f"no draw for {missing[:3]}")
    return {n: out[n] for n, _, _ in specs}
