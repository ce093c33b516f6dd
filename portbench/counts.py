"""Operations, bytes and least times of the routed convs, and the chip's
peaks (``peaks.json``, by ``torch.cuda.get_device_name()``).

A 3x3 conv's work is counted from its shape alone, whatever computes it:
one multiply-add per output per input channel, ``2 N H W C_in C_out``
FLOPs. No exact 3x3 algorithm does less: Winograd's F(m x m, 3 x 3) needs
``(m + 2)^2 / m^2`` multiplies an output per input channel, which tends
to 1 as m grows. Its bytes are x, the weights and y each moved once at the
dtype. Its least time is the larger of operations over the dtype's peak
and bytes over the HBM rate.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional, Tuple

from .spec import HERE

ITEMSIZE = {"bfloat16": 2, "float32": 4}


def peaks(device_name: str) -> Optional[dict]:
    with open(HERE / "peaks.json") as f:
        return json.load(f).get(device_name)


def conv_ops(n, h, w, cin, cout) -> int:
    return 2 * n * h * w * cin * cout


def conv_bytes(n, h, w, cin, cout, dtype: str) -> int:
    return ITEMSIZE[dtype] * (n * h * w * (cin + cout) + 9 * cin * cout)


def conv_least_s(conv: Tuple[int, int, int, int, int], dtype: str,
                 peak: dict) -> float:
    return max(conv_ops(*conv) / peak["flops"][dtype],
               conv_bytes(*conv, dtype) / peak["hbm_bytes_per_s"])


def least_s(convs: Iterable[Tuple[int, int, int, int, int]], dtype: str,
            peak: dict) -> float:
    return sum(conv_least_s(c, dtype, peak) for c in convs)
