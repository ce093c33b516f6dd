"""Operations, bytes and least time of the Flow++ nets' attention, and
the chip's peaks read as ``counts.peaks`` reads them.

An attention call of ``[N, heads, T, d]`` q, k and v is counted from its
shape alone, whatever computes it: its forward is two products, ``q k^T``
and the weights times ``v``, ``4 N heads T^2 d`` FLOPs; its input
gradient is four of the same size (the gradients of the weights, of q, of
k and of v), twice the forward's. Its least bytes are what must cross HBM
at the dtype: q, k, v read and the output written in the forward; q, k,
v, the output and its gradient read and the gradients of q, k and v
written in the backward. Its least time is the larger of operations over
the dtype's peak and bytes over the HBM rate.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from .counts import ITEMSIZE

Call = Tuple[int, int, int, int]         # (N, heads, T, d)


def attn_ops(n, heads, t, d) -> int:
    """One call's forward and input gradient: 12 N heads T^2 d."""
    return 3 * 4 * n * heads * t * t * d


def attn_bytes(n, heads, t, d, dtype: str) -> int:
    """One call's forward (4 tensors) and input gradient (8 tensors) of
    ``N heads T d`` elements each."""
    return ITEMSIZE[dtype] * 12 * n * heads * t * d


def attn_least_s(call: Call, dtype: str, peak: dict) -> float:
    return max(attn_ops(*call) / peak["flops"][dtype],
               attn_bytes(*call, dtype) / peak["hbm_bytes_per_s"])


def least_s(calls: Iterable[Call], dtype: str, peak: dict) -> float:
    return sum(attn_least_s(c, dtype, peak) for c in calls)
