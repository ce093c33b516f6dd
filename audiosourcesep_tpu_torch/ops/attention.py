"""Multi-head self-attention of the Flow++ coupling nets, memory-linear on
the card.

``softmax(q k^T / sqrt(d)) v`` over every position: the JAX package writes
it as two einsums and a softmax, which materialise the ``[N, heads, T, T]``
probabilities. On a mel frame's first Flow++ stage (T = 3,072) that is
151 MB a frame and a layer, and the score's backward would keep each of
its 40 layers': about 7 GB a frame. So on a CUDA tensor :func:`attention`
is ``F.scaled_dot_product_attention`` on its memory-efficient backend (the
CUTLASS kernels PyTorch ships, ``fmha_cutlassF_f32`` and
``fmha_cutlassB_f32``, which keep the output and one log-sum-exp a row,
never the probabilities), for float32 with d a multiple of 4 (the cells'
d = 24) and the other dtypes it takes; float64, which it does not take,
runs on the plain math backend (the card tests' float64 nets). No other
backend is allowed, and inputs the one backend of their dtype cannot take
raise: the math backend would hold the probabilities, silently, where the
memory-efficient one refuses. :data:`KERNELS` names the two kernels a
trace shows. The memory-efficient kernels are float32-accurate: on an H100
their output and gradients lie within 1.2e-6 of the largest of a float64
attention's, as plain float32 matmuls do (TF32 matmuls: 1e-3); the
backward's gradient of q is summed in no fixed order, and differs from
run to run in its last bits. On a CPU tensor it is the same call on any
backend.

Each call on a CUDA tensor is counted in ``ops.counting`` under ``attn``:
``launch_count``, and ``shapes``, the calls by ``(N, heads, T, d)``. A
CUDA graph's owner (``separation.graphs``) takes a capture's counts back
off and adds them at every replay, as for the hand-written kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from . import counting

__all__ = ["attention", "KERNELS"]

# what the memory-efficient backend's forward and backward kernels' names
# begin with in a trace (PyTorch's CUTLASS kernels: fmha_cutlassF_f32_...)
KERNELS = ("fmha_cutlassF", "fmha_cutlassB")


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` of ``[N, heads, T, d]`` q, k and v
    (views, unit stride in d); no mask, no dropout."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v, scale=scale)
    backend = SDPBackend.MATH if q.dtype == torch.float64 \
        else SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel([backend]):
        out = F.scaled_dot_product_attention(q, k, v, scale=scale)
    shape = tuple(q.shape)
    counting.COUNTS["attn"]["shapes"].setdefault(shape, 0)
    counting.add({"attn": {"launch_count": 1, "shapes": {shape: 1}}})
    return out
