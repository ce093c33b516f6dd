"""The NCSN score nets' pools on the card: a hand-written CUDA kernel file
(``csrc/pool.cu``) for the CRP blocks' 5x5 stride-1 SAME average (v1) and
max (v2) pools and the residual blocks' 2x2 stride-2 average, and the
PyTorch versions of the same pools.

* :func:`avg_pool_same`, :func:`max_pool_same` (5x5, stride 1) and
  :func:`avg_pool2` on a CUDA tensor launch the kernel or raise; nothing
  falls back. On a CPU tensor they run PyTorch's pools (``F.avg_pool2d``
  with ``count_include_pad=False``, ``F.max_pool2d``, ``F.avg_pool2d(x, 2,
  2)``), which the tests hold to the JAX package.
* Gradients: a ``torch.autograd.Function`` whose forward is the kernel and
  whose backward is the PyTorch pool's VJP: the average's ``c *
  avg_pool(g / c)`` with ``c`` the valid counts (PyTorch's own CUDA
  backward of this pool is wrong for channels_last input), the others
  recomputed from x under autograd. There is no backward kernel.
* x is NCHW in ``channels_last`` memory (physically NHWC), bf16 or f32,
  any N (up to 65535), C, H and W. x of another layout is copied into
  ``channels_last`` first (counted in ``layout_copies``);
  :func:`_pool_cuda` refuses it.
* A launch goes through ``kernels.build.launch`` and is counted in
  ``ops.counting`` under ``pool``: ``launch_count``, pools the kernels
  ran, ``launch_counts`` by kind (``avg5``, ``max5``, ``avg2``), and
  ``layout_copies``. A CUDA graph's owner (``separation.graphs``) takes a
  capture's counts back off and adds them at every replay.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..kernels import build
from . import counting

__all__ = ["avg_pool_same", "max_pool_same", "avg_pool2"]

# the C entry points and their limits (csrc/pool.cu)
ENTRIES = {"pool5": "pool5_fwd", "avg2": "avg_pool2_fwd"}
MODES = {"avg5": 0, "max5": 1}
WINDOW = 5
MAX_N = 65535
# channels a thread owns; threads and shared memory a block of the 5x5
# kernel, at most
VEC, MAX_THREADS, MAX_SMEM = 8, 256, 48 * 1024
# the widest map a 5x5 block takes whole; wider ones are cut into tiles of
# TILE_W output columns (and 4 halo columns); output rows a block, at most
TILE_W, MAX_ROWS = 124, 8


def _avg_same(x: torch.Tensor, window: int) -> torch.Tensor:
    return F.avg_pool2d(x, window, 1, window // 2, count_include_pad=False)


def _max_same(x: torch.Tensor, window: int = WINDOW) -> torch.Tensor:
    return F.max_pool2d(x, window, 1, window // 2)


def _avg2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2, 2)


def _valid_counts(h: int, w: int, window: int, like: torch.Tensor
                  ) -> torch.Tensor:
    """``[h, w]``: how many input cells each SAME ``window`` x ``window``
    stride-1 window holds."""
    r = window // 2

    def n(size):
        i = torch.arange(size, device=like.device)
        return (torch.clamp(i + r, max=size - 1)
                - torch.clamp(i - r, min=0) + 1).to(like.dtype)

    return n(h)[:, None] * n(w)[None, :]


class _AvgPoolSame(torch.autograd.Function):
    """The SAME average (``count_include_pad=False``): the kernel on a CUDA
    tensor, ``F.avg_pool2d`` on the CPU, with its backward written through
    ``F.avg_pool2d``'s forward: with ``c`` the valid counts and ``S`` the
    zero-padded box sum (its own adjoint), ``y = S(x) / c`` gives ``dx =
    S(g / c) = c * avg_pool(g / c)``. PyTorch 2.11's CUDA backward of this
    pool is wrong for channels_last input (``tests/
    test_torch_cuda.py::test_avg_pool_same_gradient_on_the_card``); its
    forward is right on every device."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.window = window
        return _pool_cuda(x, "avg5") if x.is_cuda else _avg_same(x, window)

    @staticmethod
    def backward(ctx, g):
        k = ctx.window
        c = _valid_counts(g.shape[2], g.shape[3], k, g)
        return c * _avg_same(g / c, k), None


class _Pooled(torch.autograd.Function):
    """Forward: the kernel (``kind`` ``max5`` or ``avg2``). Backward: the
    VJP of the PyTorch pool, recomputed from x under autograd."""

    @staticmethod
    def forward(ctx, x, kind):
        ctx.save_for_backward(x)
        ctx.kind = kind
        return _pool_cuda(x, kind)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            out = _max_same(x) if ctx.kind == "max5" else _avg2(x)
        return torch.autograd.grad(out, x, g)[0], None


def _for_the_kernel(x: torch.Tensor, window: int = WINDOW) -> torch.Tensor:
    """x as the kernel takes it: ``channels_last`` (a copy of another
    layout, counted), for a window it takes (else ValueError)."""
    if window != WINDOW:
        raise ValueError(f"the pool kernel takes a {WINDOW}x{WINDOW} window, "
                         f"got {window}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        x = x.contiguous(memory_format=torch.channels_last)
        counting.add({"pool": {"layout_copies": 1}})
    return x


def avg_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Stride-1 average pooling of NCHW ``x`` with SAME padding that counts
    only valid elements (JAX ``avg_pool_same``, odd ``window``; the kernel
    takes 5). Differentiable."""
    if x.is_cuda:
        x = _for_the_kernel(x, window)
    return _AvgPoolSame.apply(x, window)


def max_pool_same(x: torch.Tensor, window: int) -> torch.Tensor:
    """Stride-1 max pooling of NCHW ``x`` with SAME padding (padding never
    wins), odd ``window`` (the kernel takes 5). Differentiable."""
    if not x.is_cuda:
        return _max_same(x, window)
    return _Pooled.apply(_for_the_kernel(x, window), "max5")


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pooling of NCHW ``x``, stride 2, VALID.
    Differentiable."""
    if not x.is_cuda:
        return _avg2(x)
    return _Pooled.apply(_for_the_kernel(x), "avg2")


def block_shape(w: int, c: int) -> tuple:
    """A 5x5 block's channel groups G and output columns TW for a map of
    ``w`` columns and ``c`` channels: the whole width up to TILE_W + 4
    columns (else tiles of TILE_W and 4 halo columns), and as many groups
    of 8 channels as make up to MAX_THREADS threads, within the shared
    memory (two double-buffered rows of TW + 4 entries of G x 8 f32)."""
    groups = -(-c // VEC)
    tw = w if w <= TILE_W + 4 else TILE_W
    cols = min(w, tw + 4)
    g = max(1, min(groups, MAX_THREADS // cols,
                   MAX_SMEM // (64 * (tw + 4))))
    return g, tw


def strip_rows(blocks: int, h: int, resident: int) -> int:
    """Output rows a 5x5 block walks, up to MAX_ROWS, for ``blocks``
    blocks a strip set (samples x channel slabs x column tiles), ``h`` rows
    and ``resident`` blocks the card holds at once: the strips that take
    the fewest waves x rows a block (its rows and 4 halo rows), the longest
    among equals. A wave not filled leaves SMs idle at its end, and a short
    strip re-reads its halo; longer strips than MAX_ROWS, though fewer
    waves, measured slower on the H100 (fewer blocks in flight a wave)."""
    best, best_cost = None, None
    for rows in range(min(h, MAX_ROWS), 0, -1):
        strips = -(-h // rows)
        cost = -(-blocks * strips // resident) * (rows + 4)
        if best_cost is None or cost < best_cost:
            best, best_cost = rows, cost
    return best


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: int, mode: int, bf16: bool, w: int, g: int,
                     tw: int) -> int:
    """The 5x5 blocks of this shape the card holds at once: its SMs x the
    blocks an SM holds (the kernel's registers and shared memory)."""
    per_sm = build.function("pool5_blocks_per_sm")(mode, int(bf16), w, g,
                                                   tw)
    if per_sm < 1:
        raise RuntimeError(f"pool kernel: no occupancy for W = {w}, G = "
                           f"{g}, TW = {tw}")
    return per_sm * build.sm_count(device)


@functools.lru_cache(maxsize=None)
def _geometry(device: int, kind: str, bf16: bool, n: int, h: int, w: int,
              c: int) -> tuple:
    """(G, TW, rows) of the 5x5 kernel's blocks for x of ``[n, c, h, w]``."""
    g, tw = block_shape(w, c)
    slabs = -(-(-(-c // VEC)) // g)         # ceil(ceil(c / VEC) / g)
    tiles = -(-w // tw)
    resident = _resident_blocks(device, MODES[kind], bf16, w, g, tw)
    return g, tw, strip_rows(n * slabs * tiles, h, resident)


def _pool_cuda(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Launch the kernel ``kind`` (``avg5``, ``max5``, ``avg2``) on the
    current stream (x must already be ``channels_last``)."""
    if not x.is_cuda:
        raise ValueError(f"pool kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pool kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(
            memory_format=torch.channels_last):
        raise ValueError(f"pool kernel needs 4-D x in channels_last memory, "
                         f"got shape {tuple(x.shape)}, strides {x.stride()}")
    n, c, h, w = x.shape
    if n > MAX_N:
        raise ValueError(f"pool kernel takes N <= {MAX_N}, got "
                         f"{tuple(x.shape)}")
    out = (n, c, h // 2, w // 2) if kind == "avg2" else (n, c, h, w)
    y = torch.empty(out, dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    dev, bf16 = x.device, x.dtype == torch.bfloat16
    if kind == "avg2":
        entry, args = ENTRIES["avg2"], (n, h, w, c, int(bf16))
    else:
        entry = ENTRIES["pool5"]
        args = (n, h, w, c, MODES[kind], int(bf16),
                *_geometry(dev.index, kind, bf16, n, h, w, c))
    build.launch(entry, dev, x.data_ptr(), y.data_ptr(), *args,
                 detail=lambda: f"{kind}, x {tuple(x.shape)} {x.dtype}, "
                                f"sizes {args}")
    counting.add({"pool": {"launch_count": 1, "launch_counts": {kind: 1}}})
    return y
