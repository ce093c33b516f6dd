"""Winograd F(2x2, 3x3) convolution: hand-written CUDA kernels for Hopper.

Port of ``audiosourcesep_tpu/ops/winograd.py``. The SAME 3x3 stride-1
conv is computed per 2x2 output tile as

    Y = A^T [ (G g G^T) . (B^T d B) ] A      (per tile, summed over C_in)

with the exact +-1 / +-0.5 transform matrices below: 16 channel
contractions in the transform domain, 2.25x fewer multiply-adds than the
direct conv. Two Hopper kernels compute it, one per dtype: bf16 on the
tensor cores (``csrc/winograd_mma.cu``: wgmma fed by TMA from a producer
warpgroup) and float32 on the CUDA cores (``csrc/winograd.cu``, and at thin
channel counts ``csrc/winograd_thin.cu``: :func:`f32_path`, counted in
``f32_path_counts``). Both read
NHWC ``x`` directly (SAME halo zero-filled in the kernel), take the
pre-transformed weights ``U [16, C_in, C_out]`` in ``x``'s dtype (rounded
as the JAX wrapper rounds them), and write the interleaved NHWC output
themselves. The bf16 kernel's producer loads what TMA can address by TMA
and the rest with plain loads (:func:`bf16_path`, counted in
``bf16_path_counts``). Both kernels take any dilation d for which H and W
divide by 2d, as the JAX ``dilated_winograd_conv2d`` does.

Public layout is the JAX package's: NHWC activations, HWIO kernels.

* ``winograd_conv2d`` on a CPU tensor runs the plain PyTorch version
  (:func:`winograd_conv2d_reference`); on a CUDA tensor it launches the
  kernel or raises. There is no fallback between the two.
* Gradients: a ``torch.autograd.Function`` whose backward is the plain
  conv VJP (``torch.nn.grad.conv2d_input`` / ``conv2d_weight``), as the
  JAX custom VJP uses the XLA conv VJP; there is no backward kernel. A
  float32 backward runs cuDNN with TF32 off, in full float32 as the
  forward kernel computes (PyTorch allows TF32 in cuDNN by default).
* A launch goes through ``kernels.build.launch`` and is counted in
  ``ops.counting``'s top level: ``launch_count`` counts kernel launches
  (and nothing else), ``launch_counts`` splits it by kernel name, and
  ``bf16_path_counts`` and ``f32_path_counts`` by path. A CUDA graph's
  owner (``separation.graphs``) takes a capture's counts back off and
  adds them again at every replay, so they hold the launches the card ran.
* A dilated 3x3 conv runs the same kernels on its d*d phase grids
  (``dilated_winograd_conv2d``): the kernels take d, read each phase's
  pixels in place from the undilated ``x`` and write its outputs in
  place, so a dilated conv is one launch and no phase copy. Only the
  plain version splits the phases out. ``nn.conv2d`` does not route
  dilated convs, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import build
from . import counting

__all__ = ["transform_weights", "winograd_conv2d", "bf16_path", "f32_path",
           "winograd_conv2d_reference", "winograd_eligible",
           "dilated_eligible", "dilated_winograd_conv2d",
           "dilated_winograd_conv2d_reference"]

_BT = np.array([[1, 0, -1, 0],
                [0, 1, 1, 0],
                [0, -1, 1, 0],
                [0, 1, 0, -1]], np.float32)
_G = np.array([[1, 0, 0],
               [0.5, 0.5, 0.5],
               [0.5, -0.5, 0.5],
               [0, 0, 1]], np.float32)
_AT = np.array([[1, 1, 1, 0],
                [0, 1, -1, -1]], np.float32)

# the C entry point of each dtype's kernel
KERNELS = {torch.float32: "winograd_f23_fwd_f32",
           torch.bfloat16: "winograd_f23_fwd_bf16"}

# the f32 kernel's thin paths (csrc/winograd_thin.cu): C_in up to this takes
# thin_in (on grids of more tiles than THIN_IN_MIN_TILES), else C_out up to
# this (C_in a multiple of 4) thin_out
THIN_IN_MAX_CIN = 4
THIN_OUT_MAX_COUT = 16
THIN_IN_MIN_TILES = 512
# the limits of csrc/winograd_thin.cu, its NT, MAXPIECE and MAXSTAGE
# (tests/test_torch_winograd.py reads them from the source): thin_out's
# block (threads), the 16-byte x pieces a thread copies a chunk and its
# ring stages
THIN_NT, THIN_MAXPIECE, THIN_STAGES = 128, 8, 3
# the shared memory a thin_out block may take so that three fit on an SM;
# thin_in's tiles a block (the most), and the warps an SM should have of a
# launch before a smaller box is taken
THIN_OUT_SMEM_MAX = 75 * 1024
THIN_IN_TILES = 32
THIN_IN_WARPS_PER_SM = 8
# thin_out's blocks an SM holds at once (ptxas' registers: 145 a thread
# with CB = 4, 116 with CB = 1), for its cluster's cost model
THIN_OUT_BLOCKS_PER_SM = {4: 3, 1: 4}
# above this dilation the bf16 kernel's x tensor map cannot stride W by 2d
# (TMA's element strides stop at 8) and addresses 2d-pixel groups instead,
# which needs C_in in whole 16-channel chunks
BF16_STRIDED_MAX_DILATION = 4


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def transform_weights(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO ``[3, 3, C_in, C_out]`` -> ``U [16, C_in, C_out]`` =
    flat(G g G^T), in float32.

    Two ``tensordot`` products with K = 3 sum in the order the JAX
    package's einsum does: U is bit-identical to its ``transform_weights``
    (tests/test_torch_winograd.py), at the cost of two small matmuls."""
    g = _const(_G, kernel.device)
    t = torch.tensordot(g, kernel.float(), dims=([1], [0]))   # [4, 3, ci, co]
    u = torch.tensordot(t, g, dims=([1], [1]))                # [4, ci, co, 4]
    return u.permute(0, 3, 1, 2).reshape(16, *kernel.shape[2:]).contiguous()


def winograd_conv2d_reference(x: torch.Tensor,
                              kernel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Winograd (the kernel's reference; the CPU path).

    NHWC ``x``, HWIO ``kernel``, SAME padding, stride 1, H and W even.
    Computed in float32, returned in ``x``'s dtype.
    """
    b, h, w, cin = x.shape
    if h % 2 or w % 2 or tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"winograd needs even H, W and a 3x3 kernel, got "
                         f"x {tuple(x.shape)}, kernel {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    u = transform_weights(kernel).reshape(4, 4, cin, cout)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    # d[i, j, b, a, c, cin] = xp[b, 2a + i, 2c + j, cin]
    d = torch.stack([torch.stack(
        [xp[:, i:i + h - 1:2, j:j + w - 1:2, :] for j in range(4)])
        for i in range(4)]).float()
    bt = _const(_BT, x.device)
    at = _const(_AT, x.device)
    v = torch.einsum("ui,vj,ijbrsc->uvbrsc", bt, bt, d)
    m = torch.einsum("uvbrsc,uvcd->uvbrsd", v, u)
    y = torch.einsum("pu,qv,uvbrsd->brpsqd", at, at, m)
    return y.reshape(b, h, w, cout).to(x.dtype)


def winograd_eligible(x_shape, kernel_shape, dilation: int = 1) -> bool:
    """True when the kernel computes this stride-1 SAME conv: 3x3,
    undilated, with even H and W (NHWC ``x_shape``, HWIO
    ``kernel_shape``). Any C_in, C_out >= 1."""
    if len(kernel_shape) != 4 or tuple(kernel_shape[:2]) != (3, 3):
        return False
    if dilation != 1:
        return False
    _, h, w, cin = x_shape
    return h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2 and cin >= 1 \
        and kernel_shape[3] >= 1


def _block_rows(th: int, tw: int) -> int:
    """Tile rows of the f32 kernel's 32-tile block for a (phase) grid of
    ``th`` x ``tw`` tiles: 4 (a 4 x 8 block) unless 8 x 4 leaves fewer
    tile slots idle. The cascade's 48x32 convs: the dense 24 x 16 and the
    d = 2 12 x 8 grids fill 4 x 8 blocks; the d = 4 grid, 6 x 4 tiles,
    fills 75% of an 8 x 4 block against 37.5% of a 4 x 8 one."""
    def slots(rows):
        cols = 32 // rows
        return -(-th // rows) * rows * -(-tw // cols) * cols
    return 8 if slots(8) < slots(4) else 4


def _bf16_block(th: int, tw: int, d: int):
    """``(P, TC)`` of the bf16 kernel's 64-tile block for a phase grid of
    ``th`` x ``tw`` tiles at dilation ``d``: TC (8 or 4) tile columns by
    64 / TC tile rows, taken from P (1, 2 or 4, dividing d) row phases of
    one column phase. The shape with the fewest idle tile slots wins; on a
    tie the wider block and the fewer phases. The cascade's 48x32 convs:
    the dense 24 x 16 grid fills 8 x 8 blocks, the d = 2 grids of 12 x 8
    tiles two phases of 4 x 8, the d = 4 grids of 6 x 4 tiles two phases
    of 8 x 4 (75%)."""
    best = None
    for tc in (8, 4):
        for p in (1, 2, 4):
            if d % p:
                continue
            rows = 64 // (tc * p)
            slots = -(-th // rows) * rows * -(-tw // tc) * tc
            if best is None or slots < best[0]:
                best = (slots, p, tc)
    return best[1], best[2]


def bf16_path(x: torch.Tensor, dilation: int = 1) -> str:
    """How the bf16 kernel's producer brings ``x`` and ``U`` in: ``"tma"``
    by TMA when TMA can address x (C_in a multiple of 8, of 16 above
    dilation 4, 16-byte aligned; U's rows are padded to a multiple of 8
    for the kernel, see :func:`_bf16_u`), else ``"plain"``, by plain loads
    (begin_conv, 1->192)."""
    chunk = 16 if dilation > BF16_STRIDED_MAX_DILATION else 8
    if x.shape[-1] % chunk or x.data_ptr() % 16:
        return "plain"
    return "tma"


def _bf16_u(u: torch.Tensor) -> torch.Tensor:
    """U as the bf16 kernel reads it: 16-byte aligned, with rows of C_out
    padded with zeros to a multiple of 8 channels (16 bytes), which TMA
    needs between rows. A copy only when C_out is not a multiple of 8
    (end_conv, Flow++'s 96->294) or U is not aligned."""
    pad = -u.shape[2] % 8
    if pad:
        return F.pad(u, (0, pad))
    return u.clone() if u.data_ptr() % 16 else u


def f32_path(x_shape, c_out: int, dilation: int = 1) -> str:
    """Which design of the f32 kernel computes this conv (NHWC ``x_shape``,
    ``c_out`` output channels): ``"thin_in"`` for C_in <= 4 on a grid of
    more than THIN_IN_MIN_TILES 2x2 tiles (a lane an output channel with
    its U in registers, one stage of all C_in), ``"thin_out"`` for C_out
    <= 16 with C_in a multiple of 4 (C_in split over a thread-block
    cluster, reduced through distributed shared memory), else ``"wide"``
    (32 tiles x 64 C_out a block, ``csrc/winograd.cu``). The limits are
    the card's: thin_in won at C_in 1 to 4 and lost at 6, 8 and 12, where
    the wide kernel's chunk of 8 is full, and at C_in 4 it lost on the
    image Glow's 8x8 grids (128 tiles), where a launch's latency bounds
    both designs (``PERF.md``). All three work on the d*d phase grids in
    place, so the path does not depend on ``dilation`` (a grid has B H W
    / 4 tiles at any d). x of 2^31 elements or more stays wide (the thin
    kernel's x offsets are 32-bit)."""
    b, h, w, _ = x_shape
    return next((p for p in ("thin_in", "thin_out")
                 if _thin_eligible(x_shape, c_out, p) and (
                     p == "thin_out" or b * h * w // 4 > THIN_IN_MIN_TILES)),
                "wide")


def _thin_eligible(x_shape, c_out: int, path: str) -> bool:
    """Whether the thin kernel takes this conv on ``path`` (it refuses
    what this refuses)."""
    b, h, w, cin = x_shape
    if b * h * w * cin >= 2 ** 31:
        return False
    if path == "thin_in":
        return cin <= THIN_IN_MAX_CIN
    return c_out <= THIN_OUT_MAX_COUT and cin % 4 == 0


def _thin_out_channels(cin: int, cout: int):
    """``(CB, G, CO, KC, PIXW)`` of thin_out: output channels a thread,
    groups a block (2 x 64 / G threads each, two a tile), channels a block
    holds (padded to 4), input channels a chunk, floats a slab slot."""
    cb = 1 if cout == 1 else 4
    g = -(-cout // cb)
    kc = 8 if cin % 8 == 0 else 4
    return cb, g, 4 if cb == 1 else 4 * g, kc, 12 if kc == 8 else 4


def _thin_in_channel_warps(cout: int) -> int:
    """thin_in's channel warps a block (a lane an output channel): the
    most, up to 4, that divide C_out's 32-channel groups (512: 4; 192, 96:
    3)."""
    groups = -(-cout // 32)
    return next(w for w in (4, 3, 2, 1) if groups % w == 0)


def _thin_box(ni: int, th: int, tw: int, tiles: int, fits):
    """The box of ``tiles`` tiles (images x tile rows x tile columns) over
    ``ni`` phase-grid images of ``th`` x ``tw`` tiles with the fewest idle
    tile slots, then the smallest slab, then the widest; only boxes for
    which ``fits(nimg, trb, tcb, slab_pixels)`` holds. Returns ``(slots,
    (nimg, trb, tcb))``. Boxes 1 or 2 tiles wide fill grids of that width
    (the image Glow's 4x4 convs: 2 x 2 tiles), at the cost of 2-way bank
    conflicts on thin_out's slab reads, whose image and tile-row pitches
    then meet in the same banks."""
    best = None
    for tcb in (1, 2, 4, 8, 16, 32):
        for trb in (1, 2, 4, 8, 16):
            if tiles % (tcb * trb):
                continue
            nimg = tiles // (tcb * trb)
            px = nimg * (2 * trb + 2) * (2 * tcb + 2)
            if not fits(nimg, trb, tcb, px):
                continue
            slots = (-(-ni // nimg) * nimg * -(-th // trb) * trb
                     * -(-tw // tcb) * tcb)
            key = (slots, px, -tcb)
            if best is None or key < best[0]:
                best = (key, (nimg, trb, tcb))
    return best[0][0], best[1]


@functools.lru_cache(maxsize=256)
def _thin_geometry(x_shape, c_out: int, dilation: int, path: str,
                   sms: int):
    """``(nimg, trb, tcb, split, cwarps)`` of the thin kernel's launch on a
    card of ``sms`` SMs: the box of phase-grid images x tile rows x tile
    columns a block owns; thin_out's cluster (the blocks C_in is split
    over) and its 4 warps, or thin_in's tile warps Wt and channel warps Wc.
    Both were set from the card's times at the thin classes
    (``chip_smoke.py`` phases 3, 8a, 9a). thin_out's box has 64 / G tiles;
    its cluster (1, 2, 4 or 8, at most C_in's chunks) takes the fewest
    whole waves of blocks x (chunks a block + 1, the reduction's cost).
    thin_in's box has 32 tiles, or 16 or 8 where an SM would otherwise
    have fewer than THIN_IN_WARPS_PER_SM warps of the launch (Glow's 24x16
    4->512 in a separation's chunk of 8 frames, 768 tiles, takes 8), walked
    by one tile warp, or by two where C_out has at most 3 groups of 32
    channels (Flow++'s 3 -> 96 took 0.0117 ms so, 0.0147 with one)."""
    b, h, w, cin = x_shape
    d = dilation
    ni, th, tw = b * d * d, h // (2 * d), w // (2 * d)
    if path == "thin_in":
        cw = _thin_in_channel_warps(c_out)
        wt = 1 if -(-c_out // 32) > 3 else 2
        for tiles in (THIN_IN_TILES, THIN_IN_TILES // 2, THIN_IN_TILES // 4):
            slots, box = _thin_box(ni, th, tw, tiles, lambda *a: True)
            warps = slots // tiles * -(-c_out // (32 * cw)) * cw * wt
            if warps >= THIN_IN_WARPS_PER_SM * sms:
                break
        return (*box, wt, cw)
    cb, g, co, kc, pixw = _thin_out_channels(cin, c_out)
    tiles = THIN_NT // (2 * g)
    nch = cin // kc

    def fits(nimg, trb, tcb, px):
        words = max(THIN_STAGES * (px * pixw + kc * 16 * co),
                    tiles * (16 * co + 4))
        return (-(-px * (kc // 4) // THIN_NT) <= THIN_MAXPIECE
                and 4 * words <= THIN_OUT_SMEM_MAX)

    slots, box = _thin_box(ni, th, tw, tiles, fits)
    wave = THIN_OUT_BLOCKS_PER_SM[cb] * sms
    cluster = min((n for n in (1, 2, 4, 8) if n <= nch),
                  key=lambda n: (-(-slots // tiles * n // wave)
                                 * (-(-nch // n) + 1), n))
    return (*box, cluster, THIN_NT // 32)


def _winograd_cuda(x: torch.Tensor, u: torch.Tensor, dilation: int = 1,
                   path: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel of ``x``'s dtype on the current stream: the
    3x3 SAME conv of dilation d on NHWC ``x`` (f32 or bf16, contiguous, H
    and W divisible by 2d) with ``U [16, C_in, C_out]`` of the same
    dtype. One launch, whatever d. ``path`` (f32 only) names the f32
    kernel's design instead of :func:`f32_path`'s choice, so that a
    measurement can time two designs on one conv; a path that does not
    take the conv raises."""
    if not x.is_cuda or u.device != x.device:
        raise ValueError(f"winograd kernel needs x and U on one CUDA device, "
                         f"got {x.device} and {u.device}")
    if x.dtype not in KERNELS:
        raise TypeError(f"winograd kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if u.dtype != x.dtype:
        raise TypeError(f"U must be in x's dtype {x.dtype}, got {u.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or not u.is_contiguous():
        raise ValueError("winograd kernel needs contiguous NHWC x and U")
    b, h, w, cin = x.shape
    d = dilation
    if d < 1 or h % (2 * d) or w % (2 * d):
        raise ValueError(f"winograd kernel needs H and W divisible by 2d, "
                         f"got {h}x{w}, d={d}")
    if u.dim() != 3 or u.shape[0] != 16 or u.shape[1] != cin:
        raise ValueError(f"U must be [16, {cin}, C_out], got "
                         f"{tuple(u.shape)}")
    cout = u.shape[2]
    bf16 = x.dtype == torch.bfloat16
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    name = entry = KERNELS[x.dtype]
    th, tw = h // (2 * d), w // (2 * d)
    if bf16:
        if path is not None:
            raise ValueError("path names a design of the f32 kernel")
        u = _bf16_u(u)
        path = bf16_path(x, d)
        sizes = (cin, cout, u.shape[2], d)
        geometry = (*_bf16_block(th, tw, d), int(path == "tma"))
    else:
        path = path or f32_path(x.shape, cout, d)
        if path == "wide":
            sizes = (cin, cout, d)
            geometry = (_block_rows(th, tw),)
        elif path in ("thin_in", "thin_out") and _thin_eligible(
                x.shape, cout, path):
            entry = "winograd_f23_fwd_f32_thin"
            sizes = (cin, cout, d, int(path == "thin_out"))
            geometry = _thin_geometry(tuple(x.shape), cout, d, path,
                                      build.sm_count(x.device.index))
            if path == "thin_out" and x.data_ptr() % 16:
                x = x.clone()          # thin_out copies x in 16-byte pieces
        else:
            raise ValueError(f"the f32 kernel's path {path!r} does not take "
                             f"x {tuple(x.shape)} -> C_out {cout}")
    build.launch(entry, x.device, x.data_ptr(), u.data_ptr(), y.data_ptr(),
                 b, h, w, *sizes, *geometry,
                 detail=lambda: f"x {tuple(x.shape)}, C_out {cout}, d={d}, "
                                f"path {path}")
    counting.add({"launch_count": 1, "launch_counts": {name: 1},
                  ("bf16_path_counts" if bf16 else "f32_path_counts"):
                  {path: 1}})
    return y


def _forward(x: torch.Tensor, kernel: torch.Tensor,
             u: Optional[torch.Tensor], dilation: int) -> torch.Tensor:
    if x.is_cuda:
        # U rounded to x's dtype, as the JAX wrapper does (winograd.py:292)
        if u is None:
            u = transform_weights(kernel)
        return _winograd_cuda(x, u.to(x.dtype), dilation)
    if x.device.type == "cpu":
        if dilation == 1:
            return winograd_conv2d_reference(x, kernel)
        return dilated_winograd_conv2d_reference(x, kernel, dilation)
    raise ValueError(f"winograd_conv2d: no implementation for device "
                     f"{x.device}")


@contextlib.contextmanager
def _cudnn_full_f32(dtype: torch.dtype):
    """cuDNN's float32 convs in full float32 (no TF32) for the block if
    ``dtype`` is float32; the caller's choice is restored afterwards."""
    was = torch.backends.cudnn.allow_tf32
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = was


class _WinogradConv2d(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its plain version (CPU), at
    dilation d. Backward: the plain (dilated) conv VJP, as in the JAX
    package's custom VJP."""

    @staticmethod
    def forward(ctx, x, kernel, u, dilation):
        ctx.save_for_backward(x, kernel)
        ctx.dilation = dilation
        return _forward(x, kernel, u, dilation)

    @staticmethod
    def backward(ctx, gy):
        x, kernel = ctx.saved_tensors
        d = ctx.dilation
        w = kernel.permute(3, 2, 0, 1).to(x.dtype)          # HWIO -> OIHW
        xn = x.permute(0, 3, 1, 2)
        g = gy.permute(0, 3, 1, 2).to(x.dtype)
        gx = gk = None
        with _cudnn_full_f32(x.dtype):
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(xn.shape, w, g, padding=d,
                                                dilation=d)
                gx = gx.permute(0, 2, 3, 1)
            if ctx.needs_input_grad[1]:
                gk = torch.nn.grad.conv2d_weight(xn, w.shape, g, padding=d,
                                                 dilation=d)
                gk = gk.permute(2, 3, 1, 0).to(kernel.dtype)
        return gx, gk, None, None


def winograd_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SAME 3x3 stride-1 conv via Winograd F(2x2,3x3).

    NHWC ``x``, HWIO ``kernel``; output NHWC in ``x``'s dtype. A CUDA
    tensor goes through the Hopper kernel of its dtype (or raises), a CPU
    tensor through :func:`winograd_conv2d_reference`. ``u``, if given, is
    ``transform_weights(kernel)`` computed earlier (the CUDA path then
    skips it; gradients still flow to ``kernel``). Bias is the caller's
    job.
    """
    return _WinogradConv2d.apply(x, kernel, u, 1)


# ---------------------------------------------------------------------------
# dilated convs via phase decomposition
# ---------------------------------------------------------------------------

def dilated_eligible(x_shape, kernel_shape, stride: int = 1,
                     dilation: int = 1) -> bool:
    """True when this dilation-d 3x3 SAME conv (NHWC ``x_shape``, HWIO
    ``kernel_shape``, d >= 2) splits exactly into d*d stride-1 convs on
    the d-subsampled phase grids, and the kernel computes those: H and W
    divisible by 2d. The cascade of the v1 score network has ten such
    convs, at d = 2 and 4."""
    if dilation < 2 or stride != 1:
        return False
    b, h, w, cin = x_shape
    d = dilation
    if h % (2 * d) or w % (2 * d):
        return False
    return winograd_eligible((b * d * d, h // d, w // d, cin), kernel_shape)


def _to_phases(x: torch.Tensor, d: int) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` -> the d*d phase grids as batch,
    ``[B*d*d, H/d, W/d, C]`` (contiguous)."""
    b, h, w, c = x.shape
    return (x.reshape(b, h // d, d, w // d, d, c).permute(0, 2, 4, 1, 3, 5)
            .reshape(b * d * d, h // d, w // d, c))


def _from_phases(y: torch.Tensor, b: int, d: int) -> torch.Tensor:
    """Inverse of :func:`_to_phases`: interleave the phase outputs back."""
    _, hd, wd, c = y.shape
    return (y.reshape(b, d, d, hd, wd, c).permute(0, 3, 1, 4, 2, 5)
            .reshape(b, hd * d, wd * d, c))


def dilated_winograd_conv2d(x: torch.Tensor, kernel: torch.Tensor,
                            dilation: int,
                            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dilation-d 3x3 SAME conv = Winograd conv on the d*d phase grids.

    ``y[d a + p, d b + q]`` reads only ``x[d (a+i) + p, d (b+j) + q]``, so
    each phase (p, q) is an independent stride-1 SAME conv on its
    subsampled grid. On a CUDA tensor the kernel of ``x``'s dtype computes
    all phases in one launch, reading and writing them in place; on a CPU
    tensor :func:`dilated_winograd_conv2d_reference` moves the phases to
    the batch axis and back. Gradients are the dilated conv's VJP. NHWC
    ``x``, HWIO ``kernel``, ``u`` as for :func:`winograd_conv2d`.
    """
    if not dilated_eligible(x.shape, kernel.shape, dilation=dilation):
        raise ValueError(f"dilated winograd needs a 3x3 kernel, d >= 2 and "
                         f"H, W divisible by 2d; got x {tuple(x.shape)}, "
                         f"kernel {tuple(kernel.shape)}, d={dilation}")
    return _WinogradConv2d.apply(x, kernel, u, dilation)


def dilated_winograd_conv2d_reference(x: torch.Tensor, kernel: torch.Tensor,
                                      dilation: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`dilated_winograd_conv2d` on any
    device: the phase split around :func:`winograd_conv2d_reference`."""
    y = winograd_conv2d_reference(_to_phases(x, dilation), kernel)
    return _from_phases(y, x.shape[0], dilation)
