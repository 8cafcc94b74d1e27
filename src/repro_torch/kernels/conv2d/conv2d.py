"""ctypes launcher of the hand-written CUDA convolution (``csrc/conv2d.cu``).

The CUDA counterpart of ``repro/kernels/conv2d/conv2d.py::conv2d_windows``.
It takes the unpadded input: both routes make the "same" padding
themselves, so there is no windowed or padded copy.

``plan`` decides, in Python and cached per card and shape, how a conv runs:
its route (``wgmma``, the implicit GEMM on the tensor cores, for bf16 with
C % 64 == 0 and K % 8 == 0; ``tf32x3``, the same implicit GEMM on fp32
split into TF32 halves, for fp32 with C % 32 == 0; ``direct``, the
CUDA-core kernel, for the rest), the box of pixels a block computes, its
output channels, how many blocks share an SM, and how many splits the
(tap, channel) reduction is cut into when the tiles alone would leave SMs
idle. The wgmma route reads x as NHWC and w as an (R*S*C, K) matrix, the
tf32x3 route x's halves as NHWC and w's as (K, R*S*C); the library call
writes them first into scratch this module allocates (one buffer, with the
fp32 workspace of the partial sums); a launch is one ctypes call.
``ops.conv2d`` checks the arguments and allocates the output.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from .. import _build, scratch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("direct", "wgmma", "tf32x3")
TILE_M = 128  # wgmma, tf32x3: pixels per block, two consumer warpgroups of 64
TILES_N = (128, 64)  # wgmma, tf32x3: output channels per block; 64 only where K <= 64
BK = 64  # wgmma: input channels per K step, one 128-byte swizzle row of bf16
TF32_BK = 32  # tf32x3: input channels per K step, one swizzle row of fp32
# The pixel boxes a wgmma block can take, (columns, rows), widest first.
BOXES = tuple((TILE_M >> i, 1 << i) for i in range(8))
MIN_SPLIT_STEPS = 4  # a split covers at least this many K steps (bf16 256 deep, fp32 128)
BLOCKS_PER_SM = (1, 2)  # one block per SM (a 4-stage ring) or two (3 stages at n128, 4 at n64)


class Plan(NamedTuple):
    route: str  # "wgmma", "tf32x3" or "direct"
    box: tuple  # (columns, rows) of the pixels a block computes; () on direct
    splits: int  # chunks of the K steps; > 1 needs a workspace and a reduction
    blocks: int  # blocks per SM: wgmma one of BLOCKS_PER_SM; 1 on tf32x3 and direct
    tile_n: int  # output channels per block, one of TILES_N; 0 on direct


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pick_box(h: int, w: int) -> tuple:
    """The box that covers an H x W image in the fewest tiles, the widest of
    those (longer runs of one channel's row in the NCHW epilogue)."""
    return min(BOXES, key=lambda b: (_ceil_div(w, b[0]) * _ceil_div(h, b[1]), -b[0]))


def kchunk(steps: int, splits: int) -> int:
    return _ceil_div(steps, splits)


def _splits(tiles: int, steps: int, sms: int) -> int:
    """Splits of the K steps when ``tiles`` (one block per SM) leave SMs idle:
    the count whose waves x steps per split is least, the smallest of those."""
    if tiles >= sms or steps < 2 * MIN_SPLIT_STEPS:
        return 1
    best = min(range(1, steps // MIN_SPLIT_STEPS + 1),
               key=lambda s: (_ceil_div(tiles * s, sms) * kchunk(steps, s), s))
    # settle on a count that its own chunk gives back, so that no split is empty
    return _ceil_div(steps, kchunk(steps, best))


@functools.lru_cache(maxsize=4096)
def plan(n: int, c: int, h: int, w: int, k: int, r: int, s: int, dtype: torch.dtype,
         sms: int) -> Plan:
    """How a conv of x (N, C, H, W) with w (K, C, R, S) in ``dtype`` runs on
    a card of ``sms`` SMs. On wgmma two blocks share an SM (one's epilogue
    overlaps the other's loads) unless the tiles would not fill the card
    once; then one block per SM, and the steps are split
    (tools/conv_sweep.py). A tf32x3 block fills the SM's shared memory
    alone; its steps are split on the same rule. A block computes 64
    output channels where K <= 64, else 128."""
    if dtype == torch.float32 and c % TF32_BK == 0:
        route, bk = "tf32x3", TF32_BK
    elif dtype == torch.bfloat16 and c % BK == 0 and k % 8 == 0:
        route, bk = "wgmma", BK
    else:
        return Plan("direct", (), 1, 1, 0)
    box, tile_n = pick_box(h, w), (64 if k <= 64 else 128)
    tiles = n * _ceil_div(h, box[1]) * _ceil_div(w, box[0]) * _ceil_div(k, tile_n)
    if tiles >= sms:
        return Plan(route, box, 1, 2 if route == "wgmma" else 1, tile_n)
    return Plan(route, box, _splits(tiles, r * s * c // bk, sms), 1, tile_n)


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan_for(x: torch.Tensor, w: torch.Tensor) -> Plan:
    """The plan of conv2d(x, w) on the card that holds them."""
    return plan(*x.shape, w.shape[0], *w.shape[2:], x.dtype, sm_count(x.device.index or 0))


def wgmma_operands(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The wgmma route's operands, in plain torch: x as NHWC, w as an
    (R*S*C, K) matrix whose row t*C + c holds tap t = r*S + s of input
    channel c. ``relayout`` makes them on the card."""
    k, c, r, s = w.shape
    return (x.permute(0, 2, 3, 1).contiguous(),
            w.permute(2, 3, 1, 0).reshape(r * s * c, k).contiguous())


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("conv2d")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_conv2d.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
    lib.repro_conv2d.restype = i
    lib.repro_conv2d_wgmma.argtypes = [vp] * 6 + [i] * 13 + [vp]
    lib.repro_conv2d_wgmma.restype = i
    lib.repro_conv2d_relayout.argtypes = [vp] * 4 + [i] * 8 + [vp]
    lib.repro_conv2d_relayout.restype = i
    lib.repro_conv2d_tf32x3.argtypes = [vp] * 8 + [i] * 12 + [vp]
    lib.repro_conv2d_tf32x3.restype = i
    lib.repro_conv2d_split.argtypes = [vp] * 6 + [i] * 8 + [vp]
    lib.repro_conv2d_split.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor, p: Plan) -> None:
    """One call of the kernel of plan ``p`` into ``out`` on the current
    stream of ``x``'s device.

    x (N, C, H, W), w (K, C, R, S) and out (N, K, H, W): contiguous, one
    dtype (float32 or bfloat16), one CUDA device, as ``ops.conv2d`` checks.
    """
    n, c, h, wd = x.shape
    k, _, r, s = w.shape
    dev = x.device.index or 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    if p.route == "wgmma":
        buf, offsets = _scratch(x, w, p.splits)
        xt, wt, ws = (buf.data_ptr() + o if o is not None else None for o in offsets)
        err = lib.repro_conv2d_wgmma(x.data_ptr(), w.data_ptr(), out.data_ptr(), xt, wt, ws,
                                     n, c, h, wd, k, r, s, *p.box, p.splits, p.blocks,
                                     p.tile_n, dev, stream)
    elif p.route == "tf32x3":
        buf, offsets = _scratch_tf32(x, w, p.splits)
        ptrs = [buf.data_ptr() + o if o is not None else None for o in offsets]
        err = lib.repro_conv2d_tf32x3(x.data_ptr(), w.data_ptr(), out.data_ptr(), *ptrs,
                                      n, c, h, wd, k, r, s, *p.box, p.splits, p.tile_n, dev,
                                      stream)
    else:
        err = lib.repro_conv2d(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, c, h, wd, k, r, s,
                               DTYPE_CODES[x.dtype], dev, stream)
    if err:
        raise RuntimeError(f"conv2d kernel launch failed ({p.route} {p.box}, {p.splits} "
                           f"splits, {p.blocks} blocks per SM, {p.tile_n} channels a block): "
                           + lib.repro_cuda_error_string(err).decode())


def _scratch(x: torch.Tensor, w: torch.Tensor, splits: int = 1) -> tuple:
    """One uninitialised byte buffer for the wgmma route's NHWC and (R*S*C, K)
    operands and, when the steps are split, its fp32 workspace; and the byte
    offsets of the three parts (None for no workspace)."""
    return scratch((x.numel() * 2, w.numel() * 2, _ws_bytes(x, w, splits)), x.device)


def _scratch_tf32(x: torch.Tensor, w: torch.Tensor, splits: int = 1) -> tuple:
    """The same for the tf32x3 route: x_hi, x_lo (NHWC), w_hi, w_lo
    (K, R*S*C), the workspace; the byte offsets of the five parts."""
    return scratch((x.numel() * 4, x.numel() * 4, w.numel() * 4, w.numel() * 4,
                    _ws_bytes(x, w, splits)), x.device)


def _ws_bytes(x: torch.Tensor, w: torch.Tensor, splits: int) -> int:
    n, _, h, wd = x.shape
    return splits * n * w.shape[0] * h * wd * 4 if splits > 1 else 0


def relayout(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The wgmma route's re-layout alone, on the card: ``wgmma_operands(x, w)``
    made by the kernel the route runs first (bf16 x and w, C % 64 == 0,
    K % 8 == 0, as the route takes them)."""
    n, c, h, wd = x.shape
    k, _, r, s = w.shape
    buf, (ox, ow, _) = _scratch(x, w)
    xt = buf[ox:ox + x.numel() * 2].view(torch.bfloat16).view(n, h, wd, c)
    wt = buf[ow:ow + w.numel() * 2].view(torch.bfloat16).view(r * s * c, k)
    lib = _lib()
    err = lib.repro_conv2d_relayout(x.data_ptr(), w.data_ptr(), xt.data_ptr(), wt.data_ptr(),
                                    n, c, h, wd, k, r, s, x.device.index or 0,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d re-layout launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    return xt, wt


def split(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The tf32x3 route's re-layout alone, on the card: (x_hi, x_lo, w_hi,
    w_lo), ``tf32.split_tf32`` bit for bit of x as NHWC and of w as a
    (K, R*S*C) matrix whose column t*C + c holds tap t = r*S + s of input
    channel c (fp32 x and w, C % 32 == 0, as the route takes them)."""
    n, c, h, wd = x.shape
    k, _, r, s = w.shape
    buf, offsets = _scratch_tf32(x, w)
    shapes = ((n, h, wd, c), (n, h, wd, c), (k, r * s * c), (k, r * s * c))
    parts = [buf[o:o + 4 * math.prod(sh)].view(torch.float32).view(sh)
             for o, sh in zip(offsets, shapes)]
    lib = _lib()
    err = lib.repro_conv2d_split(x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in parts),
                                 n, c, h, wd, k, r, s, x.device.index or 0,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d split re-layout launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    return tuple(parts)
