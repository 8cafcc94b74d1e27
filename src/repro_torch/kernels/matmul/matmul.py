"""ctypes launcher of the hand-written CUDA matrix product (``csrc/matmul.cu``).

The CUDA counterpart of ``repro/kernels/matmul/matmul.py::matmul_blocked``.
It takes the unpadded operands: the kernels stop at the edges, so there is
no padding copy.

``plan`` decides, in Python and cached per device and shape, how a product
runs: its route (``wgmma``, the TMA + tensor-core kernel, for bf16 operands
TMA can take; ``tf32x3``, fp32 split into TF32 halves on the tensor cores,
for fp32 with M > 64; ``stream``, B streamed by TMA through a ring of
shared-memory stages into fp32 FMA on the CUDA cores, for fp32 at M <= 64
that TMA can read: the decode tick; ``simt``, the CUDA-core kernel, for
the rest), its tile, and how many chunks K is cut into when the tiles
alone would not fill the card. A launch is then one ctypes call; this
module allocates the fp32 workspace of the partial sums and the tf32x3
route's split operands (one buffer), ``ops.matmul`` checks the arguments
and allocates the output.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build, scratch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1, "tf32x3": 2, "stream": 3}
STREAM_ROWS = (4, 8, 16, 32, 64)  # stream: the row counts a block covers, M padded up to one
# (route, tile) -> (rows, columns, K step, the kernel's tile code)
TILES = {
    ("wgmma", "128x128"): (128, 128, 64, 0),
    ("wgmma", "64x128"): (64, 128, 64, 1),
    ("tf32x3", "128x128"): (128, 128, 32, 0),
    **{("stream", f"{r}x128"): (r, 128, 32, i) for i, r in enumerate(STREAM_ROWS)},
    ("simt", "128x128"): (128, 128, 16, 0),  # bf16 TMA cannot read; fp32 only in the probe
    ("simt", "16x128"): (16, 128, 32, 1),
}
TF32_BK = TILES["tf32x3", "128x128"][2]  # tf32x3: K padded to whole steps of this
SMALL_M = 64  # M at or below this takes the small tile of its route
MIN_KCHUNK = 256  # split K no finer than this
BLOCKS_PER_SM = 2  # split K until the grid has this many blocks per SM
TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and row strides


class Plan(NamedTuple):
    route: str  # "wgmma", "tf32x3", "stream" or "simt"
    tile: str  # "<rows>x<columns>"
    splits: int  # K chunks; > 1 needs a workspace and a reduction


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _kchunk(k: int, splits: int, bk: int) -> int:
    return _ceil_div(_ceil_div(k, splits), bk) * bk


def _splits(m: int, n: int, k: int, tile: tuple, sms: int) -> int:
    """K chunks so that the grid has about BLOCKS_PER_SM blocks on every SM."""
    bm, bn, bk, _ = tile
    tiles = _ceil_div(m, bm) * _ceil_div(n, bn)
    want = BLOCKS_PER_SM * sms
    if tiles >= want or k < 2 * MIN_KCHUNK:
        return 1
    splits = min(_ceil_div(want, tiles), k // MIN_KCHUNK)
    # A split covers whole K steps, so rounding the chunk up may leave fewer
    # splits; settle on a count that its own chunk gives back (the count only
    # falls, so this ends), so that no split is empty.
    while (fewer := _ceil_div(k, _kchunk(k, splits, bk))) != splits:
        splits = fewer
    return splits


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool, sms: int) -> Plan:
    """How an (M, K) @ (K, N) product in ``dtype`` runs on a card of ``sms``
    SMs; ``aligned``: both operands start on a 16-byte boundary."""
    small = m <= SMALL_M
    if dtype == torch.bfloat16 and aligned and k % 8 == 0 and n % 8 == 0:
        route, tile = "wgmma", ("64x128" if small else "128x128")
    elif dtype == torch.float32 and not small:  # the split pass takes any alignment
        route, tile = "tf32x3", "128x128"
    elif dtype == torch.float32 and aligned and k % 4 == 0 and n % 4 == 0:
        route, tile = "stream", f"{next(r for r in STREAM_ROWS if m <= r)}x128"
    else:
        route, tile = "simt", ("16x128" if small else "128x128")
    return Plan(route, tile, _splits(m, n, k, TILES[route, tile], sms))


@functools.cache
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def plan_for(a: torch.Tensor, b: torch.Tensor) -> Plan:
    """The plan of ``a @ b`` on the card that holds them."""
    aligned = (a.data_ptr() | b.data_ptr()) % TMA_ALIGN == 0
    return plan(a.shape[0], b.shape[1], a.shape[1], a.dtype, aligned,
                sm_count(a.device.index))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("matmul")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_matmul.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
    lib.repro_matmul.restype = i
    lib.repro_matmul_tf32x3.argtypes = [vp] * 8 + [i] * 6 + [vp]
    lib.repro_matmul_tf32x3.restype = i
    lib.repro_matmul_split.argtypes = [vp] * 6 + [i] * 4 + [vp]
    lib.repro_matmul_split.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, p: Plan, stream: int) -> None:
    """One call of the kernel of plan ``p`` into ``out`` on ``stream``.

    a (M, K) and b (K, N) in one dtype, out (M, N): contiguous, float32 or
    bfloat16, one device, as ``ops.matmul`` checks.
    """
    (m, k), n = a.shape, b.shape[1]
    lib, dev = _lib(), a.device.index or 0
    if p.route == "tf32x3":
        buf, offsets = _scratch(m, n, k, p.splits, a.device)
        ptrs = [None if o is None else buf.data_ptr() + o for o in offsets]
        err = lib.repro_matmul_tf32x3(a.data_ptr(), b.data_ptr(), out.data_ptr(), *ptrs, m, n, k,
                                      p.splits, DTYPE_CODES[out.dtype], dev, stream)
    else:
        ws = (torch.empty((p.splits, m, n), dtype=torch.float32, device=a.device)
              if p.splits > 1 else None)
        err = lib.repro_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
            m, n, k, p.splits, ROUTES[p.route], TILES[p.route, p.tile][3],
            DTYPE_CODES[a.dtype], DTYPE_CODES[out.dtype], dev, stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed ({p.route} {p.tile}, "
                           f"{p.splits} splits): " + lib.repro_cuda_error_string(err).decode())


def padded_k(k: int) -> int:
    """K rounded up to whole tf32x3 steps: the split operands' row length."""
    return _ceil_div(k, TF32_BK) * TF32_BK


def _scratch(m: int, n: int, k: int, splits: int, device) -> tuple:
    """One uninitialised byte buffer for the tf32x3 route's split operands
    A_hi, A_lo (M, Kp), Bt_hi, Bt_lo (N, Kp) and, when K is split, its fp32
    workspace; and the byte offsets of the five parts (None for no workspace)."""
    kp = padded_k(k)
    return scratch((m * kp * 4, m * kp * 4, n * kp * 4, n * kp * 4,
                    splits * m * n * 4 if splits > 1 else 0), device)


def split(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The tf32x3 route's split pass alone, on the card: (A_hi, A_lo) of a
    (M, K) as (M, Kp) and (Bt_hi, Bt_lo) of b (K, N) as (N, Kp), K
    zero-padded to Kp = ``padded_k(K)``; ``tf32.split_tf32`` of ``a`` and
    ``b.T`` padded, bit for bit (fp32 a and b, contiguous, as the route
    takes them)."""
    (m, k), n = a.shape, b.shape[1]
    kp = padded_k(k)
    buf, offsets = _scratch(m, n, k, 1, a.device)
    parts = [buf[o:o + rows * kp * 4].view(torch.float32).view(rows, kp)
             for o, rows in zip(offsets[:4], (m, m, n, n))]
    lib = _lib()
    err = lib.repro_matmul_split(a.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in parts),
                                 m, n, k, a.device.index or 0,
                                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError("matmul split pass launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
    return tuple(parts)
