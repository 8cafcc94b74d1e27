"""ctypes launcher of the hand-written CUDA matrix product (``csrc/matmul.cu``).

The CUDA counterpart of ``repro/kernels/matmul/matmul.py::matmul_blocked``.
It takes the unpadded operands: the kernels stop at the edges, so there is
no padding copy.

``plan`` decides, in Python and cached per device and shape, how a product
runs: its route (``wgmma``, the TMA + tensor-core kernel, for bf16 operands
TMA can take; ``simt``, the CUDA-core kernel, for the rest), its tile, and
how many chunks K is cut into when the tiles alone would not fill the card.
A launch is then one ctypes call; this module allocates the fp32 workspace
of the partial sums, ``ops.matmul`` checks the arguments and allocates the
output.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1}
# (route, tile) -> (rows, columns, K step, the kernel's tile code)
TILES = {
    ("wgmma", "128x128"): (128, 128, 64, 0),
    ("wgmma", "64x128"): (64, 128, 64, 1),
    ("simt", "128x128"): (128, 128, 16, 0),
    ("simt", "16x128"): (16, 128, 32, 1),
}
SMALL_M = 64  # M at or below this takes the small tile of its route
MIN_KCHUNK = 256  # split K no finer than this
BLOCKS_PER_SM = 2  # split K until the grid has this many blocks per SM
TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and row strides


class Plan(NamedTuple):
    route: str  # "wgmma" or "simt"
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
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, p: Plan, stream: int) -> None:
    """One call of the kernel of plan ``p`` into ``out`` on ``stream``.

    a (M, K) and b (K, N) in one dtype, out (M, N): contiguous, float32 or
    bfloat16, one device, as ``ops.matmul`` checks.
    """
    (m, k), n = a.shape, b.shape[1]
    ws = (torch.empty((p.splits, m, n), dtype=torch.float32, device=a.device)
          if p.splits > 1 else None)
    lib = _lib()
    err = lib.repro_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        m, n, k, p.splits, ROUTES[p.route], TILES[p.route, p.tile][3], DTYPE_CODES[a.dtype],
        DTYPE_CODES[out.dtype], a.device.index or 0, stream)
    if err:
        raise RuntimeError(f"matmul kernel launch failed ({p.route} {p.tile}, "
                           f"{p.splits} splits): " + lib.repro_cuda_error_string(err).decode())
