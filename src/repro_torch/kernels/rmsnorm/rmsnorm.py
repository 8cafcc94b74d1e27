"""ctypes launcher of the hand-written CUDA RMSNorm (``csrc/rmsnorm.cu``).

The CUDA counterpart of ``repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_rows``.
It takes the unpadded rows, so there is no padding to a row-tile multiple.

``plan`` decides, in Python and cached, how a row is cut: the
``registers`` route holds a row in registers as 16-byte vectors, ``vpt``
of them on each of ``tpr`` threads, ``rows`` rows a block; the ``shared``
route (rows wider than the registers hold) stages one row a block in
shared memory. ``ops.rmsnorm`` checks the arguments and allocates the
output; this module only plans and launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"registers": 0, "shared": 1}
VEC_BYTES = 16
MAX_VPT = 4          # 16-byte vectors a thread (csrc instantiates 1, 2, 4)
MAX_TPR = 512        # threads a row (csrc reg::MAX_THREADS)
BLOCK_THREADS = 256  # threads of a block of several rows


class Plan(NamedTuple):
    route: str
    vpt: int = 0   # vectors a thread
    tpr: int = 0   # threads a row
    rows: int = 1  # rows a block
    vec: bool = False  # 16-byte loads and stores (else scalar, bounds-checked)


@functools.lru_cache(maxsize=256)
def plan(d: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """How rows of ``d`` values of ``dtype`` are cut; ``aligned``: x, the
    output and the scale start on a 16-byte boundary."""
    v = VEC_BYTES * 8 // torch.finfo(dtype).bits  # values of a 16-byte vector
    nvec = -(-d // v)
    if nvec > MAX_TPR * MAX_VPT:
        return Plan("shared")
    if nvec <= 32 * MAX_VPT:  # up to one warp a row: a power of two of lanes
        tpr = 1 << max(0, (-(-nvec // MAX_VPT) - 1).bit_length())
    else:  # whole warps
        tpr = 32 * -(-nvec // (32 * MAX_VPT))
    vpt = -(-nvec // tpr)
    vpt = 4 if vpt == 3 else vpt
    return Plan("registers", vpt, tpr, max(1, BLOCK_THREADS // tpr), aligned and d % v == 0)


def plan_for(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor) -> Plan:
    """The plan of a norm over the rows of x (.., D) into out."""
    aligned = (x.data_ptr() | scale.data_ptr() | out.data_ptr()) % VEC_BYTES == 0
    return plan(x.shape[-1], x.dtype, aligned)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rmsnorm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rmsnorm.argtypes = [vp, vp, vp, ctypes.c_longlong, i, ctypes.c_float] + [i] * 8 + [vp]
    lib.repro_rmsnorm.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, eps: float,
                 p: Plan) -> None:
    """Launch ``p`` into ``out`` on the current stream of ``x``'s device.

    x and out (N, D) in one dtype, scale (D,): contiguous, float32 or
    bfloat16, one CUDA device, as ``ops.rmsnorm`` checks.
    """
    n, d = x.shape
    lib = _lib()
    err = lib.repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps,
        DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], ROUTES[p.route], p.vpt, p.tpr, p.rows,
        int(p.vec), x.device.index or 0, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed ({p.route}): "
                           + lib.repro_cuda_error_string(err).decode())
