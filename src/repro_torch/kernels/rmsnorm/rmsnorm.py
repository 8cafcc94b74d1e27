"""ctypes launcher of the hand-written CUDA RMSNorm (``csrc/rmsnorm.cu``).

The CUDA counterpart of ``repro/kernels/rmsnorm/rmsnorm.py::rmsnorm_rows``.
It takes the unpadded rows: one block per row, so there is no padding to a
row-tile multiple. ``ops.rmsnorm`` checks the arguments and allocates the
output; this module only launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rmsnorm")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_rmsnorm.argtypes = [vp, vp, vp, i, i, ctypes.c_float, i, i, i, vp]
    lib.repro_rmsnorm.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_rows(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor, eps: float) -> None:
    """Launch into ``out`` on the current stream of ``x``'s device.

    x and out (N, D) in one dtype, scale (D,): contiguous, float32 or
    bfloat16, one CUDA device, as ``ops.rmsnorm`` checks.
    """
    n, d = x.shape
    lib = _lib()
    err = lib.repro_rmsnorm(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d, eps,
        DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
