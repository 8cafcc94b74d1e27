"""ctypes launcher of the hand-written CUDA matrix product (``csrc/matmul.cu``).

The CUDA counterpart of ``repro/kernels/matmul/matmul.py::matmul_blocked``.
It takes the unpadded operands: the kernel checks bounds, so there is no
padding copy. When the source's plan cuts K into chunks (a product with
too few output tiles to fill the card), this module allocates the fp32
workspace of the partial sums; ``ops.matmul`` checks the arguments and
allocates the output.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("matmul")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_matmul_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.repro_matmul_plan.restype = i
    lib.repro_matmul.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    lib.repro_matmul.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, err: int) -> None:
    if err:
        raise RuntimeError("matmul kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())


def k_splits(m: int, n: int, k: int, device: torch.device) -> int:
    """How many K chunks the kernel cuts an (M, K) @ (K, N) product into."""
    lib = _lib()
    splits = ctypes.c_int(0)
    _raise(lib, lib.repro_matmul_plan(m, n, k, device.index, ctypes.byref(splits)))
    return splits.value


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> None:
    """Launch into ``out`` on the current stream of ``a``'s device.

    a (M, K) and b (K, N) in one dtype, out (M, N): contiguous, float32 or
    bfloat16, one CUDA device, as ``ops.matmul`` checks.
    """
    (m, k), n = a.shape, b.shape[1]
    splits = k_splits(m, n, k, a.device)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    lib = _lib()
    _raise(lib, lib.repro_matmul(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        m, n, k, splits, DTYPE_CODES[a.dtype], DTYPE_CODES[out.dtype], a.device.index,
        torch.cuda.current_stream(a.device).cuda_stream))
