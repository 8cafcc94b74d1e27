"""ctypes launcher of the hand-written CUDA direct convolution (``csrc/conv2d.cu``).

The CUDA counterpart of ``repro/kernels/conv2d/conv2d.py::conv2d_windows``.
It takes the unpadded input: the kernel handles the "same" padding with
bounds checks, so there is no windowed copy. ``ops.conv2d`` checks the
arguments and allocates the output; this module only launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("conv2d")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_conv2d.argtypes = [vp, vp, vp, i, i, i, i, i, i, i, i, i, vp]
    lib.repro_conv2d.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def conv2d_direct(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    """Launch into ``out`` on the current stream of ``x``'s device.

    x (N, C, H, W), w (K, C, R, S) and out (N, K, H, W): contiguous, one
    dtype (float32 or bfloat16), one CUDA device, as ``ops.conv2d`` checks.
    """
    n, c, h, wd = x.shape
    k, _, r, s = w.shape
    lib = _lib()
    err = lib.repro_conv2d(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), n, c, h, wd, k, r, s,
        _DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("conv2d kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
