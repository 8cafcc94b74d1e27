"""ctypes launcher of the hand-written CUDA SSD chunked scan (``csrc/ssd.cu``).

The CUDA counterpart of ``repro/kernels/ssd/ssd.py::ssd_scan``. It reads x,
dt, b and c in the model's own layouts, the B/C group of every head by
index, so there is no head replication and no transpose; one block per
(batch, head) walks the chunks in order with the state in shared memory.
``ops.ssd`` checks the arguments, takes ``a = -exp(a_log)`` and allocates
the output; this module only launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
    lib.repro_ssd.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, out: torch.Tensor, q: int) -> None:
    """Launch into ``out`` on the current stream of ``x``'s device.

    x and out (B, S, H, P), b and c (B, S, N) in one dtype (float32 or
    bfloat16); dt (B, S, H) and a (H,) float32; all contiguous on one CUDA
    device; q divides S, as ``ops.ssd`` checks.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    lib = _lib()
    err = lib.repro_ssd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
        bsz, s, h, p, n, q, DTYPE_CODES[x.dtype], x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("ssd kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
