"""ctypes launcher of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

The CUDA counterpart of
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd``.
It reads q, k and v in the model's own (B, S, heads, hd) layout and maps
each query head to its KV head by index, so there is no transpose, no
head replication and no padding of S or hd. ``ops.flash_attention`` checks
the arguments and allocates the output; this module only launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                                          ctypes.c_float, i, i, vp]
    lib.repro_flash_attention.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                         *, causal: bool, window: int | None) -> None:
    """Launch into ``out`` on the current stream of ``q``'s device.

    q and out (B, S, H, hd), k and v (B, Sk, KV, hd): contiguous, one dtype
    (float32 or bfloat16), one CUDA device, as ``ops.flash_attention`` checks.
    """
    b, s, h, hd = q.shape
    _, s_k, kv, _ = k.shape
    lib = _lib()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s_k, h, kv, hd,
        int(causal), 0 if window is None else window, 1.0 / math.sqrt(hd),
        DTYPE_CODES[q.dtype], q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: "
                           + lib.repro_cuda_error_string(err).decode())
