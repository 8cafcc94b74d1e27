"""ctypes launcher of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

The CUDA counterpart of
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd``.
It reads q, k and v in the model's own (B, S, heads, hd) layout and maps
each query head to its KV head by index, so there is no transpose, no
head replication and no padding of S or hd.

``plan`` decides, in Python and cached, the route of a call: ``wgmma``,
the TMA + tensor-core kernel, for bf16 that TMA can read (hd % 8 == 0, hd
<= 128, q, k and v at 16-byte-aligned addresses), and ``simt``, the
CUDA-core kernel, for fp32 and the rest. A launch is then one ctypes call;
``ops`` checks the arguments and allocates the output.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1}
BQ = 128  # wgmma: query rows per block, two consumer warpgroups of 64 (csrc BQ)
BK = 64  # wgmma: keys per K/V tile (csrc BK)
MAX_WGMMA_HD = 128  # two atoms
TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and row strides


@functools.lru_cache(maxsize=64)
def plan(hd: int, dtype: torch.dtype, aligned: bool) -> str:
    """The route of attention of head dim ``hd`` in ``dtype``; ``aligned``: q,
    k and v start on a 16-byte boundary. Row strides (H*hd and KV*hd values)
    are multiples of 16 bytes exactly when hd % 8 == 0."""
    if dtype != torch.bfloat16 or not aligned or hd % 8 or hd > MAX_WGMMA_HD:
        return "simt"
    return "wgmma"


def plan_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route of attention over these tensors."""
    aligned = (q.data_ptr() | k.data_ptr() | v.data_ptr()) % TMA_ALIGN == 0
    return plan(q.shape[3], q.dtype, aligned)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = [vp, vp, vp, vp] + [i] * 8 + [ctypes.c_float] + \
        [i] * 3 + [vp]
    lib.repro_flash_attention.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, route: str,
           stream: int, *, causal: bool, window: int | None) -> None:
    """One call of the kernel of ``route`` into ``out`` on ``stream``.

    q and out (B, S, H, hd), k and v (B, Sk, KV, hd): contiguous, one dtype
    (float32 or bfloat16), one CUDA device, as ``ops.flash_attention`` checks.
    """
    b, s, h, hd = q.shape
    _, s_k, kv, _ = k.shape
    lib = _lib()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s_k, h, kv, hd,
        int(causal), 0 if window is None else window, 1.0 / math.sqrt(hd),
        DTYPE_CODES[q.dtype], ROUTES[route], q.device.index or 0, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed ({route}): "
                           + lib.repro_cuda_error_string(err).decode())
