"""ctypes launcher of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

The CUDA counterpart of
``repro/kernels/flash_attention/flash_attention.py::flash_attention_bhsd``.
It reads q, k and v in the model's own (B, S, heads, hd) layout and maps
each query head to its KV head by index, so there is no transpose, no
head replication and no padding of S or hd.

``plan`` decides, in Python and cached, the route of a call: for what TMA
can read (hd % 8 == 0, hd <= 128, q, k and v at 16-byte-aligned
addresses), ``wgmma``, the TMA + tensor-core kernel, in bf16 and
``tf32x3``, the same products on fp32 split into TF32 halves, in fp32;
``simt``, the CUDA-core kernel, for the rest. A launch is then one ctypes
call; this module allocates the tf32x3 route's split K and V^T (one
buffer), ``ops`` checks the arguments and allocates the output.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build, scratch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1, "tf32x3": 2}
BQ = 128  # wgmma: query rows per block, two consumer warpgroups of 64 (csrc BQ)
BK = 64  # wgmma and tf32x3: keys per K/V tile (csrc BK)
MAX_WGMMA_HD = 128  # two bf16 atoms, four fp32 ones
TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and row strides


@functools.lru_cache(maxsize=64)
def plan(hd: int, dtype: torch.dtype, aligned: bool) -> str:
    """The route of attention of head dim ``hd`` in ``dtype``; ``aligned``: q,
    k and v start on a 16-byte boundary. Row strides (H*hd and KV*hd values)
    are multiples of 16 bytes in either dtype when hd % 8 == 0."""
    if not aligned or hd % 8 or hd > MAX_WGMMA_HD:
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


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
    lib.repro_flash_attention_tf32x3.argtypes = [vp] * 8 + [i] * 8 + [ctypes.c_float, i, vp]
    lib.repro_flash_attention_tf32x3.restype = i
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
    lib, dev = _lib(), q.device.index or 0
    mask = (int(causal), 0 if window is None else window, 1.0 / math.sqrt(hd))
    if route == "tf32x3":
        buf, offsets = _scratch(b, s_k, kv, hd, q.device)
        err = lib.repro_flash_attention_tf32x3(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(buf.data_ptr() + o for o in offsets), b, s, s_k, h, kv, hd, *mask, dev, stream)
    else:
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, s_k, h, kv, hd,
            *mask, DTYPE_CODES[q.dtype], ROUTES[route], dev, stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed ({route}): "
                           + lib.repro_cuda_error_string(err).decode())


def padded_keys(s_k: int) -> int:
    """Sk rounded up to whole key tiles: the row length of the tf32x3 route's
    split V^T."""
    return -(-s_k // BK) * BK


def _scratch(b: int, s_k: int, kv: int, hd: int, device) -> tuple:
    """One uninitialised byte buffer for the tf32x3 route's split K_hi, K_lo
    (B, Sk, KV, hd) and V^T_hi, V^T_lo (B, KV, hd, Skp), and the parts' byte
    offsets."""
    k_bytes, v_bytes = b * s_k * kv * hd * 4, b * kv * hd * padded_keys(s_k) * 4
    return scratch((k_bytes, k_bytes, v_bytes, v_bytes), device)
