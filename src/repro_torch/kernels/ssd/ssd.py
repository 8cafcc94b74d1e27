"""ctypes launcher of the hand-written CUDA SSD chunked scan (``csrc/ssd.cu``).

The CUDA counterpart of ``repro/kernels/ssd/ssd.py::ssd_scan``. It reads x,
dt, b and c in the model's own layouts, the B/C group of every head by
index, so there is no head replication and no transpose.

``plan`` decides, in Python and cached, the route of a call: for what TMA
can read (P and N multiples of 8 up to 64, a chunk of at most
``MAX_WGMMA_Q`` rows, x, b and c at 16-byte-aligned addresses), ``wgmma``,
the TMA + tensor-core kernels, in bf16 and ``tf32x3``, the same split of
two kernels on fp32 split into TF32 halves (three tensor-core products a
k8), in fp32; ``simt``, the CUDA-core kernel, for the rest. The
tensor-core routes take a scratch for the states entering chunks 1 .. NC -
1 (``state_scratch``: bf16 on wgmma, the fp32 TF32 halves on tf32x3);
``ops.ssd`` checks the arguments, takes ``a = -exp(a_log)`` and allocates
the output and the scratch; this module only plans and launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "wgmma": 1, "tf32x3": 2}
TILE = 64  # wgmma and tf32x3: rows of a tile; P and N padded to 64 (csrc TILE)
MAX_WGMMA_PN = 64
MAX_WGMMA_Q = 2048  # chunk rows whose dt and dacum a block keeps in shared memory (csrc MAX_Q)
TMA_ALIGN = 16  # bytes: TMA's rule for base addresses and row strides


@functools.lru_cache(maxsize=64)
def plan(p: int, n: int, q: int, dtype: torch.dtype, aligned: bool) -> str:
    """The route of a scan of head width ``p``, state width ``n`` and chunks of
    ``q`` rows in ``dtype``; ``aligned``: x, b and c start on a 16-byte
    boundary. Row strides (H*P and N values) are multiples of 16 bytes
    exactly when P % 8 == N % 8 == 0."""
    if (not aligned or p % 8 or n % 8 or p > MAX_WGMMA_PN or n > MAX_WGMMA_PN
            or q > MAX_WGMMA_Q):
        return "simt"
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def plan_for(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor, q: int) -> str:
    """The route of a scan over these tensors with chunks of ``q`` rows."""
    aligned = (x.data_ptr() | b.data_ptr() | c.data_ptr()) % TMA_ALIGN == 0
    return plan(x.shape[3], b.shape[2], q, x.dtype, aligned)


def state_scratch(x: torch.Tensor, q: int, route: str) -> torch.Tensor | None:
    """The states entering chunks 1 .. NC - 1 that ``route``'s first kernel
    writes for its second: on wgmma in bf16, (B, NC - 1, H, 64, 64); on
    tf32x3 as their TF32 halves in fp32, (2, B, NC - 1, H, 64, 64), hi then
    lo. None with one chunk, and on simt."""
    bsz, s, h, _ = x.shape
    if s // q < 2 or route == "simt":
        return None
    shape = (bsz, s // q - 1, h, TILE, TILE)
    if route == "tf32x3":
        return torch.empty((2, *shape), dtype=torch.float32, device=x.device)
    return torch.empty(shape, dtype=torch.bfloat16, device=x.device)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry points of a loaded build of ``csrc/ssd.cu``."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssd.argtypes = [vp] * 7 + [i] * 9 + [vp]
    lib.repro_ssd.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(_build.library("ssd"))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, out: torch.Tensor, q: int, route: str,
             states: torch.Tensor | None, lib: ctypes.CDLL | None = None) -> None:
    """Launch the kernels of ``route`` into ``out`` on the current stream of
    ``x``'s device.

    x and out (B, S, H, P), b and c (B, S, N) in one dtype (float32 or
    bfloat16); dt (B, S, H) and a (H,) float32; all contiguous on one CUDA
    device; q divides S, as ``ops.ssd`` checks; ``states`` from
    ``state_scratch`` for ``route``. ``lib``: another build of the source,
    through ``bind`` (``tools/ssd_tf32x3_knockout.py``); by default the
    checkout's own.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    lib = _lib() if lib is None else lib
    err = lib.repro_ssd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
        None if states is None else states.data_ptr(), bsz, s, h, p, n, q,
        DTYPE_CODES[x.dtype], ROUTES[route], x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd kernel launch failed ({route}): "
                           + lib.repro_cuda_error_string(err).decode())
