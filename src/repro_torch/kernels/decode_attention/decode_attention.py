"""ctypes launcher of the hand-written CUDA decode attention
(``csrc/decode_attention.cu``).

It replaces no TPU kernel: decode attention is plain array code in the JAX
package (``repro/models/layers.py::gqa_decode_attention``). The two entry
points work on a layer's slice of the stacked KV cache, (B, S, KV, hd),
which ``rope_append`` updates in place.

``plan`` decides, in Python and cached, how ``decode_attend`` runs: its
route, ``mma`` (the products on the tensor cores, mma.sync; bf16 with hd %
16 == 0, hd <= 128) or ``simt`` (on the CUDA cores; the rest), and its
chunks of ``chunk`` positions, one block each per (KV head, slot), from S
and the number of blocks alone (never from the lengths, which stay on the
device). Where one chunk covers S each block writes its output; else the
blocks write partial sums to fp32 scratch that a second kernel of the same
call merges. ``ops`` checks the arguments and allocates the outputs; this
module plans, allocates the scratch and launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"simt": 0, "mma": 1}
MMA_TILE, MMA_MAX_HD = 64, 128  # csrc tc::TILE, tc::HD
SIMT_TILES = {torch.float32: 32, torch.bfloat16: 64}  # csrc Tile<T>
MAX_CHUNK_TILES = 4
MIN_BLOCKS = 264  # two blocks an SM of the H100's 132 before chunks get shorter


class Plan(NamedTuple):
    route: str
    chunk: int  # positions a block


@functools.lru_cache(maxsize=256)
def plan(b: int, s_slots: int, kv: int, hd: int, dtype: torch.dtype) -> Plan:
    """The route the dtype and head dim allow; chunks of up to
    MAX_CHUNK_TILES tiles, shortened (down to one tile) while the grid would
    hold fewer than MIN_BLOCKS blocks."""
    mma = dtype == torch.bfloat16 and hd % 16 == 0 and hd <= MMA_MAX_HD
    tile = MMA_TILE if mma else SIMT_TILES[dtype]
    chunk = tile * MAX_CHUNK_TILES
    while chunk > tile and b * kv * -(-s_slots // chunk) < MIN_BLOCKS:
        chunk //= 2
    return Plan("mma" if mma else "simt", chunk)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("decode_attention")
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_rope_append.argtypes = [vp] * 9 + [i] * 4 + [ll, i, i, vp]
    lib.repro_rope_append.restype = i
    lib.repro_decode_attend.argtypes = [vp] * 6 + [i] * 4 + [ll, i, i, ctypes.c_float, i, i,
                                                             vp]
    lib.repro_decode_attend.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise(err: int, name: str) -> None:
    raise RuntimeError(f"{name} kernel launch failed: "
                       + _lib().repro_cuda_error_string(err).decode())


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index``, as an integer handle
    (``torch.cuda.current_stream`` builds a Stream object: ~4 us a call)."""
    return torch._C._cuda_getCurrentRawStream(index)


def launch_rope_append(q, k, v, freqs, write_pos, rope_pos, q_out, k_cache, v_cache) -> None:
    """One ``rope_append`` on the current stream: q, q_out (B, 1, H*hd), k, v
    (B, 1, KV*hd), caches (B, S, KV, hd), one dtype; freqs (hd/2,) fp32 or
    None; write_pos, rope_pos (B,) int64; all on one CUDA device, as
    ``ops.rope_append`` checks."""
    b, s, kv, hd = k_cache.shape
    index = q.get_device()
    err = _lib().repro_rope_append(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if freqs is None else freqs.data_ptr(),
        write_pos.data_ptr(), rope_pos.data_ptr(), q_out.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), b, q.shape[2] // hd, kv, hd, s, DTYPE_CODES[q.dtype], index,
        _raw_stream(index))
    if err:
        _raise(err, "rope_append")


def launch_decode_attend(q, k_cache, v_cache, valid_upto, out, p: Plan) -> None:
    """One ``decode_attend`` of plan ``p`` on the current stream: q, out (B, 1,
    H*hd), caches (B, S, KV, hd), one dtype, 16-byte aligned; valid_upto
    (B,) int64, as ``ops.decode_attend`` checks."""
    b, s, kv, hd = k_cache.shape
    h = q.shape[2] // hd
    index = q.get_device()
    part = None
    if s > p.chunk:
        part = torch.empty(b * -(-s // p.chunk) * h * (hd + 2), dtype=torch.float32,
                           device=q.device)
    err = _lib().repro_decode_attend(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), valid_upto.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(), b, h, kv, hd, s,
        ROUTES[p.route], p.chunk, hd ** -0.5, DTYPE_CODES[q.dtype], index, _raw_stream(index))
    if err:
        _raise(err, "decode_attend")
