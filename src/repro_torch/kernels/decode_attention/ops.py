"""Checked entry points of decode attention on a KV cache updated in place.

``rope_append`` takes the tick's q, k, v as the products give them (B, 1,
heads*hd), rotates q and k (RoPE, with a frequency table cached per (hd,
theta, device)) and writes k and v into row ``write_pos[b]`` of a layer's
cache (B, S, KV, hd) in place; it returns the rotated q. ``decode_attend``
attends q over each slot's positions ``t <= valid_upto[b]`` and returns
(B, 1, H*hd). A CUDA tensor launches the CUDA kernels (or raises); a CPU
tensor takes the plain versions in ``ref``. Neither syncs with the host, so
both can be captured in a CUDA graph. ``rope_append.launches`` and
``decode_attend.launches`` count kernel launches, one a call;
``decode_attend.launches_by_route`` splits them by route (``mma``, the
tensor cores, or ``simt``). Both raise when autograd would record the call
(``refuse_grad``), on a DTensor (``refuse_dtensor``) and on a fake
tensor (nothing is written through one); ``takes`` says
whether a cache is one the kernels take. They open no ``kernels.*`` span:
their caller's ``attn.cache_write`` / ``attn.cache_read`` spans hold their
launches.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import is_fake, refuse_dtensor, refuse_grad
from .decode_attention import (DTYPE_CODES, ROUTES, launch_decode_attend, launch_rope_append,
                               plan)
from .ref import decode_attend_ref, rope_append_ref

MAX_HD = 256     # csrc: head dims a multiple of 8 up to 256
MAX_GROUP = 16   # csrc G_MAX: query heads a KV head
MAX_BATCH = 65535  # CUDA's limit on grid y and z


def _within_limits(b: int, kv: int, hd: int, n_heads: int, dtype: torch.dtype, k_cache,
                   v_cache) -> bool:
    """The kernels' limits, which ``takes`` tests and ``_check`` enforces:
    float32 or bfloat16 caches of ``dtype``, contiguous, hd a multiple of 8
    up to 256, at most 16 query heads a KV head, a batch CUDA's grid holds."""
    return (dtype in DTYPE_CODES and k_cache.dtype == v_cache.dtype == dtype
            and k_cache.is_contiguous() and v_cache.is_contiguous()
            and hd % 8 == 0 and hd <= MAX_HD and n_heads % kv == 0
            and n_heads // kv <= MAX_GROUP and b <= MAX_BATCH)


def takes(k_cache, v_cache, dtype: torch.dtype, n_heads: int) -> bool:
    """Whether the kernels take a layer's caches (B, S, KV, hd), or a stack
    of them (L, B, S, KV, hd), under ``n_heads`` query heads computed in
    ``dtype``: plain tensors (no DTensor, no fake tensor) within the
    kernels' limits (``_within_limits``)."""
    if (type(k_cache) is not torch.Tensor or type(v_cache) is not torch.Tensor
            or k_cache.dim() not in (4, 5) or k_cache.shape != v_cache.shape):
        return False
    b, kv, hd = k_cache.shape[-4], k_cache.shape[-2], k_cache.shape[-1]
    return _within_limits(b, kv, hd, n_heads, dtype, k_cache, v_cache)


@functools.lru_cache(maxsize=16)
def rope_table(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE's frequencies 1 / theta^(2i / hd), ``layers.rope_freqs``' formula
    on ``device``, made once (outside inference mode, so any caller may read
    it)."""
    with torch.inference_mode(False):
        exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
        return 1.0 / (theta ** exps)


def _refuse_subclasses(name: str, *tensors) -> None:
    """Raise on a DTensor or a fake tensor. Plain tensors, what the decode
    step passes, leave after one type test each."""
    if all(type(t) is torch.Tensor for t in tensors):
        return
    refuse_dtensor(name, *tensors)
    if is_fake(*tensors):
        raise TypeError(f"{name} launches a kernel and takes no fake tensor")


def _check(name, q, k_cache, v_cache, index) -> None:
    shape = k_cache.shape
    if len(shape) != 4 or v_cache.shape != shape:
        raise ValueError(f"{name} takes caches (B, S, KV, hd); got shapes "
                         f"{tuple(shape)} and {tuple(v_cache.shape)}")
    b, _, kv, hd = shape
    q_shape = q.shape
    if (len(q_shape) != 3 or q_shape[0] != b or q_shape[1] != 1 or q_shape[2] % (kv * hd)
            or index.shape != (b,)):
        raise ValueError(f"{name} takes q (B, 1, H*hd) and positions (B,) beside caches "
                         f"{tuple(shape)}; got {tuple(q_shape)}, {tuple(index.shape)}")
    if index.dtype != torch.int64:
        raise ValueError(f"{name} takes int64 positions; got {index.dtype}")
    device = q.device
    if (k_cache.device != device or v_cache.device != device or index.device != device
            or device.type not in ("cpu", "cuda")):
        raise ValueError(f"{name} takes its tensors on one CPU or CUDA device")
    if not q.is_contiguous():
        raise ValueError(f"{name} takes a contiguous q")
    n_heads = q_shape[2] // hd
    if not _within_limits(b, kv, hd, n_heads, q.dtype, k_cache, v_cache):
        raise ValueError(
            f"{name}: q {q.dtype}, caches {k_cache.dtype} and {v_cache.dtype} (contiguous "
            f"{k_cache.is_contiguous()}, {v_cache.is_contiguous()}), head dim {hd}, "
            f"{n_heads} query heads on {kv} KV heads, batch {b}: outside the kernels' limits "
            f"(float32 or bfloat16, one for q and the caches; contiguous; hd a multiple of 8 "
            f"up to {MAX_HD}; at most {MAX_GROUP} query heads a KV head; batch up to "
            f"{MAX_BATCH})")


def rope_append(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, write_pos: torch.Tensor, rope_pos: torch.Tensor,
                theta: float | None) -> torch.Tensor:
    """q (B, 1, H*hd), k, v (B, 1, KV*hd); k_cache, v_cache (B, S, KV, hd),
    written in place at row write_pos[b] (a position outside [0, S) writes
    nothing); write_pos, rope_pos (B,) int64; theta: RoPE's base, or None
    for no rotation. Returns q rotated, (B, 1, H*hd), in q's dtype."""
    _refuse_subclasses("rope_append", q, k, v, k_cache, v_cache, write_pos, rope_pos)
    _check("rope_append", q, k_cache, v_cache, write_pos)
    b, _, kv, hd = k_cache.shape
    if k.shape != (b, 1, kv * hd) or v.shape != k.shape or rope_pos.shape != write_pos.shape:
        raise ValueError(f"rope_append takes k, v {(b, 1, kv * hd)} and rope_pos like "
                         f"write_pos; got {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(rope_pos.shape)}")
    device = q.device
    if not (k.dtype == v.dtype == q.dtype and rope_pos.dtype == torch.int64
            and k.device == device and v.device == device and rope_pos.device == device
            and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("rope_append takes k and v like q, rope_pos like write_pos")
    refuse_grad("rope_append", q, k, v, k_cache, v_cache)
    freqs = None if theta is None else rope_table(hd, theta, device)
    if device.type == "cpu":
        return rope_append_ref(q, k, v, k_cache, v_cache, write_pos, rope_pos, freqs)
    out = torch.empty_like(q)
    launch_rope_append(q, k, v, freqs, write_pos, rope_pos, out, k_cache, v_cache)
    rope_append.launches += 1
    return out


rope_append.launches = 0


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  valid_upto: torch.Tensor) -> torch.Tensor:
    """q (B, 1, H*hd); k_cache, v_cache (B, S, KV, hd); valid_upto (B,) int64:
    the positions t <= valid_upto[b] attend (a full ring passes S - 1).
    Returns (B, 1, H*hd) in q's dtype."""
    _refuse_subclasses("decode_attend", q, k_cache, v_cache, valid_upto)
    _check("decode_attend", q, k_cache, v_cache, valid_upto)
    refuse_grad("decode_attend", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attend_ref(q, k_cache, v_cache, valid_upto)
    b, s, kv, hd = k_cache.shape
    p = plan(b, s, kv, hd, q.dtype)
    out = torch.empty_like(q)
    launch_decode_attend(q, k_cache, v_cache, valid_upto, out, p)
    decode_attend.launches += 1
    decode_attend.launches_by_route[p.route] += 1
    return out


decode_attend.launches = 0
decode_attend.launches_by_route = dict.fromkeys(ROUTES, 0)
