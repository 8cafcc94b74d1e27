"""Checked entry point of the SSD chunked-scan kernel.

The counterpart of ``repro/kernels/ssd/ops.py::ssd``, with the model-native
contract of ``ssd_chunked``: x (B, S, H, P), dt (B, S, H), a_log (H,), b, c
(B, S, N) -> y (B, S, H, P) in x's dtype, with chunks of
``q = min(chunk, S)`` rows, q dividing S. The decay terms the Pallas
wrapper precomputes (``dt * A`` and its cumulative sums, ``x * dt``) are
taken inside the kernel; only ``a = -exp(a_log)`` (H numbers) is taken
here. A CUDA tensor launches the CUDA kernels (or raises) on the route
``ssd.plan_for`` picks; a CPU tensor takes the plain version ``ssd_ref``.
``ssd.launches`` counts kernel launches, one per call (a tensor-core
route's two kernels are one ctypes call), and ``ssd.launches_by_route``
splits them by route (``wgmma``, ``tf32x3``, ``simt``).
A fake tensor (the dry run's) takes the op's fake implementation
(``is_fake``): nothing launches, and the op's FLOP formula counts the
products of the chunked scan as ``ssd_ref`` computes them. It raises when
autograd would record the call (``refuse_grad``): the kernel has no
backward, and training takes the plain route. It raises on a DTensor
(``refuse_dtensor``): ``ssd_on_shards`` takes DTensors, through the op
``repro_torch::ssd``, whose sharding strategies DTensor reads, so that each
rank's kernel runs on its local batch rows and heads.
While a profiler records, a call is the span ``kernels.ssd``
(``repro_torch.obs.hotpath``), from the checks through the launch.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import is_fake, refuse_dtensor, refuse_grad
from repro_torch.obs import hotpath
from .ref import ssd_ref
from .ssd import DTYPE_CODES, ROUTES, plan_for, ssd_scan, state_scratch

_MAX_PN = 64         # the kernel's widest head (P) and state (N), Zamba2's
# Chunk rows: at P = N = 64 a block needs 4 * (20736 + 2q) bytes of shared
# memory (``smem_floats`` in csrc/ssd.cu), and the H100 gives it 227 KB.
_MAX_Q = (227 * 1024 // 4 - 20736) // 2
_MAX_GRID_Y = 65535  # CUDA's limit on grid y (the batch)


def _check(x, dt, a_log, b, c, chunk) -> int:
    if not all(isinstance(t, torch.Tensor) for t in (x, dt, a_log, b, c)):
        raise TypeError("ssd takes five tensors")
    refuse_dtensor("ssd", x, dt, a_log, b, c)
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 or b.dim() != 3 or c.shape != b.shape:
        raise ValueError(f"ssd takes x (B, S, H, P), dt (B, S, H), a_log (H,) and b, c "
                         f"(B, S, N); got shapes {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(a_log.shape)}, {tuple(b.shape)}, {tuple(c.shape)}")
    bsz, s, h, p = x.shape
    if tuple(dt.shape) != (bsz, s, h) or a_log.shape[0] != h or tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, a_log "
                         f"{tuple(a_log.shape)} and b, c {tuple(b.shape)} differ in B, S or H")
    if x.dtype not in DTYPE_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd takes x, b and c in one of float32 or bfloat16; "
                         f"got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype not in DTYPE_CODES or a_log.dtype not in DTYPE_CODES:
        raise ValueError(f"ssd takes dt and a_log in float32 or bfloat16; "
                         f"got {dt.dtype} and {a_log.dtype}")
    if len({t.device for t in (x, dt, a_log, b, c)}) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError("ssd takes its tensors on one CPU or CUDA device")
    if x.numel() == 0 or b.numel() == 0:
        raise ValueError("ssd takes non-empty tensors")
    if not all(t.is_contiguous() for t in (x, dt, a_log, b, c)):
        raise ValueError("ssd takes contiguous tensors")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int; got {chunk!r}")
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    n = b.shape[-1]
    if p > _MAX_PN or n > _MAX_PN or q > _MAX_Q or bsz > _MAX_GRID_Y:
        raise ValueError(f"P {p}, N {n}, chunk {q} or batch {bsz} exceeds the kernel's "
                         f"limits (P, N <= {_MAX_PN}, chunk <= {_MAX_Q}, "
                         f"batch <= {_MAX_GRID_Y})")
    return q


def ssd(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """x (B, S, H, P); dt (B, S, H); a_log (H,); b, c (B, S, N) -> (B, S, H, P)."""
    if hotpath.recording():
        with hotpath.span("kernels.ssd"):
            return _ssd(x, dt, a_log, b, c, chunk)
    return _ssd(x, dt, a_log, b, c, chunk)


def _ssd(x, dt, a_log, b, c, chunk):
    q = _check(x, dt, a_log, b, c, chunk)
    refuse_grad("ssd", x, dt, a_log, b, c)
    if is_fake(x, dt, a_log, b, c):
        return torch.ops.repro_torch.ssd(x, dt, a_log, b, c, chunk)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a_log, b, c, chunk)
    a = -torch.exp(a_log.float())
    out = torch.empty_like(x)
    route = plan_for(x, b, c, q)
    states = state_scratch(x, q, route)
    ssd_scan(x, dt.float(), a, b, c, out, q, route, states)
    ssd.launches += 1
    ssd.launches_by_route[route] += 1
    return out


ssd.launches = 0
ssd.launches_by_route = dict.fromkeys(ROUTES, 0)


@torch.library.custom_op("repro_torch::ssd", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, chunk: int) -> torch.Tensor:
    # a shard split along the heads is a strided view of its rows; the output
    # is contiguous, as the fake implementation says (the plain version's need not be)
    return ssd(*(t.contiguous() for t in (x, dt, a_log, b, c)), chunk=chunk).contiguous()


@_ssd_op.register_fake
def _(x, dt, a_log, b, c, chunk):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def ssd_flops(x_shape, n: int, chunk: int) -> int:
    """The products of ``ssd_ref``'s chunked scan for x (B, S, H, P), states
    of width N and chunks of ``q = min(chunk, S)`` rows: C·Bᵀ (2·B·S·q·N),
    the intra-chunk (C·Bᵀ ∘ L)·x (2·B·S·q·H·P), the chunk states and the
    inter-chunk outputs (2·B·S·H·P·N each)."""
    bsz, s, h, p = x_shape
    q = min(chunk, s)
    return 2 * bsz * s * q * n + 2 * bsz * s * q * h * p + 4 * bsz * s * h * p * n


@register_flop_formula(torch.ops.repro_torch.ssd)
def _ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, *, out_shape=None,
               **kwargs) -> int:
    return ssd_flops(x_shape, b_shape[-1], chunk)


@register_sharding(torch.ops.repro_torch.ssd.default)
def _ssd_strategies(x, dt, a_log, b, c, chunk):
    """Per mesh dim: the batch split (x, dt, b, c alike, a_log replicated),
    or the heads (x and dt along H, a_log with them; b and c replicated,
    the one group every head reads); or all replicated."""
    return [([Shard(0)], [Shard(0), Shard(0), Replicate(), Shard(0), Shard(0), None]),
            ([Shard(2)], [Shard(2), Shard(2), Shard(0), Replicate(), Replicate(), None]),
            ([Replicate()], [Replicate()] * 5 + [None])]


def ssd_on_shards(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """``ssd`` of DTensors of one mesh: each rank's kernel on its local batch
    rows and heads (one launch a rank, counted in ``ssd.launches``)."""
    refuse_grad("ssd", x, dt, a_log, b, c)
    return torch.ops.repro_torch.ssd(x, dt, a_log, b, c, chunk)
