"""Checked entry point of the tiled matrix product.

The counterpart of ``repro/kernels/matmul/ops.py::matmul``: a general
(M, K) @ (K, N) with an fp32 accumulator, cast to ``out_dtype or a.dtype``.
There is no padding to block multiples: the kernel checks bounds. A CUDA
tensor launches the CUDA kernel (or raises) on the route ``matmul.plan_for``
picks; a CPU tensor takes the plain version ``matmul_ref``.
``matmul.launches`` counts kernel launches, one per call, and
``matmul.launches_by_route`` splits them by route (``wgmma``, ``tf32x3``,
``stream``, ``simt``).
A fake tensor (the dry run's) takes the op's fake implementation
(``is_fake``): nothing launches, and the op's FLOP formula, 2·M·K·N,
counts it. It raises when autograd would record the call (``refuse_grad``): the
kernel has no backward, and training takes the plain route. It raises on a
DTensor (``refuse_dtensor``): ``matmul_on_shards`` takes DTensors, through
the op ``repro_torch::matmul``, whose sharding strategies DTensor reads, so
that each rank's kernel runs on its local shards.
While a profiler records, a call is the span ``kernels.matmul``
(``repro_torch.obs.hotpath``), from the checks through the launch.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import is_fake, refuse_dtensor, refuse_grad
from repro_torch.obs import hotpath
from .matmul import DTYPE_CODES, ROUTES, launch, plan_for
from .ref import matmul_ref

_MAX_M = 65535 * 128  # CUDA's limit on grid y, in 128-row tiles


def _check(a, b, out_dtype) -> None:
    if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
        raise TypeError("matmul takes two tensors")
    refuse_dtensor("matmul", a, b)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul takes a (M, K) and b (K, N); "
                         f"got shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: a has K = {a.shape[1]}, "
                         f"b has K = {b.shape[0]}")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise ValueError(f"matmul takes float32 or bfloat16, the same for a and b; "
                         f"got {a.dtype} and {b.dtype}")
    if out_dtype is not None and out_dtype not in DTYPE_CODES:
        raise ValueError(f"matmul writes float32 or bfloat16; got out_dtype={out_dtype}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul takes a and b on one CPU or CUDA device; "
                         f"got {a.device} and {b.device}")
    if a.numel() == 0 or b.numel() == 0:
        raise ValueError("matmul takes non-empty tensors")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("matmul takes contiguous tensors")
    if a.shape[0] > _MAX_M or max(a.shape[1], b.shape[1]) >= 2**31:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)} exceed the kernel's grid")


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N) in ``out_dtype or a.dtype``, fp32 sums."""
    if hotpath.recording():
        with hotpath.span("kernels.matmul"):
            return _matmul(a, b, out_dtype)
    return _matmul(a, b, out_dtype)


def _matmul(a, b, out_dtype):
    _check(a, b, out_dtype)
    refuse_grad("matmul", a, b)
    if is_fake(a, b):
        return torch.ops.repro_torch.matmul(a, b, out_dtype)
    if a.device.type == "cpu":
        return matmul_ref(a, b, out_dtype=out_dtype)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype or a.dtype, device=a.device)
    p = plan_for(a, b)
    launch(a, b, out, p, torch.cuda.current_stream(a.device).cuda_stream)
    matmul.launches += 1
    matmul.launches_by_route[p.route] += 1
    return out


matmul.launches = 0
matmul.launches_by_route = dict.fromkeys(ROUTES, 0)


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def _matmul_op(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype | None) -> torch.Tensor:
    return matmul(a, b, out_dtype=out_dtype)


@_matmul_op.register_fake
def _(a, b, out_dtype):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype or a.dtype)


@register_flop_formula(torch.ops.repro_torch.matmul)
def _matmul_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """2·M·K·N, as ``torch.utils.flop_counter`` counts ``aten.mm``."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


@register_sharding(torch.ops.repro_torch.matmul.default)
def _matmul_strategies(a, b, out_dtype):
    """Per mesh dim: a's rows -> out's rows; b's columns -> out's columns;
    a's columns with b's rows -> a partial sum; or all replicated."""
    return [([Shard(0)], [Shard(0), Replicate(), None]),
            ([Shard(1)], [Replicate(), Shard(1), None]),
            ([Partial()], [Shard(1), Shard(0), None]),
            ([Replicate()], [Replicate(), Replicate(), None])]


def matmul_on_shards(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``matmul`` of two DTensors of one mesh: DTensor moves them to the
    cheapest strategy of ``_matmul_strategies``, then each rank's kernel
    runs on its local shards (one launch a rank, counted in
    ``matmul.launches``)."""
    refuse_grad("matmul", a, b)
    return torch.ops.repro_torch.matmul(a, b, out_dtype)
