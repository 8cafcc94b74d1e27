"""Checked entry point of the fused RMSNorm over the last axis.

The counterpart of ``repro/kernels/rmsnorm/ops.py::rmsnorm``: it takes the
model-native (..., D) activations. A CUDA tensor launches the CUDA kernel
(or raises) as ``rmsnorm.plan_for`` cuts the rows; a CPU tensor takes the
plain version ``rmsnorm_ref``. ``rmsnorm.launches`` counts kernel launches.
A fake tensor (the dry run's) takes the op's fake implementation
(``is_fake``): nothing launches, and the op's FLOP formula counts 0 (the
dry run counts products and convolutions only). It raises when autograd
would record the call (``refuse_grad``): the
kernel has no backward, and training takes the plain route. It raises on a
DTensor (``refuse_dtensor``): ``rmsnorm_on_shards`` takes DTensors, through
the op ``repro_torch::rmsnorm``, whose sharding strategies DTensor reads, so
that each rank's kernel runs on its local rows.
While a profiler records, a call is the span ``kernels.rmsnorm``
(``repro_torch.obs.hotpath``), from the checks through the launch.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import is_fake, refuse_dtensor, refuse_grad
from repro_torch.obs import hotpath
from .ref import rmsnorm_ref
from .rmsnorm import DTYPE_CODES, plan_for, rmsnorm_rows

_MAX_D = 232448 // 4  # one fp32 row in a block's shared memory (the shared route)
_MAX_ROWS = 2**31 - 1  # CUDA's limit on grid x (the shared route's one block a row)


def _check(x, scale) -> None:
    if not (isinstance(x, torch.Tensor) and isinstance(scale, torch.Tensor)):
        raise TypeError("rmsnorm takes two tensors")
    refuse_dtensor("rmsnorm", x, scale)
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm takes x (..., D) and scale (D,); "
                         f"got shapes {tuple(x.shape)} and {tuple(scale.shape)}")
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES:
        raise ValueError(f"rmsnorm takes float32 or bfloat16; got {x.dtype} and {scale.dtype}")
    if x.device != scale.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm takes x and scale on one CPU or CUDA device; "
                         f"got {x.device} and {scale.device}")
    if x.numel() == 0:
        raise ValueError("rmsnorm takes a non-empty x")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous tensors")
    if x.shape[-1] > _MAX_D or x.numel() // x.shape[-1] > _MAX_ROWS:
        raise ValueError(f"rmsnorm: shape {tuple(x.shape)} exceeds the kernel's limits")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D); scale (D,) -> (..., D) in x's dtype, fp32 arithmetic."""
    if hotpath.recording():
        with hotpath.span("kernels.rmsnorm"):
            return _rmsnorm(x, scale, eps)
    return _rmsnorm(x, scale, eps)


def _rmsnorm(x, scale, eps):
    _check(x, scale)
    refuse_grad("rmsnorm", x, scale)
    if is_fake(x, scale):
        return torch.ops.repro_torch.rmsnorm(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    out = torch.empty_like(x)
    d = x.shape[-1]
    rmsnorm_rows(x.view(-1, d), scale, out.view(-1, d), eps, plan_for(x, scale, out))
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm_op(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm(x, scale, eps=eps)


@_rmsnorm_op.register_fake
def _(x, scale, eps):
    return torch.empty_like(x)


@register_flop_formula(torch.ops.repro_torch.rmsnorm)
def _rmsnorm_flops(*args, out_shape=None, **kwargs) -> int:
    """0: no product, as the reference's ``exact_cost`` counts only dots and
    convolutions."""
    return 0


@register_sharding(torch.ops.repro_torch.rmsnorm.default)
def _rmsnorm_strategies(x, scale, eps):
    """Per mesh dim: rows split along any dim but the normalised one, the
    scale replicated; or all replicated."""
    return [([Shard(d)], [Shard(d), Replicate(), None]) for d in range(x.ndim - 1)] + \
        [([Replicate()], [Replicate(), Replicate(), None])]


def rmsnorm_on_shards(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """``rmsnorm`` of DTensors of one mesh: each rank's kernel on its local
    rows (one launch a rank, counted in ``rmsnorm.launches``)."""
    refuse_grad("rmsnorm", x, scale)
    return torch.ops.repro_torch.rmsnorm(x, scale, eps)
