"""Checked entry point of the fused RMSNorm over the last axis.

The counterpart of ``repro/kernels/rmsnorm/ops.py::rmsnorm``: it takes the
model-native (..., D) activations. A CUDA tensor launches the CUDA kernel
(or raises) as ``rmsnorm.plan_for`` cuts the rows; a CPU tensor takes the
plain version ``rmsnorm_ref``. ``rmsnorm.launches`` counts kernel launches.
It raises when autograd would record the call (``refuse_grad``): the
kernel has no backward, and training takes the plain route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad
from .ref import rmsnorm_ref
from .rmsnorm import DTYPE_CODES, plan_for, rmsnorm_rows

_MAX_D = 232448 // 4  # one fp32 row in a block's shared memory (the shared route)
_MAX_ROWS = 2**31 - 1  # CUDA's limit on grid x (the shared route's one block a row)


def _check(x, scale) -> None:
    if not (isinstance(x, torch.Tensor) and isinstance(scale, torch.Tensor)):
        raise TypeError("rmsnorm takes two tensors")
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
    _check(x, scale)
    refuse_grad("rmsnorm", x, scale)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    out = torch.empty_like(x)
    d = x.shape[-1]
    rmsnorm_rows(x.view(-1, d), scale, out.view(-1, d), eps, plan_for(x, scale, out))
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
