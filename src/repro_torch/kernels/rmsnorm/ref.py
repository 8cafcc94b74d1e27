"""Plain PyTorch RMSNorm, the oracle of the CUDA kernel.

It is the model's own ``rms_norm`` (``repro_torch.models.layers.rms_norm``
calls it), as ``repro/kernels/rmsnorm/ref.py`` is ``layers.rms_norm``:
``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, cast back to x's dtype.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., D); scale (D,) -> (..., D) in x's dtype."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.float()).to(x.dtype)
