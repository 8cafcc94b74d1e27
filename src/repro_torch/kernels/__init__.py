"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a call of kernel ``name``: the kernels
    return tensors with no ``grad_fn``, so every weight upstream of one would
    silently get no gradient. Training takes the plain route
    (``use_kernel=False``; ``models.api.loss_fn`` does)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward, and an input requires grad; "
                           f"train with use_kernel=False (models.api.loss_fn does), or call "
                           f"it under torch.no_grad()")
