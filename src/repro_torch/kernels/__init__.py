"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record a call of kernel ``name``: the kernels
    return tensors with no ``grad_fn``, so every weight upstream of one would
    silently get no gradient. Training takes the plain route
    (``use_kernel=False``; ``models.api.loss_fn`` does)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward, and an input requires grad; "
                           f"train with use_kernel=False (models.api.loss_fn does), or call "
                           f"it under torch.no_grad()")


def refuse_dtensor(name: str, *tensors: torch.Tensor) -> None:
    """Raise on a DTensor: its ``data_ptr()`` is 0, so a ctypes launch would
    read a null pointer. A DTensor reaches a kernel as its local shard,
    through the wrapper's registered op (``matmul_on_shards``,
    ``rmsnorm_on_shards``, ``flash_attention_on_shards``, ``ssd_on_shards``)."""
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name} takes plain tensors, and got a DTensor: a sharded tensor "
                        f"reaches the kernel as its local shard, through {name}_on_shards "
                        f"where there is one")


def is_fake(*tensors: torch.Tensor) -> bool:
    """Whether any of ``tensors`` is a fake tensor (a shape, a dtype and a
    device, no storage: the dry run's). No kernel runs on one: a wrapper
    hands it to its registered op, whose fake implementation gives the
    output's shape and launches nothing, and whose FLOP formula the dry
    run's counter reads."""
    return any(isinstance(t, FakeTensor) for t in tensors)


SCRATCH_ALIGN = 256  # bytes between the parts of a kernel's scratch (TMA needs 16)


def scratch(sizes, device) -> tuple:
    """One uninitialised byte buffer holding parts of ``sizes`` bytes, each
    SCRATCH_ALIGN-aligned, and the parts' byte offsets (None for a part of
    size 0): a kernel's re-laid-out operands and split-K workspace, one
    allocation a call."""
    offsets, end = [], 0
    for size in sizes:
        offsets.append(end if size else None)
        end += -(-size // SCRATCH_ALIGN) * SCRATCH_ALIGN
    return torch.empty(end, dtype=torch.uint8, device=device), offsets
