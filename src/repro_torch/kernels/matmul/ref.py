"""Plain PyTorch matrix product, the oracle of the CUDA kernel.

As ``repro/kernels/matmul/ref.py``: the product of the two operands in
fp32, cast to ``out_dtype`` (by default the dtype of ``a``).
"""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """a (M, K) @ b (K, N) -> (M, N)."""
    return (a.float() @ b.float()).to(out_dtype or a.dtype)
