"""Plain PyTorch direct convolution, the oracle of the CUDA kernel.

It repeats the arithmetic of the TPU kernel (``repro/kernels/conv2d``):
the R x S taps are summed in fp32, each tap a (K, C) x (C, H*W) product
over a shifted view of the zero-padded input, and the sum is cast back to
the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, C, H, W); w (K, C, R, S) -> (N, K, H, W), 'same' pad, stride 1."""
    n, c, h, wd = x.shape
    k, _, rr, ss = w.shape
    xp = F.pad(x.float(), ((ss - 1) // 2, ss // 2, (rr - 1) // 2, rr // 2))
    wf = w.float()
    acc = torch.zeros((n, k, h * wd), dtype=torch.float32, device=x.device)
    for r in range(rr):
        for s in range(ss):
            tap = xp[:, :, r:r + h, s:s + wd].reshape(n, c, h * wd)
            acc += torch.matmul(wf[:, :, r, s], tap)
    return acc.reshape(n, k, h, wd).to(x.dtype)
