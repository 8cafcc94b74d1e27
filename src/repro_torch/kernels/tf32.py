"""The tf32x3 routes' arithmetic in plain torch: the split of fp32 into two
TF32 halves and the three-product matmul and conv the CUDA kernels compute.

The matmul's and the conv's fp32 routes (``csrc/matmul.cu``,
``csrc/conv2d.cu``, ``include/hopper.cuh``) run on the tensor cores in TF32
(10 mantissa bits), whose one product misses fp32's tolerance. They split
each operand, x = hi + lo with hi = round_tf32(x) and lo = round_tf32(x -
hi), and sum lo_a hi_b + hi_a lo_b + hi_a hi_b into one fp32 accumulator
per k8 slice. The functions here repeat that arithmetic on the CPU, for the
tests; the main path never calls them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LOW_BITS = 13  # fp32 mantissa bits a TF32 value leaves zero
K_SLICE = 8  # the K depth of one tf32 wgmma


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest multiple of 2^13 in the bit pattern's magnitude, ties away from
    zero, the low 13 bits zero. Infinities and NaN pass unchanged."""
    bits = x.float().contiguous().view(torch.int32)
    half, mask = 1 << (LOW_BITS - 1), -(1 << LOW_BITS)
    rounded = ((bits + half) & mask).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32, with x = hi + lo + e and |e| <= 2^-22 |x| where x
    and lo are normal (x - hi is exact in fp32)."""
    hi = round_tf32(x)
    return hi, round_tf32(x.float() - hi)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor, *, products: int = 3,
                  out_dtype=None) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the tf32x3 route sums it: per K slice of 8, the
    products lo_a hi_b, hi_a lo_b, hi_a hi_b added in that order to one fp32
    sum, cast to ``out_dtype or a.dtype``. ``products=1`` keeps hi_a hi_b
    alone: one plain TF32 product, the route this one replaces."""
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][-products:]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[1], K_SLICE):
        for p, q in terms:
            acc += p[:, k0:k0 + K_SLICE] @ q[k0:k0 + K_SLICE]
    return acc.to(out_dtype or a.dtype)


def conv2d_tf32x3(x: torch.Tensor, w: torch.Tensor, *, products: int = 3) -> torch.Tensor:
    """x (N, C, H, W); w (K, C, R, S) -> (N, K, H, W), 'same' pad, stride 1,
    as the tf32x3 route sums it: per tap, then per slice of 8 input
    channels, the products lo_x hi_w, hi_x lo_w, hi_x hi_w added in that
    order to one fp32 sum (the kernel's K steps: tap-major, channels within).
    ``products=1`` keeps hi_x hi_w alone."""
    n, c, h, wd = x.shape
    k, _, rr, ss = w.shape
    pad = ((ss - 1) // 2, ss // 2, (rr - 1) // 2, rr // 2)
    (x_hi, x_lo), (w_hi, w_lo) = split_tf32(x), split_tf32(w)
    terms = [(x_lo, w_hi), (x_hi, w_lo), (x_hi, w_hi)][-products:]
    terms = [(F.pad(p, pad), q) for p, q in terms]
    acc = torch.zeros((n, h * wd, k), dtype=torch.float32, device=x.device)
    for r in range(rr):
        for s in range(ss):
            for c0 in range(0, c, K_SLICE):
                for p, q in terms:
                    tap = p[:, c0:c0 + K_SLICE, r:r + h, s:s + wd].reshape(n, -1, h * wd)
                    acc += tap.transpose(1, 2) @ q[:, c0:c0 + K_SLICE, r, s].T
    return acc.transpose(1, 2).reshape(n, k, h, wd).to(x.dtype)
