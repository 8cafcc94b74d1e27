"""The tf32x3 routes' arithmetic in plain torch: the split of fp32 into two
TF32 halves and the three-product matmul, conv and flash attention the CUDA
kernels compute.

The matmul's, the conv's and the flash attention's fp32 routes
(``csrc/matmul.cu``, ``csrc/conv2d.cu``, ``csrc/flash_attention.cu``,
``include/hopper.cuh``) run on the tensor cores in TF32 (10 mantissa bits),
whose one product misses fp32's tolerance. They split each operand, x = hi
+ lo with hi = round_tf32(x) and lo = round_tf32(x - hi), and sum lo_a
hi_b + hi_a lo_b + hi_a hi_b into one fp32 accumulator per k8 slice. The
functions here repeat that arithmetic on the CPU, for the tests; the main
path never calls them.
"""
from __future__ import annotations

import math

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


def _products(a: torch.Tensor, b: torch.Tensor, products: int) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in fp32: per K slice of 8, the products
    lo_a hi_b, hi_a lo_b, hi_a hi_b added in that order to one sum (the last
    ``products`` of them)."""
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][-products:]
    acc = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, a.shape[-1], K_SLICE):
        for p, q in terms:
            acc += p[..., k0:k0 + K_SLICE] @ q[..., k0:k0 + K_SLICE, :]
    return acc


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor, *, products: int = 3,
                  out_dtype=None) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the tf32x3 route sums it: per K slice of 8, the
    products lo_a hi_b, hi_a lo_b, hi_a hi_b added in that order to one fp32
    sum, cast to ``out_dtype or a.dtype``. ``products=1`` keeps hi_a hi_b
    alone: one plain TF32 product, the route this one replaces."""
    return _products(a, b, products).to(out_dtype or a.dtype)


FLASH_BQ = FLASH_BK = 64  # the flash route's query rows a block and keys a tile


def flash_attention_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           causal: bool = True, window: int | None = None,
                           products: int = 3) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, Sk, KV, hd) -> (B, S, H, hd), as the flash
    kernel's tf32x3 route computes it: blocks of 64 query rows, aligned to
    the end of the key timeline (offset Sk - S); the keys the block sees in
    tiles of 64 from t_lo (floored to a tile); per tile S = Q K^T as three
    TF32 products per k8 of hd, scaled to log2 units and masked, the online
    softmax in fp32 with exp2, P split into TF32 halves and the tile's P V
    summed apart as three TF32 products per k8 of keys before it is added to
    the rescaled output; then 1 / max(l, 1e-30), so a row with no key gives
    0. ``products=1`` keeps hi hi alone: one plain TF32 product a k8."""
    b, s, h, hd = q.shape
    _, sk, kv, _ = k.shape
    scale_log2 = (1.0 / math.sqrt(hd)) * math.log2(math.e)
    shift = sk - s
    qf = q.float().transpose(1, 2)  # (B, H, S, hd)
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(h // kv, dim=1) for t in (k, v))
    out = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, FLASH_BQ):
        rows = torch.arange(q0, min(q0 + FLASH_BQ, s), device=q.device)
        pos = rows + shift
        w_lo, w_hi = q0 + shift, int(rows[-1]) + shift
        t_hi = min(sk, w_hi + 1) if causal else sk
        t_lo = max(0, w_lo - window + 1) // FLASH_BK * FLASH_BK if window else 0
        m = torch.full((b, h, len(rows)), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, len(rows), hd), device=q.device)
        for t0 in range(t_lo, t_hi, FLASH_BK):
            keys = torch.arange(t0, min(t0 + FLASH_BK, sk), device=q.device)
            sc = _products(qf[:, :, rows], kf[:, :, keys].transpose(-1, -2), products)
            sc = sc * scale_log2
            ok = torch.ones((len(rows), len(keys)), dtype=torch.bool, device=q.device)
            if causal:
                ok &= keys[None] <= pos[:, None]
            if window:
                ok &= keys[None] > pos[:, None] - window
            sc = sc.masked_fill(~ok, float("-inf"))
            mx = torch.maximum(m, sc.max(-1).values)
            mu = torch.where(mx == float("-inf"), 0.0, mx)
            alpha = torch.exp2(m - mu)
            m = mx
            p = torch.exp2(sc - mu[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + _products(p, vf[:, :, keys], products)
        out[:, :, rows] = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


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
