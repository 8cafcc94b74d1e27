"""The tf32x3 routes' arithmetic in plain torch: the split of fp32 into two
TF32 halves and the three-product matmul, conv, flash attention and SSD
scan the CUDA kernels compute.

The matmul's, the conv's, the flash attention's and the SSD's fp32 routes
(``csrc/matmul.cu``, ``csrc/conv2d.cu``, ``csrc/flash_attention.cu``,
``csrc/ssd.cu``, ``include/hopper.cuh``) run on the tensor cores in TF32
(10 mantissa bits), whose one product misses fp32's tolerance. They split
each operand, x = hi + lo with hi = round_tf32(x) and lo = round_tf32(x -
hi), and sum lo_a hi_b + hi_a lo_b + hi_a hi_b into one fp32 accumulator
per k8 slice. The functions here repeat that arithmetic on the CPU, for the
tests; the main path never calls them.
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
    """a (..., M, K) @ b (..., K, N) in fp32, batch dims broadcast: per K slice
    of 8, the products lo_a hi_b, hi_a lo_b, hi_a hi_b added in that order to
    one sum (the last ``products`` of them)."""
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)][-products:]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    acc = torch.zeros((*batch, a.shape[-2], b.shape[-1]), dtype=torch.float32, device=a.device)
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


SSD_TILE = 64  # the SSD route's rows of a tile (chunk rows and output rows); P and N padded to 64
LOG2E = 1.4426950408889634


def ssd_tf32x3(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, chunk: int, *, products: int = 3) -> torch.Tensor:
    """x (B, S, H, P); dt (B, S, H); a_log (H,); b, c (B, S, N) -> (B, S, H, P),
    as the SSD kernel's tf32x3 route computes it (``ssd_chunked``'s function,
    chunks of q = min(chunk, S) rows).

    ``ssd_states``, per (batch, head), chunks 0 .. NC - 2 in order: dacum the
    fp64 cumulative sum of dt * a, the fp32 state scaled by exp(da_tot) and
    then, tile of 64 chunk rows by tile, given (x o w)^T B with w_j = dt_j
    exp(da_tot - dacum_j) (0 past the chunk) summed apart (three TF32
    products a k8 of rows) and added to it. ``ssd_outputs``, per (chunk,
    64-row tile i): y = exp(dacum_i) (C_i state^T) (chunk 0: 0), then for the
    column tiles j at or below the diagonal, S = C_i B_j^T and G = S
    exp(dacum_i - dacum_j) dt_j: below the diagonal tile as S u_i (w_j dt_j)
    about m, the column tile's last dacum; on it, the 8 x 8 blocks on the
    diagonal masked before the exponent (j > i, rows past the chunk) and
    those below them as S u_i (w_j dt_j) about the column group's last
    dacum; y += G x_j summed apart and added. Every
    product is three TF32 products a k8 of its depth into one fp32 sum per
    product (P, N, chunk rows); exp is exp2 of an fp64 difference of dacum
    rounded to fp32 and scaled by log2(e) (the kernel takes the difference
    of dacum's two fp32 halves, and walks u_i down a tile's groups by their
    decays: the same values to fp32's rounding). ``products=1`` keeps hi hi
    alone."""
    tile = SSD_TILE
    bsz, s, h, p = x.shape
    q = min(chunk, s)
    nc, nt = s // q, -(-q // tile)
    a = -torch.exp(a_log.float())
    # rows past S read as zeros (TMA's fill)
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, tile)).transpose(1, 2)  # (B, H, S + 64, P)
    bf = F.pad(b.float(), (0, 0, 0, tile))[:, None]  # (B, 1, S + 64, N)
    cf = F.pad(c.float(), (0, 0, 0, tile))[:, None]
    dtf = dt.float()

    def scan(ci, rows):  # dt and dacum of rows [0, rows) of chunk ci: (B, H, rows)
        d = dtf[:, ci * q:ci * q + rows].transpose(1, 2)
        return d, torch.cumsum(d.double() * a.double()[None, :, None], -1)

    def ex(t):  # exp of an fp64 difference of dacum, as the kernel takes it
        return torch.exp2(t.float() * LOG2E)

    def prod(u, v):  # u (..., M, K) @ v (..., K, N), fp32-accurate
        return _products(u, v, products)

    states, acc = [], torch.zeros((bsz, h, p, b.shape[-1]), device=x.device)
    for ci in range(nc - 1):
        d, dac = scan(ci, q)
        tot = dac[..., -1:]
        w = d * ex(tot - dac)
        acc = acc * ex(tot)[..., None]
        for t in range(nt):
            r0, j = ci * q + t * tile, t * tile + torch.arange(tile, device=x.device)
            wt = torch.where(j < q, w[..., j.clamp(max=q - 1)], 0.0)  # (B, H, 64)
            xw = xf[:, :, r0:r0 + tile] * wt[..., None]  # (B, H, 64 rows, P)
            acc = acc + prod(xw.transpose(-1, -2), bf[:, :, r0:r0 + tile])
        states.append(acc)

    y = torch.full((bsz, h, s, p), float("nan"), device=x.device)
    for ci in range(nc):
        for it in range(nt):
            i0 = it * tile
            rows = min(i0 + tile, q)
            d, dac = scan(ci, rows)
            ri = i0 + torch.arange(tile, device=x.device)
            rv = ri < q
            dr = torch.where(rv, dac[..., ri.clamp(max=rows - 1)], 0.0)  # (B, H, 64)
            ct = cf[:, :, ci * q + i0:ci * q + i0 + tile]
            out = torch.zeros((bsz, h, tile, p), device=x.device)
            if ci > 0:
                out = prod(ct, states[ci - 1].transpose(-1, -2))
                out = out * torch.where(rv, ex(dr), 0.0)[..., None]
            for jt in range(it + 1):
                r0, col = ci * q + jt * tile, jt * tile + torch.arange(tile, device=x.device)
                sc = prod(ct, bf[:, :, r0:r0 + tile].transpose(-1, -2))  # (B, 1, 64, 64)
                if jt == it:  # the diagonal tile, by 8 x 8 blocks
                    ok = rv[:, None] & (col[None] <= ri[:, None])
                    cc = col.clamp(max=rows - 1)
                    expo = torch.where(ok, dr[..., None] - dac[..., None, cc], 0.0)
                    whole = sc * ex(expo) * d[..., None, cc]  # masked before the exponent
                    gi, gj = (ri - i0) // 8, (col - i0) // 8
                    m = dac[..., (i0 + 8 * gj + 7).clamp(max=rows - 1)]  # each group's last
                    below = rv[:, None] & (gi[:, None] > gj[None])
                    u = ex(torch.where(below, dr[..., None] - m[..., None, :], 0.0))
                    w8 = d[..., cc] * ex(m - dac[..., cc])
                    g = torch.where(gi[:, None] == gj[None], torch.where(ok, whole, 0.0),
                                    torch.where(below, sc * u * w8[..., None, :], 0.0))
                else:  # below it: u_i w_j about m, the column tile's last dacum
                    m = dac[..., jt * tile + tile - 1, None]
                    u = torch.where(rv, ex(dr - m), 0.0)
                    wj = d[..., col] * ex(m - dac[..., col])
                    g = sc * (u[..., :, None] * wj[..., None, :])
                out = out + prod(g, xf[:, :, r0:r0 + tile])
            y[:, :, ci * q + ri[rv]] = out[:, :, rv]
    return y.transpose(1, 2).to(x.dtype)
