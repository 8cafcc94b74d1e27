"""State-space blocks: Mamba2 (SSD).

The counterpart of the Mamba2 part of ``repro/models/ssm.py``, function for
function, with the same cast points: the projections run in the compute
dtype, the depthwise causal conv sums its shifted products in that dtype
in tap order, ``dt`` is the softplus in fp32 of the product plus
``dt_bias``, ``x * dt`` and the scan are fp32, and the scan returns x's
dtype. The chunked scan itself (``_segsum``, ``ssd_chunked``) lives in
``repro_torch.kernels.ssd.ref`` as the oracle of the SSD kernel. Decode is O(1) per token through the recurrent state
and runs ``ssd_decode`` in plain PyTorch, as the reference does.

``use_kernel=True`` routes the prefill scan through the SSD kernel, every
dense product through the matmul kernel and every RMSNorm through the
RMSNorm kernel; ``use_kernel=False`` takes their plain versions. The
xLSTM blocks (mLSTM, sLSTM) are not ported yet (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMCfg
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked
from .layers import _randn, dense_init, init_rmsnorm, linear, rms_norm, silu


def ssd_decode(state, x, dt, a_log, b, c):
    """One-step recurrent update. state (B, H, P, N); x (B, H, P); dt (B, H);
    b, c (B, N). Returns (y (B, H, P) in x's dtype, new fp32 state)."""
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    da = dt.to(f32) * a[None]                                   # (B, H)
    state = (torch.exp(da)[..., None, None] * state
             + torch.einsum("bhp,bn,bh->bhpn", x.to(f32), b.to(f32), dt.to(f32)))
    y = torch.einsum("bhpn,bn->bhp", state, c.to(f32))
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------


def init_mamba2(generator: torch.Generator, d_model: int, s: SSMCfg, dtype=torch.float32, *,
                device="cpu"):
    """Random weights from ``generator`` at the JAX initialisers' scales."""
    d_in = s.expansion * d_model
    n_h = d_in // s.head_dim
    return {
        "in_proj": dense_init(generator, d_model, 2 * d_in, dtype, device=device),  # z, x
        "bc_proj": dense_init(generator, d_model, 2 * s.state_dim, dtype, device=device),
        "dt_proj": dense_init(generator, d_model, n_h, dtype, device=device),
        "dt_bias": torch.zeros((n_h,), dtype=dtype, device=device),
        "a_log": torch.zeros((n_h,), dtype=dtype, device=device),        # A = -1
        "d_skip": torch.ones((n_h,), dtype=dtype, device=device),
        "conv_w": (_randn(generator, (s.conv_width, d_in), device) * 0.1).to(dtype),
        "out_proj": dense_init(generator, d_in, d_model, dtype, device=device),
        "norm": init_rmsnorm(d_in, dtype, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D), w (W, D) depthwise causal conv, summed in x's dtype in tap order."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s] * w[0][None, None]
    for i in range(1, width):
        out = out + pad[:, i:i + s] * w[i][None, None]
    return out


def mamba2_apply(x, p, s: SSMCfg, *, use_kernel: bool = False):
    """x (B, S, D) -> (B, S, D): one Mamba2 mixer over the whole sequence."""
    bsz, sl, _ = x.shape
    cd = x.dtype
    d_in = p["conv_w"].shape[1]
    n_h = p["a_log"].shape[0]

    zx = linear(x, p["in_proj"], use_kernel)
    z, xin = torch.split(zx, d_in, dim=-1)
    xin = silu(_causal_conv(xin, p["conv_w"].to(cd)))
    bc = linear(x, p["bc_proj"], use_kernel)
    b, c = (t.contiguous() for t in torch.split(bc, s.state_dim, dim=-1))
    dt = F.softplus(linear(x, p["dt_proj"], use_kernel).float() + p["dt_bias"].float())

    xh = xin.reshape(bsz, sl, n_h, s.head_dim)
    if use_kernel:
        y = ssd(xh, dt, p["a_log"], b, c, chunk=s.chunk)
    else:
        y = ssd_chunked(xh, dt, p["a_log"], b, c, s.chunk)
    y = y + xh * p["d_skip"].to(cd)[None, None, :, None]
    y = y.reshape(bsz, sl, d_in)
    y = rms_norm(y, p["norm"], use_kernel=use_kernel) * silu(z)
    return linear(y, p["out_proj"], use_kernel)


def mamba2_decode(x, p, s: SSMCfg, conv_state, ssm_state, *, use_kernel: bool = False):
    """x (B, 1, D); conv_state (B, W-1, d_in); ssm_state (B, H, P, N).

    Returns (out (B, 1, D), new conv state, new ssm state); the states
    passed in are not changed.
    """
    bsz = x.shape[0]
    cd = x.dtype
    n_h = p["a_log"].shape[0]
    d_in = p["conv_w"].shape[1]

    zx = linear(x, p["in_proj"], use_kernel)
    z, xin = torch.split(zx, d_in, dim=-1)                        # (B, 1, d_in)
    # causal conv with a rolling state
    w = p["conv_w"].to(cd)
    seq = torch.cat([conv_state, xin], dim=1)                     # (B, W, d_in)
    conv_out = torch.einsum("bwd,wd->bd", seq, w.to(seq.dtype))[:, None]
    new_conv = seq[:, 1:]
    xin = silu(conv_out)

    bc = linear(x, p["bc_proj"], use_kernel)
    b, c = torch.split(bc[:, 0], s.state_dim, dim=-1)             # (B, N)
    dt = F.softplus(linear(x, p["dt_proj"], use_kernel)[:, 0].float()
                    + p["dt_bias"].float())                       # (B, H)

    xh = xin[:, 0].reshape(bsz, n_h, s.head_dim)
    y, new_ssm = ssd_decode(ssm_state, xh, dt, p["a_log"], b, c)
    y = y + xh * p["d_skip"].to(cd)[None, :, None]
    y = y.reshape(bsz, 1, -1)
    y = rms_norm(y, p["norm"], use_kernel=use_kernel) * silu(z)
    return linear(y, p["out_proj"], use_kernel), new_conv, new_ssm
