"""State-space and recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM).

The counterpart of ``repro/models/ssm.py``, function for function.
Mamba2, with the same cast points: the projections run in the compute
dtype, the depthwise causal conv sums its shifted products in that dtype
in tap order, ``dt`` is the softplus in fp32 of the product plus
``dt_bias``, ``x * dt`` and the scan are fp32, and the scan returns x's
dtype. The chunked scan itself (``_segsum``, ``ssd_chunked``) lives in
``repro_torch.kernels.ssd.ref`` as the oracle of the SSD kernel. Decode
is O(1) per token through the recurrent state and runs ``ssd_decode`` in
plain PyTorch, as the reference does.

The xLSTM cells have no kernel in the reference: their gating, the
chunkwise mLSTM scan with its stabilisers and the sequential sLSTM run in
plain PyTorch with the reference's cast points (gates and scans in fp32,
the sLSTM's hidden state in the compute dtype).

``use_kernel=True`` routes the prefill scan through the SSD kernel, every
dense product (the xLSTM projections and the sLSTM's recurrent product at
every step included) through the matmul kernel and every RMSNorm through
the RMSNorm kernel; ``use_kernel=False`` takes their plain versions.

On a mesh (DTensor activations) the projections and norms run as in the
dense LM, and each scan runs on the local shards (``act.local_apply``),
split along the batch over the data axes and along the heads over
``model`` where they divide: the SSD through ``ssd_on_shards`` (the kernel)
or ``ssd_chunked`` on each shard, the mLSTM's chunkwise scan and decode
step, and the sLSTM's recurrence (its recurrent weight gathered whole,
since each step's product needs every column). The scans hold no
reduction across the batch or the heads, so the arithmetic is the one
card's.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import SSMCfg
from repro_torch.kernels.ssd.ops import ssd, ssd_on_shards
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.parallel.act import (batch_heads_spec, constrain, fitted_placements,
                                      local_apply, pinned)
from .layers import _randn, dense_init, init_rmsnorm, linear, rms_norm, silu, softplus, split_last


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
    """x (B, S, D), w (W, D) depthwise causal conv, summed in x's dtype in tap
    order; on a mesh, on each rank's batch rows and channels."""
    if isinstance(x, DTensor):
        px = fitted_placements(batch_heads_spec(x.device_mesh, 3, 2), x)
        pw = tuple(Shard(1) if p == Shard(2) else Replicate() for p in px)
        return local_apply(_causal_conv, (x, w), (px, pw), px)
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

    zx = constrain(linear(x, p["in_proj"], use_kernel), "ffn2")
    z, xin = torch.split(zx, d_in, dim=-1)
    xin = silu(_causal_conv(xin, p["conv_w"].to(cd)))
    bc = linear(x, p["bc_proj"], use_kernel)
    b, c = (t.contiguous() for t in torch.split(bc, s.state_dim, dim=-1))
    dt = softplus(linear(x, p["dt_proj"], use_kernel).float() + p["dt_bias"].float())

    xh = split_last(xin, n_h, s.head_dim)
    if isinstance(xh, DTensor):
        y = _ssd_on_mesh(xh, dt, p["a_log"], b, c, s.chunk, use_kernel)
    elif use_kernel:
        y = ssd(xh, dt, p["a_log"], b, c, chunk=s.chunk)
    else:
        y = ssd_chunked(xh, dt, p["a_log"], b, c, s.chunk)
    y = y + xh * p["d_skip"].to(cd)[None, None, :, None]
    y = pinned(y.reshape(bsz, sl, d_in))
    y = rms_norm(y, p["norm"], use_kernel=use_kernel) * silu(z)
    return linear(y, p["out_proj"], use_kernel)


def _ssd_on_mesh(x, dt, a_log, b, c, chunk: int, use_kernel: bool):
    """The scan of DTensors, each rank's on its batch rows and heads: the
    kernel through ``ssd_on_shards`` (its inputs placed first, so DTensor
    takes that strategy), or ``ssd_chunked`` on the local shards."""
    mesh = x.device_mesh
    px = fitted_placements(batch_heads_spec(mesh, 4, 2), x)
    pdt = fitted_placements(batch_heads_spec(mesh, 3, 2), dt)
    pa = tuple(Shard(0) if p == Shard(2) else Replicate() for p in px)
    pbc = fitted_placements(batch_heads_spec(mesh, 3), b)
    if use_kernel:
        args = [t.redistribute(mesh, pl) if isinstance(t, DTensor) else t
                for t, pl in zip((x, dt, a_log, b, c), (px, pdt, pa, pbc, pbc))]
        return ssd_on_shards(*args, chunk=chunk)
    return local_apply(functools.partial(ssd_chunked, chunk=chunk), (x, dt, a_log, b, c),
                       (px, pdt, pa, pbc, pbc), px)


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
    dt = softplus(linear(x, p["dt_proj"], use_kernel)[:, 0].float()
                  + p["dt_bias"].float())                         # (B, H)

    xh = xin[:, 0].reshape(bsz, n_h, s.head_dim)
    y, new_ssm = ssd_decode(ssm_state, xh, dt, p["a_log"], b, c)
    y = y + xh * p["d_skip"].to(cd)[None, :, None]
    y = y.reshape(bsz, 1, -1)
    y = rms_norm(y, p["norm"], use_kernel=use_kernel) * silu(z)
    return linear(y, p["out_proj"], use_kernel), new_conv, new_ssm


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) + sLSTM (scalar memory)
# ---------------------------------------------------------------------------


def init_mlstm(generator: torch.Generator, d_model: int, n_heads: int, dtype=torch.float32, *,
               device="cpu"):
    """Random weights from ``generator`` at the JAX initialisers' scales."""
    def dense(n_out):
        return dense_init(generator, d_model, n_out, dtype, device=device)

    return {"wq": dense(d_model), "wk": dense(d_model), "wv": dense(d_model),
            "wi": dense(n_heads), "wf": dense(n_heads), "wo": dense(d_model),
            "norm": init_rmsnorm(d_model, dtype, device=device)}


def mlstm_apply(x, p, n_heads: int, chunk: int = 256, *, use_kernel: bool = False):
    """Chunkwise-parallel mLSTM: x (B, S, D) -> (B, S, D). Quadratic within a
    chunk, an O(1) state (C, n, m) across chunks, the exponential gates
    stabilised by the running maximum m as the reference does."""
    bsz, s, d = x.shape
    hd = d // n_heads
    q_len = min(chunk, s)
    if s % q_len:
        raise ValueError(f"seq {s} not divisible by chunk {q_len}")

    q = split_last(linear(x, p["wq"], use_kernel), n_heads, hd)
    k = split_last(linear(x, p["wk"], use_kernel), n_heads, hd) / math.sqrt(hd)
    v = split_last(linear(x, p["wv"], use_kernel), n_heads, hd)
    i_pre, f_pre = linear(x, p["wi"], use_kernel), linear(x, p["wf"], use_kernel)  # (B, S, H)
    scan = functools.partial(_mlstm_scan, q_len=q_len)
    if isinstance(q, DTensor):
        p4 = fitted_placements(batch_heads_spec(q.device_mesh, 4, 2), q)
        p3 = fitted_placements(batch_heads_spec(q.device_mesh, 3, 2), i_pre)
        y = local_apply(scan, (q, k, v, i_pre, f_pre), (p4, p4, p4, p3, p3), p4)
    else:
        y = scan(q, k, v, i_pre, f_pre)
    y = rms_norm(pinned(y.reshape(bsz, s, d)).to(x.dtype), p["norm"], use_kernel=use_kernel)
    return linear(y, p["wo"], use_kernel)


def _mlstm_scan(q, k, v, i_pre, f_pre, *, q_len: int):
    """The mLSTM's gating and chunkwise scan: q, k, v (B, S, H, hd); the gate
    pre-activations (B, S, H) -> y (B, S, H, hd) in fp32."""
    bsz, s, n_heads, hd = q.shape
    f32 = torch.float32
    nc = s // q_len
    i_g = i_pre.to(f32)
    logf = F.logsigmoid(f_pre.to(f32))

    def chunked(t):
        return t.reshape(bsz, nc, q_len, *t.shape[2:])

    qc, kc, vc = (chunked(t).to(f32) for t in (q, k, v))        # (B, NC, Q, H, hd)
    ic, fc = chunked(i_g), chunked(logf)                        # (B, NC, Q, H)
    cumf = torch.cumsum(fc, dim=2)
    g_total = cumf[:, :, -1]                                    # (B, NC, H)

    # intra-chunk decay D[t, j] = cumf_t - cumf_j + i_j (j <= t)
    dmat = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + ic[:, :, None, :, :]
    mask = torch.tril(torch.ones((q_len, q_len), dtype=torch.bool, device=q.device))
    dmat = dmat.masked_fill(~mask[None, None, :, :, None], float("-inf"))
    m_local = dmat.amax(dim=3)                                  # (B, NC, Q, H)
    # the chunk's contribution to the carried state: sum_j exp(G - F_j + i_j) k v
    s_decay = g_total[:, :, None, :] - cumf + ic                # (B, NC, Q, H)
    m_state_local = s_decay.amax(dim=2)                         # (B, NC, H)

    c_prev = torch.zeros((bsz, n_heads, hd, hd), dtype=f32, device=q.device)
    n_prev = torch.zeros((bsz, n_heads, hd), dtype=f32, device=q.device)
    m_prev = torch.full((bsz, n_heads), -1e30, dtype=f32, device=q.device)
    ys = []
    for z in range(nc):
        qz, kz, vz, cumfz = qc[:, z], kc[:, z], vc[:, z], cumf[:, z]
        # numerator / denominator stabilisers combine the inter and intra parts
        m_inter = cumfz + m_prev[:, None, :]                    # (B, Q, H)
        m_t = torch.maximum(m_local[:, z], m_inter)
        w_inter = torch.exp(m_inter - m_t)
        num_i = torch.einsum("bqnh,bnhp->bqnp", qz, c_prev) * w_inter[..., None]
        den_i = torch.einsum("bqnh,bnh->bqn", qz, n_prev) * w_inter
        wd = torch.exp(dmat[:, z] - m_t[:, :, None, :])         # (B, Q, Q, H)
        sc = torch.einsum("bqnh,bjnh->bqjn", qz, kz) * wd
        num = num_i + torch.einsum("bqjn,bjnp->bqnp", sc, vz)
        den = torch.maximum(torch.abs(den_i + sc.sum(2)), torch.exp(-m_t))
        ys.append(num / den[..., None])                         # (B, Q, H, hd)
        # the state update
        gz = g_total[:, z]
        m_next = torch.maximum(gz + m_prev, m_state_local[:, z])
        w_keep = torch.exp(gz + m_prev - m_next)
        w_new = torch.exp(s_decay[:, z] - m_next[:, None, :])   # (B, Q, H)
        c_prev = (w_keep[..., None, None] * c_prev
                  + torch.einsum("bqnh,bqnp,bqn->bnhp", kz, vz, w_new))
        n_prev = w_keep[..., None] * n_prev + torch.einsum("bqnh,bqn->bnh", kz, w_new)
        m_prev = m_next
    return torch.stack(ys, dim=1).reshape(bsz, s, n_heads, hd)


def mlstm_decode(x, p, n_heads: int, c_state, n_state, m_state, *, use_kernel: bool = False):
    """Recurrent mLSTM step: x (B, 1, D); c (B, H, hd, hd), n (B, H, hd), m (B, H).
    Returns (out (B, 1, D), c, n, m); the states passed in are not changed."""
    bsz, _, d = x.shape
    hd = d // n_heads
    q = split_last(linear(x, p["wq"], use_kernel)[:, 0], n_heads, hd)
    k = split_last(linear(x, p["wk"], use_kernel)[:, 0], n_heads, hd) / math.sqrt(hd)
    v = split_last(linear(x, p["wv"], use_kernel)[:, 0], n_heads, hd)
    i_pre = linear(x, p["wi"], use_kernel)[:, 0]
    f_pre = linear(x, p["wf"], use_kernel)[:, 0]                 # (B, H)
    args = (q, k, v, i_pre, f_pre, c_state, n_state, m_state)
    if isinstance(q, DTensor):  # each rank's batch rows, as the cache is placed
        pls = tuple(fitted_placements(batch_heads_spec(q.device_mesh, a.ndim), a) for a in args)
        y, c_new, n_new, m_new = local_apply(_mlstm_step, args, pls, pls[:1] + pls[5:])
    else:
        y, c_new, n_new, m_new = _mlstm_step(*args)
    y = rms_norm(pinned(y.to(x.dtype).reshape(bsz, 1, d)), p["norm"], use_kernel=use_kernel)
    return linear(y, p["wo"], use_kernel), c_new, n_new, m_new


def _mlstm_step(q, k, v, i_pre, f_pre, c_state, n_state, m_state):
    """One recurrent mLSTM update -> (y (B, H, hd) fp32, c, n, m)."""
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    i_g = i_pre.to(f32)
    logf = F.logsigmoid(f_pre.to(f32))
    m_new = torch.maximum(logf + m_state, i_g)
    fs = torch.exp(logf + m_state - m_new)[..., None]
    is_ = torch.exp(i_g - m_new)[..., None]
    c_new = fs[..., None] * c_state + is_[..., None] * torch.einsum("bnh,bnp->bnhp", k, v)
    n_new = fs * n_state + is_ * k
    num = torch.einsum("bnh,bnhp->bnp", q, c_new)
    den = torch.maximum(torch.abs(torch.einsum("bnh,bnh->bn", q, n_new)),
                        torch.exp(-m_new))[..., None]
    return num / den, c_new, n_new, m_new


def init_slstm(generator: torch.Generator, d_model: int, n_heads: int, dtype=torch.float32, *,
               device="cpu"):
    """Random weights from ``generator`` at the JAX initialisers' scales."""
    return {"w_gates": dense_init(generator, d_model, 4 * d_model, dtype, device=device),
            "r_gates": dense_init(generator, d_model, 4 * d_model, dtype, device=device),
            "norm": init_rmsnorm(d_model, dtype, device=device)}


def slstm_apply(x, p, h0=None, c0=None, *, use_kernel: bool = False):
    """Sequential sLSTM: x (B, S, D) -> (y (B, S, D), h (B, D), c (B, D) fp32).

    The recurrent product ``h @ r_gates`` is one (B, D) @ (D, 4D) product a
    step: S launches of the matmul kernel under ``use_kernel``, as the
    reference's scan makes S products."""
    gates_x = linear(x, p["w_gates"], use_kernel)               # the input part, all steps
    scan = functools.partial(_slstm_scan, cd=x.dtype, use_kernel=use_kernel)
    if isinstance(gates_x, DTensor):
        mesh = gates_x.device_mesh
        rows = fitted_placements(batch_heads_spec(mesh, 3), gates_x)  # h and c split alike
        whole = (Replicate(),) * mesh.ndim
        y, h, c = local_apply(scan, (gates_x, p["r_gates"], h0, c0), (rows, whole, rows, rows),
                              (rows, rows, rows))
    else:
        y, h, c = scan(gates_x, p["r_gates"], h0, c0)
    return rms_norm(y, p["norm"], use_kernel=use_kernel), h, c


def _slstm_scan(gates_x, r_gates, h0, c0, *, cd, use_kernel: bool):
    """The sLSTM recurrence over gates_x (B, S, 4D), the input part of every
    step's gates -> (the hidden states (B, S, D) in ``cd``, h, c)."""
    bsz, s, d4 = gates_x.shape
    d = d4 // 4
    f32 = torch.float32
    h = torch.zeros((bsz, d), dtype=cd, device=gates_x.device) if h0 is None else h0.to(cd)
    c = torch.zeros((bsz, d), dtype=f32, device=gates_x.device) if c0 is None else c0
    ys = []
    for t in range(s):
        g = gates_x[:, t] + linear(h, r_gates, use_kernel)
        i, f, z, o = torch.split(g.to(f32), d, dim=-1)
        c = torch.sigmoid(f) * c + torch.exp(torch.clamp(i, max=0.0)) * torch.tanh(z)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(cd)
        ys.append(h)
    return torch.stack(ys, dim=1), h, c
