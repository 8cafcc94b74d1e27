"""Plain PyTorch chunked SSD, the oracle of the CUDA kernel.

It is the model's own ``ssd_chunked`` (``repro_torch.models.ssm`` imports
it from here), as ``repro/kernels/ssd/ref.py`` is ``ssm.ssd_chunked``: the
Mamba2 chunked scan of Listing 1 with the reference's cast points: x·dt
is fp32 (x is promoted), C Bᵀ, every decay and the inter-chunk recurrence
are fp32, and y is cast back to x's dtype. C Bᵀ is taken from the widened
b and c: the reference's einsum names the input dtype, but compiled (as
the model always runs it) XLA drops that rounding and keeps the fp32
product, which is also what the Pallas kernel computes.
"""
from __future__ import annotations

import torch


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[i, j] = sum(a[j+1..i]) for j <= i, -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_log, b, c, chunk: int) -> torch.Tensor:
    """Chunked selective-state-space scan (Mamba2 Listing 1).

    x (B, S, H, P) input heads; dt (B, S, H) softplus'd timestep; a_log (H,)
    log of -A per head; b, c (B, S, N) input and output projections (one
    group). Returns y (B, S, H, P) in x's dtype.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    nc = s // q
    assert s % q == 0, f"seq {s} not divisible by chunk {q}"
    f32 = torch.float32

    a = -torch.exp(a_log.to(f32))                      # (H,) negative
    da = dt.to(f32) * a[None, None, :]                 # (B, S, H)

    xc = (x * dt[..., None]).reshape(bsz, nc, q, h, p)  # promoted as jnp promotes
    dac = da.reshape(bsz, nc, q, h)
    bc = b.reshape(bsz, nc, q, n)
    cc = c.reshape(bsz, nc, q, n)

    # intra-chunk (quadratic within a chunk)
    l = torch.exp(_segsum(dac.transpose(2, 3)))        # (B, NC, H, Q, Q)
    cb = torch.einsum("bzqn,bzkn->bzqk", cc.to(f32), bc.to(f32))  # (B, NC, Q, Q)
    y_intra = torch.einsum("bzqk,bzhqk,bzkhp->bzqhp", cb, l, xc.to(f32))

    # chunk states
    da_cum = torch.cumsum(dac, dim=2)                  # (B, NC, Q, H)
    da_total = da_cum[:, :, -1]                        # (B, NC, H)
    decay_out = torch.exp(da_total[:, :, None] - da_cum)
    states = torch.einsum("bzqn,bzqh,bzqhp->bzhpn", bc.to(f32), decay_out,
                          xc.to(f32))                  # (B, NC, H, P, N)

    # inter-chunk recurrence (linear scan over chunks)
    prev = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    prev_states = []
    for z in range(nc):
        prev_states.append(prev)
        prev = states[:, z] + torch.exp(da_total[:, z])[..., None, None] * prev
    prev_states = torch.stack(prev_states, dim=1)      # (B, NC, H, P, N)

    decay_in = torch.exp(da_cum)                       # (B, NC, Q, H)
    y_inter = torch.einsum("bzqn,bzqh,bzhpn->bzqhp", cc.to(f32), decay_in, prev_states)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype)


def ssd_ref(x, dt, a_log, b, c, chunk: int = 128) -> torch.Tensor:
    return ssd_chunked(x, dt, a_log, b, c, chunk)
