"""Plain PyTorch attention, the oracle of the CUDA kernel.

It mirrors ``repro/kernels/flash_attention/ref.py::attention_ref``: fp32
scores and softmax, the queries aligned to the end of the key timeline
(offset Sk - S) for the causal mask and the window, masked scores -inf.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  window: int | None = None) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, Sk, KV, hd) -> (B, S, H, hd). fp32 math."""
    b, s, h, hd = q.shape
    _, s_k, kv, _ = k.shape
    g = h // kv
    qg = q.float().reshape(b, s, kv, g, hd)
    scores = torch.einsum("bsngh,btnh->bngst", qg, k.float()) / math.sqrt(hd)
    qi = torch.arange(s, device=q.device)[:, None] + (s_k - s)
    kj = torch.arange(s_k, device=q.device)[None, :]
    ok = torch.ones((s, s_k), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kj <= qi
    if window is not None:
        ok &= kj > qi - window
    scores = scores.masked_fill(~ok, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)
