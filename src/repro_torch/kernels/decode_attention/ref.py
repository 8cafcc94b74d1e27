"""Plain PyTorch decode attention on a cache updated in place: the oracle of
the CUDA kernels, and the route of CPU tensors.

``rope_append_ref`` rotates q and k with ``layers.apply_rope``'s formula and
writes k and v into row ``write_pos[b]`` of the caches in place (a
position outside [0, S) writes nothing, as the one-hot blend of
``layers.gqa_decode_attention`` drops it); ``decode_attend_ref`` is that
function's masked softmax over the whole cache, op for op, so on a cache in
the compute dtype the two give the blend-and-read path's numbers.
"""
from __future__ import annotations

import math

import torch


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, N, hd) rotated by ang (B, hd/2), ``apply_rope``'s arithmetic."""
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope_append_ref(q, k, v, k_cache, v_cache, write_pos, rope_pos, freqs):
    """q (B, 1, H*hd), k, v (B, 1, KV*hd); caches (B, S, KV, hd), written in
    place; write_pos, rope_pos (B,); freqs (hd/2,) fp32, or None for no
    rotation. Returns q rotated, (B, 1, H*hd)."""
    b, s, kv, hd = k_cache.shape
    q, k, v = q.reshape(b, -1, hd), k.reshape(b, kv, hd), v.reshape(b, kv, hd)
    if freqs is not None:
        ang = rope_pos.float()[:, None] * freqs
        q, k = _rotate(q, ang), _rotate(k, ang)
    keep = ((write_pos >= 0) & (write_pos < s))[:, None, None]
    rows = (torch.arange(b, device=write_pos.device), write_pos.clamp(0, s - 1))
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache[rows] = torch.where(keep, new.to(cache.dtype), cache[rows])
    return q.reshape(b, 1, -1)


def decode_attend_ref(q, k_cache, v_cache, valid_upto):
    """q (B, 1, H*hd); caches (B, S, KV, hd); valid_upto (B,): positions t <=
    valid_upto[b] attend. fp32 scores and softmax, the probabilities cast
    to q's dtype before PV. Returns (B, 1, H*hd)."""
    b, s_slots, n_kv, hd = k_cache.shape
    cd = q.dtype
    qg = q.reshape(b, n_kv, -1, hd)
    dk, dv = torch.promote_types(cd, k_cache.dtype), torch.promote_types(cd, v_cache.dtype)
    scores = torch.einsum("bngh,btnh->bngt", qg.to(dk), k_cache.to(dk)).float()
    scores = scores * (1.0 / math.sqrt(hd))
    t = torch.arange(s_slots, device=q.device)[None, None, None, :]
    scores = scores.masked_fill(~(t <= valid_upto[:, None, None, None]), float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(cd)
    out = torch.einsum("bngt,btnh->bngh", probs.to(dv), v_cache.to(dv))
    return out.reshape(b, 1, -1)
