"""int8 gradient compression with error feedback.

The counterpart of the part of ``repro/parallel/collectives.py`` that the
Trainer's ``grad_compression`` reaches: per-tensor symmetric int8
quantization, and ``compress_grads``, which returns the grads in their
dequantized form (so the optimizer path is unchanged) and the new error
feedback. ``compressed_psum`` and the rest of the module wait for the
distributed slice (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import torch

from repro_torch.tree import map_tree


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    amax = torch.max(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    return map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_grads(grads, err):
    """grads + err -> (quantized grads in dequantized form, new err)."""
    def one(g, e):
        acc = g.float() + e
        q, scale = quantize_int8(acc)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), acc - deq

    def pick(tree, i):  # the grads' trees are nested dicts; each leaf became a pair
        return {k: pick(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

    pairs = map_tree(one, grads, err)
    return pick(pairs, 0), pick(pairs, 1)
