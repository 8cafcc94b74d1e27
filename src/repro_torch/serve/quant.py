"""int8 weight-only quantization for serving: the paper's 8-bit mode on
the LM side.

The counterpart of ``repro/serve/quant.py``: each floating-point weight of
two or more axes becomes symmetric int8 with fp32 scales, one scale per
output column (the amax reduces over every axis but the last, so a stacked
(L, K, N) leaf has one scale per column across all L layers, as in the
reference); ``round`` is half to even in both packages. Norm scales, biases
and other 1-D or integer leaves stay as they are. Storage is 1 byte a
weight; ``dequantize_params`` rebuilds a compute-dtype view that serves
through the existing kernels (an int8-weight route in the matmul kernel
is not written yet). The tree walker takes dicts and lists (xLSTM's blocks).
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, map_tree


def _quantize_leaf(w: torch.Tensor):
    if w.dim() < 2 or not w.is_floating_point():
        return w  # norms, biases, scalars: keep full precision
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=tuple(range(w.dim() - 1)), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return {"__q8__": q.to(torch.int8), "scale": scale}


def _is_q(node) -> bool:
    return isinstance(node, dict) and "__q8__" in node


def quantize_params(params):
    """fp32/bf16 param tree -> int8 (+ fp32 scale) tree, the storage form."""
    return map_tree(_quantize_leaf, params)


def dequantize_params(qparams, dtype=torch.bfloat16):
    """A ``dtype`` view of a quantized tree: q * scale in fp32, cast."""
    def deq(node):
        if _is_q(node):
            return (node["__q8__"].float() * node["scale"]).to(dtype)
        return node

    return map_tree(deq, qparams, is_leaf=_is_q)


def storage_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))
