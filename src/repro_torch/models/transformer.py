"""Dense decoder-only LM (starcoder2, h2o-danube): prefill forward and
one-token decode against a KV cache.

The counterpart of ``repro/models/transformer.py``. Weights are the same
nested dict as the JAX tree, with the blocks stacked along a leading
(L, ...) axis, so carrying weights across is a leaf-by-leaf conversion
(``params_from_jax``); the layers run in a Python loop over that axis
(``jax.lax.scan`` in the reference; its ``remat`` and ``unroll`` are JAX
compile options with no counterpart).

With ``use_kernel=True`` every dense product (wq, wk, wv, wo, w_up,
w_gate, w_down and the LM head) goes through the matmul kernel, every
RMSNorm through the RMSNorm kernel, and prefill attention through the
flash-attention kernel. ``use_kernel=False`` takes their plain versions:
the oracle of tests and the smoke run.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import attn_fn as flash_attn_fn
from .layers import (dense_init, embed_init, gqa_attention, gqa_decode_attention,
                     init_attention, init_mlp, init_rmsnorm, linear, mlp, rms_norm)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "port on the CPU")
    return device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def layer(blocks, i: int):
    """The params of block ``i`` as views into the stacked (L, ...) leaves."""
    return _map(lambda t: t[i], blocks)


def init_block(generator: torch.Generator, cfg: ArchConfig, dtype=torch.float32, *,
               device="cpu"):
    return {
        "ln1": init_rmsnorm(cfg.d_model, dtype, device=device),
        "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                               dtype, device=device),
        "ln2": init_rmsnorm(cfg.d_model, dtype, device=device),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp, dtype, device=device),
    }


def init_lm(cfg: ArchConfig, *, generator: torch.Generator, device="cuda",
            dtype=torch.float32):
    """Random weights from ``generator``; the JAX initialisers' scales."""
    device = _device(device)
    if cfg.n_patches:
        raise NotImplementedError("the VLM projector is not ported yet "
                                  "(ROADMAP.md queue 1 item 4, VLM branch)")
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, dtype, device=device),
        "blocks": _stack([init_block(generator, cfg, dtype, device=device)
                          for _ in range(cfg.n_layers)]),
        "ln_f": init_rmsnorm(cfg.d_model, dtype, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab, dtype, device=device)
    return params


def params_from_jax(tree_np, *, device="cuda", dtype=None):
    """The JAX package's parameter tree (nested dicts of numpy arrays) as tensors.

    ``dtype=None`` keeps each array's dtype; JAX's bfloat16 arrays become
    ``torch.bfloat16``.
    """
    device = _device(device)

    def leaf(a):
        a = np.array(a)  # a writable copy: JAX hands out read-only buffers
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: exact through fp32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    return _map(leaf, tree_np)


def _head(params) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"].t()


def block_apply(x, bp, cfg: ArchConfig, attn_fn=None, *, use_kernel: bool = False):
    x = x + gqa_attention(rms_norm(x, bp["ln1"], use_kernel=use_kernel), bp["attn"],
                          cfg.n_heads, cfg.n_kv, rope=cfg.rope, rope_theta=cfg.rope_theta,
                          window=cfg.window, attn_fn=attn_fn, use_kernel=use_kernel)
    x = x + mlp(rms_norm(x, bp["ln2"], use_kernel=use_kernel), bp["mlp"], cfg.activation,
                use_kernel=use_kernel)
    return x


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, patch_embeds=None, *,
            compute_dtype=torch.bfloat16, use_kernel: bool = True) -> torch.Tensor:
    """tokens (B, S) integer -> logits (B, S, vocab) in fp32."""
    if patch_embeds is not None:
        raise NotImplementedError("patch embeddings (VLM) are not ported yet "
                                  "(ROADMAP.md queue 1 item 4, VLM branch)")
    x = params["embed"][tokens].to(compute_dtype)
    attn_fn = flash_attn_fn if use_kernel else None
    for i in range(cfg.n_layers):
        x = block_apply(x, layer(params["blocks"], i), cfg, attn_fn, use_kernel=use_kernel)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    return linear(x, _head(params), use_kernel).float()


# ---------------------------------------------------------------------------
# Decode (one new token against a KV cache)
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """KV cache (L, B, S_max, n_kv, hd). Sliding-window archs only need the
    window slots (ring buffer)."""
    device = _device(device)
    slots = min(s_max, cfg.window) if cfg.window else s_max
    shape = (cfg.n_layers, batch, slots, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(params, cfg: ArchConfig, cache, tokens: torch.Tensor, pos: torch.Tensor, *,
                compute_dtype=torch.bfloat16, use_kernel: bool = True):
    """tokens (B, 1) integer; pos (B,) integer -> (logits (B, vocab), new cache).

    For windowed attention the cache slot is pos % window (ring buffer) and
    RoPE still uses the absolute position. The cache passed in is not
    changed.
    """
    x = params["embed"][tokens].to(compute_dtype)
    slots = cache["k"].shape[2]
    if cfg.window:
        write_pos = pos % slots                # ring buffer
        valid = torch.clamp(pos, max=slots - 1)  # full ring => all slots live
    else:
        write_pos, valid = pos, pos

    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        bp = layer(params["blocks"], i)
        h = rms_norm(x, bp["ln1"], use_kernel=use_kernel)
        out, k_c, v_c = gqa_decode_attention(
            h, bp["attn"], cfg.n_heads, cfg.n_kv, cache["k"][i], cache["v"][i], write_pos,
            rope_pos=pos, valid_upto=valid, rope=cfg.rope, rope_theta=cfg.rope_theta,
            use_kernel=use_kernel)
        x = x + out
        x = x + mlp(rms_norm(x, bp["ln2"], use_kernel=use_kernel), bp["mlp"], cfg.activation,
                    use_kernel=use_kernel)
        k_new.append(k_c)
        v_new.append(v_c)
    x = rms_norm(x, params["ln_f"], use_kernel=use_kernel)
    logits = linear(x[:, 0], _head(params), use_kernel).float()
    return logits, {"k": torch.stack(k_new), "v": torch.stack(v_new)}
